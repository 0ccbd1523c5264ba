"""Logical-axis activation sharding constraints (port of
``repro.dist.act_sharding``).

Model code never names mesh axes: it annotates activations with logical
axes, ``"dp"`` (the data-parallel axes, ``pod`` and ``data`` where
present) and ``"model"`` (the tensor-parallel axis), through ``constrain``
and the helpers ``batch_seq``, ``residual`` and ``heads``.
``use_mesh_rules`` binds a mesh for the duration of a block; outside it
every helper is the identity, so the same model code runs unsharded on one
device and sharded over a ``DeviceMesh``.

Specs keep JAX's form: one entry per tensor dim, each ``None``, an axis
name or a tuple of axis names (major to minor).  ``placements`` turns one
into DTensor placements, and ``constrain`` on a DTensor is a
``redistribute`` to them (``with_sharding_constraint`` in ``repro``); on a
plain tensor it is the identity.  The spec functions take any ordered
axis -> size mapping: a ``DeviceMesh`` or a plain dict such as
``{"data": 16, "model": 16}``, so that production meshes can be planned
without their ranks.

Divisibility is checked per dimension: a logical axis whose mesh size does
not divide the tensor dimension is dropped (the PACO planner's fallback:
never force an uneven cut).
"""
from __future__ import annotations

import contextlib
import types
from typing import Any, Mapping, Optional

import torch

# Logical-axis table: which mesh axes realize each logical name, major to
# minor.  "dp" spans every data-parallel axis present.
_DP_AXES = ("pod", "data")
_MODEL_AXIS = "model"

Spec = tuple
# Process-wide, not thread-local: autograd runs a CUDA backward (and the
# remat recompute inside it) on a thread of its own, which must see the
# mesh its forward saw.
_state = types.SimpleNamespace(mesh=None)


def axis_sizes(mesh: Any) -> dict[str, int]:
    """Ordered {axis name: size} of a ``DeviceMesh`` or of a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _mesh() -> Optional[Any]:
    return _state.mesh


@contextlib.contextmanager
def use_mesh_rules(mesh: Any):
    """Bind ``mesh`` as the activation-sharding target of the process
    (the backward's threads included).  Nestable; the previous binding is
    restored on exit.  Inside, a plain
    tensor meeting a DTensor in an op counts as replicated (DTensor's
    ``implicit_replication``): positions, masks and constants built with
    ``torch.arange`` and the like are alike on every rank."""
    from torch.distributed.tensor.experimental import implicit_replication

    prev = _state.mesh
    _state.mesh = mesh
    try:
        with implicit_replication():
            yield mesh
    finally:
        _state.mesh = prev


def current_mesh() -> Optional[Any]:
    """The mesh bound by ``use_mesh_rules`` (None outside)."""
    return _state.mesh


def active() -> bool:
    """True when a mesh-rules context is bound."""
    return _mesh() is not None


def dp_axis_names(mesh: Any = None) -> tuple[str, ...]:
    """The data-parallel axes present in ``mesh`` (major to minor)."""
    mesh = mesh if mesh is not None else _mesh()
    if mesh is None:
        return ()
    shape = axis_sizes(mesh)
    return tuple(a for a in _DP_AXES if a in shape)


def _axes_size(shape: Mapping[str, int], axes: tuple[str, ...]) -> int:
    size = 1
    for a in axes:
        size *= shape[a]
    return size


def model_size() -> int:
    """Size of the tensor-parallel axis (1 when inactive or absent)."""
    mesh = _mesh()
    if mesh is None:
        return 1
    return axis_sizes(mesh).get(_MODEL_AXIS, 1)


def dp_size() -> int:
    """Product of the data-parallel axis sizes (1 when inactive)."""
    mesh = _mesh()
    if mesh is None:
        return 1
    return _axes_size(axis_sizes(mesh), dp_axis_names(mesh))


def shed_to_divisible(mesh: Any, axes: tuple[str, ...], dim: int
                      ) -> tuple[str, ...]:
    """The PACO divisibility fallback: drop major axes (pod first) until
    the combined size divides ``dim``; () when none fit."""
    shape = axis_sizes(mesh)
    while axes and dim % _axes_size(shape, axes):
        axes = axes[1:]
    return axes


def _resolve(shape: Mapping[str, int], name: str | None
             ) -> tuple[str, ...]:
    if name is None:
        return ()
    if name == "dp":
        return tuple(a for a in _DP_AXES if a in shape)
    if name in shape:
        return (name,)
    return ()


def spec_for(mesh: Any, shape: tuple[int, ...], names: tuple) -> Spec:
    """Concrete spec for ``shape`` under the logical ``names``.

    Per dim: resolve the logical name to mesh axes, keep them only if their
    combined size divides the dimension and none was already used (a mesh
    axis appears once per spec); for the "dp" bundle, fall back through
    suffixes (drop the pod axis first) before giving up."""
    assert len(shape) == len(names), (shape, names)
    sizes = axis_sizes(mesh)
    entries = []
    used: set[str] = set()
    for dim, name in zip(shape, names):
        axes = shed_to_divisible(
            sizes, tuple(a for a in _resolve(sizes, name) if a not in used),
            dim)
        if axes:
            used.update(axes)
            entries.append(axes[0] if len(axes) == 1 else axes)
        else:
            entries.append(None)
    return tuple(entries)


def placements(mesh: Any, spec: Spec) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: mesh dim i gets
    ``Shard(d)`` when tensor dim d's entry names it, else ``Replicate()``.
    A dim cut over several axes (("data", "model") on dim 0) is
    ``Shard(d)`` on each of them; they must come in mesh order, the order
    in which DTensor nests the cuts (major to minor, as JAX's tuple).  A
    cut over an axis of size 1 is no cut: it places as ``Replicate()``
    (the same layout, and DTensor's view rules then need no
    redistribution on a 1 x 1 mesh)."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = axis_sizes(mesh)
    names = list(sizes)
    where: dict[str, int] = {}
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec entry {entry} is not in mesh order "
                             f"{names}")
        for a in axes:
            where[a] = d
    return tuple(Shard(where[a]) if a in where and sizes[a] > 1
                 else Replicate() for a in names)


def is_dtensor(x: Any) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain(x: torch.Tensor, *names) -> torch.Tensor:
    """Redistribute ``x`` to the spec of the logical ``names`` under the
    active mesh rules; the identity when inactive or on a plain tensor.
    One logical name per dimension: "dp", "model", a concrete mesh axis
    name, or None."""
    mesh = _mesh()
    if mesh is None or not is_dtensor(x):
        return x
    want = placements(x.device_mesh, spec_for(x.device_mesh,
                                              tuple(x.shape), names))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


# ---------------------------------------------------------------------------
# Shape-specific helpers (the vocabulary model code speaks)
# ---------------------------------------------------------------------------

def batch_seq(x: torch.Tensor) -> torch.Tensor:
    """(B, S, D) activations entering the layer stack: batch over dp."""
    return constrain(x, "dp", None, None)


def residual(x: torch.Tensor) -> torch.Tensor:
    """(B, S, D) residual stream: batch over dp, replicated over model
    (the paper's output-face rule: residual adds are elementwise, and
    cutting d_model here would reduce every block).  A row-parallel
    product's ``Partial`` output is summed here."""
    return constrain(x, "dp", None, None)


def heads(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, Dh) per-head activations: heads over the model axis (the
    attention cuboid's head cut), batch over dp."""
    return constrain(x, "dp", None, "model", None)


# ---------------------------------------------------------------------------
# Custom kernels under a mesh, and leaving DTensor land
# ---------------------------------------------------------------------------

def as_dtensor(x: torch.Tensor, mesh: Any) -> torch.Tensor:
    """``x`` as a DTensor on ``mesh``: a plain tensor (alike on every rank)
    becomes a replicated one."""
    if is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(x, mesh, placements(mesh, ()),
                              run_check=False)


def local_call(fn, in_names: tuple, out_like: int | tuple[int, ...],
               *args):
    """``fn(*args)`` on each rank's local shards (DTensor's ``local_map``):
    the kernel ops and ``autograd.Function``s have no DTensor sharding
    rule, so their callers lay the inputs out and hand every rank its own
    block.  ``in_names[i]`` gives the logical names of arg i's dims (as
    ``constrain``) or None for a non-tensor arg; plain tensor args count
    as replicated.  Output j takes the placements of arg ``out_like[j]``.
    Tensor args reach ``fn`` contiguous.  Without a mesh, or with no
    DTensor among the args, this is ``fn(*args)``."""
    mesh = _mesh()
    if mesh is None or not any(is_dtensor(a) for a in args):
        if any(is_dtensor(a) for a in args):
            raise RuntimeError("DTensor arguments outside use_mesh_rules")
        return fn(*args)
    from torch.distributed.tensor.experimental import local_map

    dargs, in_pl = [], []
    for a, names in zip(args, in_names):
        if names is None:
            dargs.append(a)
            in_pl.append(None)
            continue
        a = as_dtensor(a, mesh)
        want = placements(mesh, spec_for(mesh, tuple(a.shape), names))
        if tuple(a.placements) != want:
            a = a.redistribute(mesh, want)
        dargs.append(a)
        in_pl.append(want)
    single = isinstance(out_like, int)
    outs = (out_like,) if single else out_like
    # one output's placements go as a list: a tuple means one per output
    out_pl = tuple(list(in_pl[i]) for i in outs)

    def body(*local):
        return fn(*(t.contiguous() if isinstance(t, torch.Tensor) else t
                    for t in local))

    return local_map(body, out_placements=out_pl[0] if single else out_pl,
                     in_placements=tuple(in_pl), device_mesh=mesh)(*dargs)


def block_of(shape: tuple[int, ...], mesh: Any, place: tuple
             ) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """(local shape, global offsets) of this rank's block of a tensor of
    ``shape`` under ``place`` on ``mesh``: each ``Shard`` cuts its dim in
    mesh order, as ``torch.chunk`` does.  Host arithmetic only (DTensor's
    own helper reads the mesh's rank tensor, which a fake tensor mode
    refuses)."""
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    local, offs = list(shape), [0] * len(shape)
    for i, p in enumerate(place):
        if isinstance(p, Shard):
            size = local[p.dim]
            chunk = -(-size // mesh.size(i))
            start = min(coord[i] * chunk, size)
            local[p.dim] = min(size, start + chunk) - start
            offs[p.dim] += start
    return tuple(local), tuple(offs)


def local_block(x: torch.Tensor) -> tuple[torch.Tensor, tuple[int, ...]]:
    """A DTensor's local shard and the global offset of its first element
    on each dim; a plain tensor and zeros."""
    if not is_dtensor(x):
        return x, (0,) * x.ndim
    _, offs = block_of(tuple(x.shape), x.device_mesh, tuple(x.placements))
    return x.to_local(), offs


def laid_out_as(x: torch.Tensor, like: torch.Tensor, lead: int = 0,
                whole: tuple[int, ...] = ()) -> torch.Tensor:
    """The local block of ``x`` (a DTensor or a plain tensor alike on every
    rank) under the placements of the DTensor ``like``, whose dims are
    x's with ``lead`` more in front; ``x``'s dims in ``whole`` are left
    uncut.  Each rank then holds the part of ``x`` that meets its block of
    ``like`` (all of it along a ``whole`` dim)."""
    from torch.distributed.tensor import Replicate, Shard

    want = tuple(Shard(p.dim - lead) if isinstance(p, Shard)
                 and p.dim - lead not in whole else Replicate()
                 for p in like.placements)
    x = as_dtensor(x, like.device_mesh)
    if tuple(x.placements) != want:
        x = x.redistribute(like.device_mesh, want)
    return x.to_local()


def whole(x: torch.Tensor) -> torch.Tensor:
    """A DTensor replicated on every mesh dim (still a DTensor: its
    gradient is summed back to the original layout); a plain tensor as it
    is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    want = (Replicate(),) * x.device_mesh.ndim
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def dp_gathered(x: torch.Tensor) -> torch.Tensor:
    """FSDP's gather: a DTensor weight with its cuts over the
    data-parallel axes undone, its model-axis cut kept (the backward
    reduce-scatters the gradient back to the cut); a plain tensor as it
    is.  A product then meets its weight in the tensor-parallel layout
    alone, and DTensor picks no layout that cuts the tokens over the
    model axis."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    names = x.device_mesh.mesh_dim_names
    want = tuple(Replicate() if isinstance(p, Shard) and names[i] in _DP_AXES
                 else p for i, p in enumerate(x.placements))
    if want == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def summed(x: torch.Tensor) -> torch.Tensor:
    """A DTensor with its pending (``Partial``) sums done, its cuts kept;
    a plain tensor as it is.  A nonlinear op (a norm) takes its input so:
    DTensor would otherwise keep the Partial through the op's linear last
    step and gather the next product's weights to meet it."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Partial, Replicate

    want = tuple(Replicate() if isinstance(p, Partial) else p
                 for p in x.placements)
    if want == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def replicate(x: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered to a plain tensor, whole on every rank; a plain
    tensor as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def unshard_dim(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` with dim ``dim`` gathered whole (other cuts kept); plain
    tensors and DTensors not cut there pass through."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    dim = dim % x.ndim
    want = tuple(Replicate() if isinstance(p, Shard) and p.dim == dim
                 else p for p in x.placements)
    if want == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def assert_replicated(x: torch.Tensor, mesh: Any, what: str) -> None:
    """Raise unless the plain tensor ``x`` is equal on every rank of
    ``mesh`` (each rank samples the same token only if its inputs and
    generator agree; a disagreement is a fault, not something to
    broadcast away).  The min and max are reduced over each mesh dim's
    group in turn, which covers the whole mesh."""
    import torch.distributed as dist

    if mesh.size() == 1:
        return
    y = x.double() if x.is_floating_point() else x.long()
    lo, hi = y.clone(), y.clone()
    for d in range(mesh.ndim):
        dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=mesh.get_group(d))
        dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=mesh.get_group(d))
    if not (torch.equal(lo, y) and torch.equal(hi, y)):
        raise RuntimeError(f"{what} differs between ranks")
