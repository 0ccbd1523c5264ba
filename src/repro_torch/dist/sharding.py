"""PACO-planned parameter, batch and cache specs (port of
``repro.dist.sharding``), laid out as DTensors on a ``DeviceMesh``.

The bridge from the paper's cut trees to the mesh: every weight is a face
of its matmul cuboid (tokens x d_out x d_in), and the tensor-parallel mesh
axis cuts the dimension the 1-piece planner would cut FIRST, the longest
weight face (``core.matmul.paco_spec``), not a fixed Megatron-style rule.
Wide-output weights come out column-parallel, wide-input weights
row-parallel (their k-cut is ``paco_spec``'s ``needs_psum`` branch: the
product's ``Partial`` output is summed by the next ``residual``
constraint), and non-divisible faces fall back to the next-longest
divisible cut.  The data-parallel axes FSDP-cut the remaining face.

Specs are tuples in JAX's PartitionSpec form (one entry per dim: None, an
axis name or a tuple of axis names), computed from any ordered axis ->
size mapping (a ``DeviceMesh`` or a dict); ``distribute`` lays a tree of
full tensors out as DTensors under them.

  param_specs(cfg, params, mesh) -> tree of specs
  batch_specs(cfg, mesh, batch)  -> tree of specs
  cache_specs(cfg, mesh, cache)  -> dict of specs
  paged_pool_specs(cfg, mesh, pools) -> dict of specs
  dp_axes(mesh)                  -> data-parallel axis names
  distribute(mesh, tree, specs)  -> tree of DTensors
"""
from __future__ import annotations

from typing import Any, Callable, Mapping

import torch

from repro_torch.core.matmul import paco_spec
from repro_torch.dist.act_sharding import (_MODEL_AXIS, Spec, axis_sizes,
                                           block_of, dp_axis_names,
                                           placements, shed_to_divisible)


def dp_axes(mesh: Any) -> tuple[str, ...]:
    """Data-parallel axis names present in ``mesh`` (major to minor)."""
    return dp_axis_names(mesh)


def _model_size(mesh: Any) -> int:
    return axis_sizes(mesh).get(_MODEL_AXIS, 1)


def _has_model(mesh: Any) -> bool:
    return _model_size(mesh) > 1


def _dp_entry(mesh: Any, dim: int):
    """Spec entry cutting ``dim`` over the dp axes (the shed-to-divisible
    fallback); None if no dp axis fits."""
    axes = shed_to_divisible(mesh, dp_axes(mesh), dim)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def _fill_dp(entries: list, dims: tuple[int, int], mesh: Any) -> None:
    """dp FSDP on the longest divisible face still free."""
    free = [i for i in (0, 1) if entries[i] is None]
    for i in sorted(free, key=lambda i: -dims[i]):
        e = _dp_entry(mesh, dims[i])
        if e is not None:
            entries[i] = e
            break


def _weight_spec(d_in: int, d_out: int, mesh: Any) -> Spec:
    """Spec of a (d_in, d_out) matmul weight.

    The model axis lands on the dimension the PACO 1-piece tree cuts first
    for the cuboid (tokens x d_out x d_in): ``paco_spec``'s B-face spec is
    (k, m) = (d_in, d_out), so an m-dominant cut is column-parallel and a
    k-dominant cut row-parallel (the reduction path).  Non-divisible first
    choices fall back to the other face, then to no model cut at all; the
    dp axes FSDP-cut the longest remaining divisible face."""
    pm = _model_size(mesh)
    dims = (d_in, d_out)
    model_dim = None
    if pm > 1:
        # Token extent 1 restricts the planner's first cut to the weight's
        # own faces: the longest-dim rule on the (m, k) rectangle.
        _, spec_b, _, _ = paco_spec(1, d_out, d_in, pm, _MODEL_AXIS)
        model_dim = 0 if spec_b[0] == _MODEL_AXIS else 1
        if dims[model_dim] % pm:
            model_dim = 1 - model_dim
            if dims[model_dim] % pm:
                model_dim = None
    entries: list = [None, None]
    if model_dim is not None:
        entries[model_dim] = _MODEL_AXIS
    _fill_dp(entries, dims, mesh)
    return tuple(entries)


def _expert_spec(shape: tuple[int, ...], mesh: Any) -> Spec:
    """(..., E, d, f) expert-stacked weights: experts over the model axis
    (expert parallelism: each expert's FFN stays local), dp FSDP on the
    longest divisible remaining face."""
    pm = _model_size(mesh)
    lead = len(shape) - 3
    e_entry = _MODEL_AXIS if pm > 1 and shape[-3] % pm == 0 else None
    entries: list = [None, None]
    _fill_dp(entries, shape[-2:], mesh)
    return (None,) * lead + (e_entry, *entries)


def _mla_weight_spec(key: str, shape: tuple[int, ...], cfg, mesh: Any
                     ) -> Spec | None:
    """PACO k-cut bridge for the MLA low-rank factors; None = not MLA.

    Down-projections (``w_dq``, ``w_dkv``) take the k-cut, row-parallel on
    d_model.  ``w_dkv`` is NEVER column-cut, by the model axis or by the
    dp-FSDP fallback: its output is the [c_kv | k_rope] concat, and any
    cut there can land mid-boundary.  Up-projections (``w_uq``, ``w_uk``,
    ``w_uv``) are column-parallel iff the cut is head-aligned (n_heads
    divisible by the model axis), else dp-only.  The low-rank bottleneck
    dims are never model-cut."""
    m = getattr(cfg, "mla", None)
    if m is None or key not in ("w_dq", "w_dkv", "w_uq", "w_uk", "w_uv"):
        return None
    pm = _model_size(mesh)
    has_model = pm > 1
    d_in, d_out = shape[-2:]
    entries: list = [None, None]
    if key == "w_dkv":
        if has_model and d_in % pm == 0:
            entries[0] = _MODEL_AXIS
        else:
            entries[0] = _dp_entry(mesh, d_in)
        return tuple(entries)
    if key == "w_dq":
        if has_model and d_in % pm == 0:
            entries[0] = _MODEL_AXIS
    elif has_model and cfg.n_heads % pm == 0 and d_out % pm == 0:
        entries[1] = _MODEL_AXIS      # up-projections: head-aligned cut
    _fill_dp(entries, (d_in, d_out), mesh)
    return tuple(entries)


def tree_map_with_key(fn: Callable[[str, Any], Any], tree: Any,
                      key: str = "") -> Any:
    """Map ``fn(key, leaf)`` over nested dicts and lists, ``key`` the last
    dict key on the leaf's path (as ``repro`` reads it from a JAX path)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_key(fn, v, str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_key(fn, v, key) for v in tree)
    return fn(key, tree)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Map over the leaves of matching nested dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, *xs) for xs in zip(tree, *rest)]
    return fn(tree, *rest)


def param_specs(cfg, params: Any, mesh: Any) -> Any:
    """Spec tree for a parameter tree (tensors, meta tensors or anything
    with a ``shape``).  Scalars and vectors replicate; matrices take the
    PACO weight rule on their trailing two dims (leading stacked layer or
    group dims replicate); MoE expert stacks also cut the expert dim over
    the model axis; MLA low-rank factors take ``_mla_weight_spec``.
    Layer-stacked norm scales (``ln*`` / ``*norm`` leaves) replicate: they
    are elementwise gains, not matmul faces."""
    n_experts = cfg.moe.n_experts if getattr(cfg, "moe", None) else -1

    def spec(key: str, leaf) -> Spec:
        shape = tuple(leaf.shape)
        if len(shape) <= 1:
            return ()
        if key.startswith("ln") or key.endswith("norm"):
            return ()
        if len(shape) >= 3 and shape[-3] == n_experts:
            return _expert_spec(shape, mesh)
        lead = (None,) * (len(shape) - 2)
        mla = _mla_weight_spec(key, shape, cfg, mesh)
        if mla is not None:
            return lead + mla
        return lead + _weight_spec(shape[-2], shape[-1], mesh)

    return tree_map_with_key(spec, params)


def batch_specs(cfg, mesh: Any, batch: Any) -> Any:
    """Global-batch inputs: the leading (batch) dim over the dp axes, the
    rest replicated."""
    def spec(leaf) -> Spec:
        shape = tuple(leaf.shape)
        return (_dp_entry(mesh, shape[0]),) + (None,) * (len(shape) - 1)

    return tree_map(spec, batch)


def cache_specs(cfg, mesh: Any, cache: Mapping[str, Any]
                ) -> dict[str, Spec]:
    """Decode-state specs, mirroring the model's activation constraints:
    attention K/V cut heads over the model axis when they divide, else the
    sequence; MLA latents and SSM states cut their model-divisible face;
    batch always rides the dp axes."""
    pm = _model_size(mesh)

    def model_on(shape: tuple[int, ...], *dims: int):
        """First dim (in preference order) divisible by the model axis."""
        if pm <= 1:
            return None
        for d in dims:
            if shape[d] % pm == 0:
                return d
        return None

    where = {"k": (3, 2), "v": (3, 2), "xk": (3, 2), "xv": (3, 2),
             "c_kv": (2,), "k_rope": (2,), "conv": (3,), "ssm": (2,)}
    specs: dict[str, Spec] = {}
    for name, leaf in cache.items():
        shape = tuple(leaf.shape)
        entries: list = [None] * len(shape)
        if len(shape) >= 2:
            entries[1] = _dp_entry(mesh, shape[1])
        d = model_on(shape, *where[name]) if name in where else None
        if d is not None:
            entries[d] = _MODEL_AXIS
        specs[name] = tuple(entries)
    return specs


def paged_pool_specs(cfg, mesh: Any, pools: Mapping[str, Any]
                     ) -> dict[str, Spec]:
    """Specs of the serve engine's page pools.

    Dense-KV pools (``k``/``v``, (L, n_pages, page, H, dh)): the model axis
    cuts the head dim when it divides.  MLA latent pools (``c_kv``/
    ``k_rope``, (L, n_pages, page, feat)) replicate: they are head-free and
    their feature dim is the contraction face of the absorbed attention.
    The page contents stay whole and the physical-page dim is never cut
    (pages are gathered by block table).  The dp axes replicate: each
    data-parallel replica serves its own traffic."""
    pm = _model_size(mesh)

    def spec(name: str, leaf) -> Spec:
        shape = tuple(leaf.shape)
        entries: list = [None] * len(shape)
        if (name in ("k", "v", "xk", "xv") and pm > 1 and len(shape) >= 2
                and shape[-2] % pm == 0):
            entries[-2] = _MODEL_AXIS
        return tuple(entries)

    return {name: spec(name, leaf) for name, leaf in pools.items()}


def pool_shardings(cfg, mesh: Any, pools: Mapping[str, Any]
                   ) -> dict[str, tuple]:
    """DTensor placements of the page pools, from ``paged_pool_specs``:
    the engine lays the pools out with these, and every page write keeps
    them (writes go to each rank's local shard in place)."""
    return {name: placements(mesh, s)
            for name, s in paged_pool_specs(cfg, mesh, pools).items()}


def verify_shardings(cfg, mesh: Any, pools: Mapping[str, Any]
                     ) -> tuple[tuple, tuple, tuple, dict[str, tuple]]:
    """Placements of the speculative verify dispatch's outputs: the token
    block, the accepted-draft counts and the token history replicate
    (every rank computes the same argmax from replicated logits); the
    pools keep ``pool_shardings``."""
    rep = placements(mesh, ())
    return rep, rep, rep, pool_shardings(cfg, mesh, pools)


def shard_of(t: torch.Tensor, mesh: Any, place: tuple) -> Any:
    """The DTensor of the full tensor ``t`` (alike on every rank) under
    ``place``: each rank slices its own block, with no communication (the
    specs cut only dims their axes divide)."""
    from torch.distributed.tensor import DTensor, Shard

    coord = mesh.get_coordinate()
    local = t
    for i, p in enumerate(place):
        if isinstance(p, Shard):
            size = mesh.size(i)
            if local.shape[p.dim] % size:
                raise ValueError(f"dim {p.dim} of {tuple(t.shape)} does "
                                 f"not divide over mesh dim {i} ({size})")
            local = local.chunk(size, dim=p.dim)[coord[i]]
    return DTensor.from_local(local.contiguous(), mesh, place,
                              run_check=False, shape=t.shape,
                              stride=t.contiguous().stride())


def _contiguous_stride(shape: tuple[int, ...]) -> tuple[int, ...]:
    stride, out = 1, []
    for d in reversed(shape):
        out.append(stride)
        stride *= d
    return tuple(reversed(out))


def zeros_laid_out(mesh: Any, leaves: Mapping[str, Any], specs: Mapping,
                   device: torch.device | str) -> dict[str, Any]:
    """Zeros of each leaf (anything with ``shape`` and ``dtype``) as a
    DTensor under its spec, each rank allocating only its own block."""
    from torch.distributed.tensor import DTensor

    out = {}
    for name, leaf in leaves.items():
        shape = torch.Size(leaf.shape)
        place = placements(mesh, specs[name])
        local, _ = block_of(tuple(shape), mesh, place)
        out[name] = DTensor.from_local(
            torch.zeros(local, dtype=leaf.dtype, device=device), mesh, place,
            run_check=False, shape=shape, stride=_contiguous_stride(shape))
    return out


def distribute(mesh: Any, tree: Any, specs: Any) -> Any:
    """Lay out a tree of full tensors as DTensors under ``specs`` (the
    port's ``to_named`` + ``device_put``).  Every rank passes the same
    full tensors; each keeps its block."""
    return tree_map(lambda t, spec: shard_of(t, mesh, placements(mesh, spec)),
                    tree, specs)
