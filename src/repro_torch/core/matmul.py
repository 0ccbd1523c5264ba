"""PACO matrix multiplication: the plan-faithful tile executor.

``paco_matmul`` is the port of ``repro.core.matmul.paco_matmul`` (its first
tier): for an arbitrary p (primes welcome) it executes every processor's
cuboid from the planners in ``core.cuboid`` and combines the partial
products, exactly the paper's algorithm in the shared-memory model.  The
whole plan goes through ``kernels.matmul.ops.matmul_plan``: on a CUDA
tensor one launch of the hand-written kernel, one CTA per processor
walking its cuboids' faces in place; on the CPU the plain version, one
product per cuboid.  Plans are built once per (n, m, k, p, planner,
throughputs) and kept, and so is the kernel's table of each.

The SPMD executors come after it, on ``torch.distributed``:
``paco_matmul_shmap`` runs each rank's cuboid on a ("pc_n", "pc_m",
"pc_k") ``DeviceMesh`` shaped by the cut tree and reduce-scatters the
k-cut's partial products, and ``paco_matmul_pjit`` is a DTensor product
under ``paco_spec``'s placements.  Their local products are plain
``torch.matmul``, as ``repro`` leaves them to XLA outside any Pallas
kernel.
"""
from __future__ import annotations

import functools
from typing import Any, Sequence

import torch
import torch.distributed as dist

from repro_torch.core import cuboid as cub
from repro_torch.kernels.matmul import ops as mm_ops


def plan(n: int, m: int, k: int, p: int, planner: str = "1piece",
         throughputs: Sequence[float] | None = None) -> cub.MMPlan:
    """The cuboid plan ``paco_matmul`` executes for an (n, k) x (k, m)
    product on p processors (the same object for the same arguments)."""
    return _plan(n, m, k, p, planner,
                 None if throughputs is None else tuple(throughputs))


@functools.lru_cache(maxsize=64)
def _plan(n: int, m: int, k: int, p: int, planner: str,
          throughputs: tuple[float, ...] | None) -> cub.MMPlan:
    if planner == "1piece":
        return cub.plan_mm_1piece(n, m, k, p)
    if planner == "mm":
        return cub.plan_mm(n, m, k, p, base=max(1, min(n, m, k) // (4 * p)))
    if planner == "hetero":
        if throughputs is None or len(throughputs) != p:
            raise ValueError(f"the hetero planner needs p = {p} "
                             f"throughputs, got {throughputs}")
        return cub.plan_hetero(n, m, k, throughputs)
    raise ValueError(planner)


def paco_matmul(a: torch.Tensor, b: torch.Tensor, p: int, *,
                planner: str = "1piece",
                throughputs: Sequence[float] | None = None) -> torch.Tensor:
    """C = A @ B executed tile by tile per the PACO plan for p processors.

    Semantically A @ B; structurally the paper's algorithm: each
    processor computes the products of its cuboid(s) into temporary C
    tiles, and tiles sharing output rows and columns (k-cuts) are reduced
    by addition, in the output dtype, in plan order.
    """
    n, k = a.shape
    k2, m = b.shape
    if k != k2:
        raise ValueError(f"shapes {tuple(a.shape)} and {tuple(b.shape)} do "
                         f"not form a matrix product")
    return mm_ops.matmul_plan(a, b, plan(n, m, k, p, planner, throughputs))


# ---------------------------------------------------------------------------
# SPMD executor on the cut-tree-derived 3-D grid
# ---------------------------------------------------------------------------

def make_paco_mesh(n: int, m: int, k: int, p: int,
                   device_type: str | None = None) -> Any:
    """A ("pc_n", "pc_m", "pc_k") ``DeviceMesh`` shaped by the 1-piece cut
    tree's dimension factors, over the p ranks of the default process
    group (whose world size must be p).  ``device_type`` defaults to
    "cuda" on an NCCL group and "cpu" otherwise."""
    from torch.distributed.device_mesh import init_device_mesh

    if dist.get_world_size() != p:
        raise ValueError(f"the default group has {dist.get_world_size()} "
                         f"ranks, the plan {p}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, cub.mesh_factors(n, m, k, p),
                            mesh_dim_names=("pc_n", "pc_m", "pc_k"))


def _block(t: torch.Tensor, mesh: Any, spec: tuple) -> torch.Tensor:
    """This rank's block of the full tensor ``t`` under ``spec`` (each
    entry one axis name or None), as shard_map's in_specs slice."""
    for d, axis in enumerate(spec):
        if axis is None:
            continue
        size = mesh.size(mesh.mesh_dim_names.index(axis))
        if t.shape[d] % size:
            raise ValueError(f"dim {d} of {tuple(t.shape)} does not divide "
                             f"over {axis} ({size})")
        t = t.chunk(size, dim=d)[mesh.get_local_rank(axis)]
    return t.contiguous()


def paco_matmul_shmap(a: torch.Tensor, b: torch.Tensor, mesh: Any) -> Any:
    """SPMD PACO matmul on a ("pc_n", "pc_m", "pc_k") mesh.

    Every rank holds the full A and B (or is handed them alike), takes the
    faces of its cuboid, A[n/pn, k/pk] and B[k/pk, m/pm], multiplies them
    locally and reduce-scatters its partial C over the pc_k group along
    the columns: the cut tree's reduction rounds, each k-group member left
    with a disjoint C slab (paper Sect. III-E-1).  Returns C as a DTensor,
    rows over pc_n and columns over (pc_m, pc_k)."""
    from torch.distributed.tensor import DTensor, Shard

    part = _block(a, mesh, ("pc_n", "pc_k")) @ _block(b, mesh,
                                                      ("pc_k", "pc_m"))
    pk = mesh.size(2)
    if part.shape[1] % pk:
        raise ValueError(f"{part.shape[1]} columns do not divide over "
                         f"pc_k ({pk})")
    # reduce_scatter_tensor scatters along dim 0: lay the column chunks
    # one under the other first
    send = torch.cat(part.chunk(pk, dim=1), dim=0).contiguous()
    out = send.new_empty(part.shape[0], part.shape[1] // pk)
    dist.reduce_scatter_tensor(out, send, group=mesh.get_group("pc_k"))
    return DTensor.from_local(out, mesh, (Shard(0), Shard(1), Shard(1)),
                              run_check=False)


# ---------------------------------------------------------------------------
# DTensor path: plan => placements
# ---------------------------------------------------------------------------

def paco_spec(n: int, m: int, k: int, p: int, axis: str
              ) -> tuple[tuple, tuple, tuple, bool]:
    """Which single matmul dimension the mesh axis ``axis`` shards, per the
    first cut of the PACO 1-piece tree (the dominant cut: the paper cuts
    the longest dimension first, minimizing exposed surface).

    Returns (spec_a, spec_b, spec_c, needs_psum), each spec one entry per
    dim, an axis name or None (``repro``'s PartitionSpecs entry for
    entry).  The k-cut is ``needs_psum``: its partial products are summed,
    which DTensor carries as a ``Partial`` placement."""
    d = cub.Cuboid(0, n, 0, m, 0, k).longest_dim()
    if d == "n":
        return (axis, None), (None, None), (axis, None), False
    if d == "m":
        return (None, None), (None, axis), (None, axis), False
    return (None, axis), (axis, None), (None, None), True


def paco_matmul_pjit(a: torch.Tensor, b: torch.Tensor, mesh: Any,
                     axis: str) -> Any:
    """A @ B as a DTensor product under ``paco_spec``'s placements on the
    mesh axis ``axis``: the operands are laid out from the full tensors
    every rank holds, the product runs on each rank's shards, and C is
    redistributed to its spec (the k-cut's ``Partial`` resolves there to
    the replicated C by an all-reduce).  Returns C as a DTensor."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.dist.act_sharding import axis_sizes, placements

    n, k = a.shape
    m = b.shape[1]
    sa, sb, sc, _ = paco_spec(n, m, k, axis_sizes(mesh)[axis], axis)
    da = distribute_tensor(a, mesh, placements(mesh, sa))
    db = distribute_tensor(b, mesh, placements(mesh, sb))
    c = da @ db
    return c.redistribute(mesh, placements(mesh, sc))
