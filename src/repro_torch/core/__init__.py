"""PACO core: the paper's contribution, processor-aware cache-oblivious
partitioning of divide-and-conquer algorithms (Tang & Gao, 2020), ported
from ``repro.core``, with its SPMD executors on ``torch.distributed``.
The base cases of the matmul executors and of LCS run through the
hand-written kernels on a CUDA tensor."""
from repro_torch.core.tree import Assignment, pruned_bfs, geometric_decrease_ok
from repro_torch.core.cuboid import (
    Cuboid, MMPlan, plan_mm, plan_mm_1piece, plan_hetero, mesh_factors,
    megatron_comm_bytes,
)
from repro_torch.core.matmul import (make_paco_mesh, paco_matmul,
                                     paco_matmul_pjit, paco_matmul_shmap,
                                     paco_spec)
from repro_torch.core.strassen import (
    strassen, paco_strassen, plan_strassen, strassen_beneficial_depth,
    OMEGA0,
)
from repro_torch.core.lcs import (lcs_reference, lcs_tile, paco_lcs,
                                  partition_lcs, LCSPlan, Region)
from repro_torch.core.onedim import (onedim_reference, paco_onedim,
                                     partition_square, Rect)
from repro_torch.core.gap import gap_reference, paco_gap
from repro_torch.core.sort import (choose_pivots, paco_sort,
                                   paco_sort_shmap, sort_by_pivots)

__all__ = [
    "Assignment", "pruned_bfs", "geometric_decrease_ok",
    "Cuboid", "MMPlan", "plan_mm", "plan_mm_1piece", "plan_hetero",
    "mesh_factors", "megatron_comm_bytes",
    "paco_matmul", "make_paco_mesh", "paco_matmul_shmap", "paco_spec",
    "paco_matmul_pjit",
    "strassen", "paco_strassen", "plan_strassen",
    "strassen_beneficial_depth", "OMEGA0",
    "lcs_reference", "lcs_tile", "paco_lcs", "partition_lcs", "LCSPlan",
    "Region",
    "onedim_reference", "paco_onedim", "partition_square", "Rect",
    "gap_reference", "paco_gap",
    "choose_pivots", "paco_sort", "paco_sort_shmap", "sort_by_pivots",
]
