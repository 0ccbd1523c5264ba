"""PACO matrix multiplication: the plan-faithful tile executor.

``paco_matmul`` is the port of ``repro.core.matmul.paco_matmul`` (its first
tier): for an arbitrary p (primes welcome) it executes every processor's
cuboid from the planners in ``core.cuboid`` and combines the partial
products, exactly the paper's algorithm in the shared-memory model.  Each
cuboid's product goes through ``kernels.matmul.ops.matmul``: the
hand-written kernel on a CUDA tensor, which reads the cuboid's faces in
place, and the plain version on the CPU.

The SPMD executors of ``repro.core.matmul`` (``paco_matmul_shmap``,
``paco_matmul_pjit``, ``paco_spec``, ``make_paco_mesh``) are not ported
yet.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core import cuboid as cub
from repro_torch.kernels.matmul import ops as mm_ops


def plan(n: int, m: int, k: int, p: int, planner: str = "1piece",
         throughputs: Sequence[float] | None = None) -> cub.MMPlan:
    """The cuboid plan ``paco_matmul`` executes for an (n, k) x (k, m)
    product on p processors."""
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
    by addition, in the output dtype.  The output is updated in place.
    """
    n, k = a.shape
    k2, m = b.shape
    if k != k2:
        raise ValueError(f"shapes {tuple(a.shape)} and {tuple(b.shape)} do "
                         f"not form a matrix product")
    out = torch.zeros((n, m), dtype=torch.result_type(a, b), device=a.device)
    for _proc, c in plan(n, m, k, p, planner, throughputs).tiles:
        if c.volume() == 0:
            continue
        part = mm_ops.matmul(a[c.n0:c.n1, c.k0:c.k1], b[c.k0:c.k1, c.m0:c.m1])
        out[c.n0:c.n1, c.m0:c.m1] += part
    return out
