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

The SPMD executors of ``repro.core.matmul`` (``paco_matmul_shmap``,
``paco_matmul_pjit``, ``paco_spec``, ``make_paco_mesh``) are not ported
yet.
"""
from __future__ import annotations

import functools
from typing import Sequence

import torch

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
