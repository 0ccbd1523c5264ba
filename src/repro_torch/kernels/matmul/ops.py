"""Public matmuls of the port: one product (every Strassen leaf) and a
whole PACO plan (``paco_matmul``).

A CPU tensor takes the plain version (``ref``); a CUDA tensor launches the
hand-written kernel for any shape, ragged edges included, or raises.
``repro.kernels.matmul.ops.matmul`` falls back to ``jnp.dot`` where no
block size in (128, 64, 32, 16, 8) divides a dimension; the kernels mask
the ragged edges themselves, so nothing falls back here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.matmul.matmul import matmul_kernel, matmul_plan_kernel


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B in ``a.dtype``, the sum over k taken in float32."""
    return matmul_kernel(a, b)


def matmul_plan(a: torch.Tensor, b: torch.Tensor, plan) -> torch.Tensor:
    """The cuboids of ``plan`` (a ``core.cuboid.MMPlan``), each product in
    ``a.dtype`` with its sum over k in float32, parts that share outputs
    added in ``a.dtype`` in plan order."""
    return matmul_plan_kernel(a, b, plan)
