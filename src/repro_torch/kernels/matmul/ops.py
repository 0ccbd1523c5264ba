"""Public matmul of the port: the base case of every PACO matmul cuboid and
Strassen leaf.

A CPU tensor takes the plain version (``ref.matmul_ref``); a CUDA tensor
launches the hand-written kernel for any shape, ragged edges included, or
raises.  ``repro.kernels.matmul.ops.matmul`` falls back to ``jnp.dot``
where no block size in (128, 64, 32, 16, 8) divides a dimension; the
kernel masks the ragged edges itself, so nothing falls back here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.matmul.matmul import matmul_kernel


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B in ``a.dtype``, the sum over k taken in float32."""
    return matmul_kernel(a, b)
