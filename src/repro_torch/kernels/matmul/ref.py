"""Plain PyTorch version of the blocked matmul kernel (the oracle of
``csrc/matmul.cu``, as ``repro.kernels.matmul.ref`` is of the TPU one)."""
from __future__ import annotations

import torch


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B: the product of A and B widened to float32, cast to
    ``a.dtype``."""
    return (a.float() @ b.float()).to(a.dtype)
