"""Plain PyTorch versions of the blocked matmul kernels (the oracles of
``csrc/matmul.cu``, as ``repro.kernels.matmul.ref`` is of the TPU one)."""
from __future__ import annotations

import torch


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B: the product of A and B widened to float32, cast to
    ``a.dtype``."""
    return (a.float() @ b.float()).to(a.dtype)


def matmul_plan_ref(a: torch.Tensor, b: torch.Tensor, plan) -> torch.Tensor:
    """Every cuboid of ``plan`` (a ``core.cuboid.MMPlan``) through
    ``matmul_ref``, each part added into a zeroed output in the output
    dtype, in plan order: ``repro.core.matmul.paco_matmul``'s first tier."""
    out = torch.zeros((a.shape[0], b.shape[1]),
                      dtype=torch.result_type(a, b), device=a.device)
    for _proc, c in plan.tiles:
        if c.volume() == 0:
            continue
        out[c.n0:c.n1, c.m0:c.m1] += matmul_ref(a[c.n0:c.n1, c.k0:c.k1],
                                                b[c.k0:c.k1, c.m0:c.m1])
    return out
