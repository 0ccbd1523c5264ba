"""Hand-written Hopper kernel for the blocked matmul, and its wrapper.

``matmul_kernel`` replaces the TPU kernel
``repro/kernels/matmul/matmul.py: matmul_pallas`` with ``csrc/matmul.cu``:
C = A @ B, the sum over all of k accumulated in float32 and written once
in ``a.dtype``.  Unlike the TPU kernel, whose blocks must divide the shape,
it takes any n, m and k: its loads are predicated and zero-filled at the
ragged edges.  A and B may be views with a row stride (a PACO cuboid's
faces ``a[n0:n1, k0:k1]`` and ``b[k0:k1, m0:m1]``), read in place.

What bounds it on the card: operations, 2 n m k flops at 989 TFLOP/s in
bf16 (tensor cores, ``mma.sync``) or 67 TFLOP/s in float32 (CUDA cores,
true float32, not TF32).  ``csrc/matmul.cu``'s header says what the design
does about it.

The wrapper checks device, dtype, shape and strides and raises on
anything else, allocates C with ``torch.empty``, launches on the current
stream, raises if the launch reports a CUDA error, and adds one to
``matmul_kernel.launches``.  A CPU tensor takes the plain version
(``ref.matmul_ref``) instead.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import c_function

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
INT32_MAX = 2 ** 31 - 1


def _row_stride(name: str, t: torch.Tensor) -> int:
    """The row stride of a 2-D operand whose elements are contiguous
    along each row."""
    rows, cols = t.shape
    if cols > 1 and t.stride(1) != 1:
        raise ValueError(f"{name} must have unit column stride, got strides "
                         f"{t.stride()}")
    stride = t.stride(0) if rows > 1 else max(cols, 1)
    if stride < cols:
        raise ValueError(f"{name} rows overlap: strides {t.stride()} for "
                         f"shape {tuple(t.shape)}")
    return stride


def matmul_kernel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B (``csrc/matmul.cu``).

    a (n, k) and b (k, m): float32 or bfloat16, the same dtype, on one
    CUDA device, each with unit column stride and any row stride.  Returns
    a contiguous (n, m) tensor in ``a.dtype``.  On the CPU it returns the
    plain version.
    """
    if not a.is_cuda:
        from repro_torch.kernels.matmul.ref import matmul_ref
        return matmul_ref(a, b)
    if a.dtype not in _DTYPES:
        raise TypeError(f"a has dtype {a.dtype}; the kernel takes "
                        f"{sorted(map(str, _DTYPES))}")
    if b.dtype != a.dtype:
        raise TypeError(f"b has dtype {b.dtype}, expected {a.dtype}")
    if b.device != a.device:
        raise ValueError(f"b is on {b.device}, expected {a.device}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"shapes {tuple(a.shape)} and {tuple(b.shape)} do "
                         f"not form a matrix product")
    n, k = a.shape
    m = b.shape[1]
    if max(n, m, k) > INT32_MAX:
        raise ValueError(f"({n}, {m}, {k}) exceeds the kernel's 32-bit "
                         f"extents")
    lda, ldb = _row_stride("a", a), _row_stride("b", b)
    out = torch.empty((n, m), dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    fn = c_function("matmul", "matmul", (_I, _P, _P, _P, _I, _I, _I, _L, _L,
                                         _P))
    with torch.cuda.device(a.device):
        err = fn(_DTYPES[a.dtype], a.data_ptr(), b.data_ptr(), out.data_ptr(),
                 n, m, k, lda, ldb,
                 torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"matmul launch failed: CUDA error {err}")
    matmul_kernel.launches += 1
    return out


matmul_kernel.launches = 0
