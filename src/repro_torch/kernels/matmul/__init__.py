from repro_torch.kernels.matmul.matmul import matmul_kernel
from repro_torch.kernels.matmul.ops import matmul
from repro_torch.kernels.matmul.ref import matmul_ref

__all__ = ["matmul_kernel", "matmul", "matmul_ref"]
