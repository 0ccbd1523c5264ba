from repro_torch.kernels.matmul.matmul import (matmul_kernel,
                                               matmul_plan_kernel)
from repro_torch.kernels.matmul.ops import matmul, matmul_plan
from repro_torch.kernels.matmul.ref import matmul_plan_ref, matmul_ref

__all__ = ["matmul_kernel", "matmul_plan_kernel", "matmul", "matmul_plan",
           "matmul_ref", "matmul_plan_ref"]
