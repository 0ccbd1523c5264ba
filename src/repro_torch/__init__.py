"""PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

Mirrors ``repro``'s subpackage layout (configs, core, models,
kernels/attention, kernels/matmul, kernels/lcs, serve, launch) and keeps
its public layouts, so each module can be held against its JAX
counterpart on the same inputs.  The
package imports torch and numpy only.  Its hand-written Hopper kernels live
in ``csrc/`` and are built with nvcc at first use
(``repro_torch.kernels.build``).
"""
