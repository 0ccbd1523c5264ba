"""Hand-written Hopper kernels of the port (CUDA C++ in ``csrc/``), each
beside the plain PyTorch version it is held against."""
