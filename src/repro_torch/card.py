"""The card's data-sheet figures, one home for the port: the roofline
(``launch.roofline``), the Strassen cost model (``core.strassen``), the
kernel benchmarks and ``chip_smoke.py``'s bound column read them here.

Every figure is the data sheet's for the NVIDIA H100 80GB HBM3 (SXM5) at
its 700 W limit; a card held to a lower power limit runs slower under
load.
"""
from __future__ import annotations

import torch

CARD = "NVIDIA H100 80GB HBM3, 700 W"
# Dense peaks of the data sheet (tensor cores for bf16, CUDA cores for
# true f32); int32 from the Hopper white paper's 64 INT32 lanes per SM:
# 132 SMs x 64 x 1.98 GHz boost (the clock at which 132 x 128 FP32 lanes
# x 2 give the sheet's 67 TFLOP/s).
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12,
              torch.int32: 132 * 64 * 1.98e9}
# Dense TF32 on the tensor cores: the card's f32-accurate product is three
# TF32 products there (``kernels.work.TF32_PASSES``), as kernels 5, 5b and
# 6 run float32 and as chip_smoke.py bounds every float32 kernel; a true
# f32 product on the CUDA cores (torch.matmul, allow_tf32 off) runs at
# PEAK_FLOPS.
PEAK_TF32_FLOPS = 495e12
HBM_BYTES_PER_S = 3.35e12          # HBM3
NVLINK_BYTES_PER_S = 450e9         # NVLink 4, a direction, within a node
NDR_BYTES_PER_S = 50e9             # one 400 Gb/s NDR port, between nodes
CARDS_PER_NODE = 8
