from repro_torch.configs.base import (SHAPES, ArchConfig, MLAConfig,
                                     MoEConfig, ShapeCell, SSMConfig,
                                     cell_applicable)
from repro_torch.configs.registry import ARCHS, get_arch

__all__ = ["ArchConfig", "MLAConfig", "MoEConfig", "SSMConfig", "ARCHS",
           "SHAPES", "ShapeCell", "cell_applicable", "get_arch"]
