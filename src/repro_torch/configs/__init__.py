from repro_torch.configs.base import (ArchConfig, MLAConfig, MoEConfig,
                                     SSMConfig)
from repro_torch.configs.registry import ARCHS, get_arch

__all__ = ["ArchConfig", "MLAConfig", "MoEConfig", "SSMConfig", "ARCHS",
           "get_arch"]
