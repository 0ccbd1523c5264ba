"""PACO core: the part of the paper's partitioner the port plans with."""
from repro_torch.core.cuboid import Cuboid, MMPlan, plan_mm_1piece

__all__ = ["Cuboid", "MMPlan", "plan_mm_1piece"]
