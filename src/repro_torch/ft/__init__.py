from repro_torch.ft.straggler import ThroughputTracker

__all__ = ["ThroughputTracker"]
