from repro_torch.ft.elastic import (ElasticRunner, make_mesh_for,
                                    mesh_shape_for, replan_report)
from repro_torch.ft.straggler import (ThroughputTracker, hetero_tp_plan,
                                      rebalance_batch, straggler_speedup)

__all__ = ["ElasticRunner", "make_mesh_for", "mesh_shape_for",
           "replan_report", "ThroughputTracker", "hetero_tp_plan",
           "rebalance_batch", "straggler_speedup"]
