"""repro_torch.dist: PACO-planned distributed execution on
``torch.distributed`` (port of ``repro.dist``).

Three layers, all driven by the planners in ``repro_torch.core``:

  * ``sharding``     weight, batch and cache specs from the 1-piece cut
                     tree (paco_spec), laid out as DTensors.
  * ``act_sharding`` logical-axis activation constraints bound to a
                     ``DeviceMesh`` by the ``use_mesh_rules`` context
                     manager, and the kernels' ``local_call``.
  * ``pipeline``     balanced layer-to-stage partitioning and a GPipe
                     schedule over one mesh axis.
"""
from repro_torch.dist import act_sharding, pipeline, sharding
from repro_torch.dist.act_sharding import (active, constrain, dp_size,
                                           model_size, use_mesh_rules)
from repro_torch.dist.pipeline import (pipeline_apply, stack_stage_params,
                                       stage_ranges)
from repro_torch.dist.sharding import (batch_specs, cache_specs, dp_axes,
                                       distribute, paged_pool_specs,
                                       param_specs, pool_shardings)

__all__ = [
    "act_sharding", "pipeline", "sharding",
    "active", "constrain", "dp_size", "model_size", "use_mesh_rules",
    "pipeline_apply", "stack_stage_params", "stage_ranges",
    "batch_specs", "cache_specs", "dp_axes", "distribute",
    "paged_pool_specs", "param_specs", "pool_shardings",
]
