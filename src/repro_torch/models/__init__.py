from repro_torch.models.model import (active_param_count, decode_step_paged,
                                      decode_ticks, forward, init_params,
                                      loss_fn, paged_cache_leaf_specs,
                                      param_count, prefill_chunk)
from repro_torch.models.sampling import sample_tokens

__all__ = [
    "forward", "loss_fn", "active_param_count", "init_params",
    "paged_cache_leaf_specs", "prefill_chunk", "decode_step_paged",
    "decode_ticks", "param_count", "sample_tokens",
]
