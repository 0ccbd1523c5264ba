from repro_torch.models.model import (decode_step_paged, decode_ticks,
                                      init_params, paged_cache_leaf_specs,
                                      param_count, prefill_chunk)
from repro_torch.models.sampling import sample_tokens

__all__ = [
    "init_params", "paged_cache_leaf_specs", "prefill_chunk",
    "decode_step_paged", "decode_ticks", "param_count", "sample_tokens",
]
