from repro_torch.models.draft import draft_ngram_propose
from repro_torch.models.model import (active_param_count, cache_spec,
                                      decode_step, decode_step_paged,
                                      decode_ticks, forward, init_cache,
                                      init_params, loss_fn,
                                      paged_cache_leaf_specs, param_count,
                                      prefill, prefill_chunk, verify_ticks)
from repro_torch.models.sampling import sample_tokens

__all__ = [
    "forward", "loss_fn", "active_param_count", "init_params",
    "cache_spec", "init_cache", "decode_step", "prefill",
    "paged_cache_leaf_specs", "prefill_chunk", "decode_step_paged",
    "decode_ticks", "verify_ticks", "draft_ngram_propose", "param_count",
    "sample_tokens",
]
