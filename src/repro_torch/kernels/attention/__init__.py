from repro_torch.kernels.attention.attention import (flash_attention,
                                                     flash_attention_bwd,
                                                     paged_flash_decode,
                                                     paged_flash_prefill,
                                                     paged_latent_decode,
                                                     paged_latent_prefill)
from repro_torch.kernels.attention.ops import (
    gather_kv_pages, paged_decode_attention, paged_latent_decode_attention,
    paged_latent_prefill_attention, paged_prefill_attention)
from repro_torch.kernels.attention.ref import (attention_ref,
                                               attention_ref_grad,
                                               paged_attention_ref,
                                               paged_latent_attention_ref,
                                               paged_latent_prefill_ref,
                                               paged_prefill_ref)

__all__ = [
    "flash_attention", "flash_attention_bwd", "attention_ref",
    "attention_ref_grad",
    "paged_flash_decode", "paged_flash_prefill", "paged_latent_decode",
    "paged_latent_prefill", "gather_kv_pages", "paged_decode_attention",
    "paged_prefill_attention", "paged_latent_decode_attention",
    "paged_latent_prefill_attention", "paged_attention_ref",
    "paged_prefill_ref", "paged_latent_attention_ref",
    "paged_latent_prefill_ref",
]
