from repro_torch.optim.adamw import (AdamWConfig, adamw_update,
                                     clip_by_global_norm, init_opt_state,
                                     lr_at)
from repro_torch.optim.compression import (compress_grads, compressed_bytes,
                                           init_error_buffer)

__all__ = ["AdamWConfig", "adamw_update", "clip_by_global_norm",
           "init_opt_state", "lr_at", "compress_grads", "compressed_bytes",
           "init_error_buffer"]
