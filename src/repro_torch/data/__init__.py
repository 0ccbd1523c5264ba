from repro_torch.data.pipeline import (DataConfig, data_config_for,
                                       global_batch, global_batch_rowwise,
                                       host_batch)

__all__ = ["DataConfig", "data_config_for", "global_batch",
           "global_batch_rowwise", "host_batch"]
