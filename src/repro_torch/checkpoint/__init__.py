from repro_torch.checkpoint.ckpt import latest_step, prune_old, restore, save

__all__ = ["save", "latest_step", "restore", "prune_old"]
