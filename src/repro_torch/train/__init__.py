from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                          train_step)
from repro_torch.train.trainer import Trainer

__all__ = ["TrainConfig", "init_train_state", "train_step", "Trainer"]
