from temporalalignnet_torch.train.optimizer import Optimizer, lr_at
from temporalalignnet_torch.train.train_step import make_train_step

__all__ = ["Optimizer", "lr_at", "make_train_step"]
