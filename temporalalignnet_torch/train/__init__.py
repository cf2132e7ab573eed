from temporalalignnet_torch.train.optimizer import Optimizer, lr_at
from temporalalignnet_torch.train.train_step import EMATwin, make_train_step

__all__ = ["EMATwin", "Optimizer", "lr_at", "make_train_step"]
