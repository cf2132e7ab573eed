from temporalalignnet_torch.train.optimizer import Optimizer, lr_at
from temporalalignnet_torch.train.train_step import (EMATwin, make_multi_train_step,
                                                     make_train_step)

__all__ = ["EMATwin", "Optimizer", "lr_at", "make_multi_train_step", "make_train_step"]
