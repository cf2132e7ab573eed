from temporalalignnet_torch.losses.masked import masked_mean, masked_quantile, masked_std
from temporalalignnet_torch.losses.tan_loss import get_loss, mask_from_time

__all__ = ["get_loss", "mask_from_time", "masked_mean", "masked_quantile", "masked_std"]
