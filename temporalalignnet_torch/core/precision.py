"""Re-export of the precision policy."""

from temporalalignnet_torch.core.config import Precision

__all__ = ["Precision"]
