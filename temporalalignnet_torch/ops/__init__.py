"""The port's attention and MIL-NCE ops.  Importing the package registers
the custom op ``temporalalignnet::mha_fwd`` (``ops/mha_fwd.py``), which a
loaded ``torch.export`` artifact of the eval forward calls."""

from typing import Callable, Dict

from temporalalignnet_torch.ops import mha_fwd  # noqa: F401  (registers the custom op)
from temporalalignnet_torch.ops.attention import attention_reference, multihead_attention

__all__ = ["attention_reference", "kernels", "multihead_attention"]


def kernels() -> Dict[str, Callable]:
    """The five kernel wrappers by name, each with its ``launches`` count and
    ``launches_by_route``."""
    from temporalalignnet_torch.ops import milnce
    from temporalalignnet_torch.ops.mha_bwd import mha_bwd

    return {"mha_fwd": mha_fwd.mha_fwd, "mha_bwd": mha_bwd, "milnce_fwd": milnce.milnce_fwd,
            "milnce_dv": milnce.milnce_dv, "milnce_dt": milnce.milnce_dt}
