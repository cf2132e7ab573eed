from temporalalignnet_torch.checkpoint.convert import (
    atomic_save,
    load_reference_checkpoint,
    merge_state_dict,
    reference_checkpoint,
    reference_state_dict,
    save_reference_checkpoint,
    state_dict_from_jax,
    twin_state_dict,
)
from temporalalignnet_torch.checkpoint.io import Checkpointer, latest

__all__ = ["Checkpointer", "atomic_save", "load_reference_checkpoint", "merge_state_dict",
           "reference_checkpoint", "reference_state_dict", "save_reference_checkpoint",
           "latest", "state_dict_from_jax", "twin_state_dict"]
