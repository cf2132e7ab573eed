from temporalalignnet_torch.checkpoint.convert import (
    load_reference_checkpoint,
    reference_state_dict,
    state_dict_from_jax,
)

__all__ = ["load_reference_checkpoint", "reference_state_dict", "state_dict_from_jax"]
