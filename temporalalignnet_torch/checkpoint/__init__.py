from temporalalignnet_torch.checkpoint.convert import (
    load_reference_checkpoint,
    merge_state_dict,
    reference_state_dict,
    save_reference_checkpoint,
    state_dict_from_jax,
    twin_state_dict,
)

__all__ = ["load_reference_checkpoint", "merge_state_dict", "reference_state_dict",
           "save_reference_checkpoint", "state_dict_from_jax", "twin_state_dict"]
