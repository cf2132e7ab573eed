from temporalalignnet_torch.checkpoint.clip_convert import (clip_text_state_dict,
                                                           clip_vision_state_dict)
from temporalalignnet_torch.checkpoint.convert import (
    atomic_save,
    bert_state_dict_from_jax,
    decoder_state_dict_from_jax,
    load_reference_checkpoint,
    merge_into,
    merge_state_dict,
    reference_checkpoint,
    reference_state_dict,
    s3d_state_dict_from_jax,
    save_reference_checkpoint,
    state_dict_from_jax,
    twin_state_dict,
)
from temporalalignnet_torch.checkpoint.io import Checkpointer, latest
from temporalalignnet_torch.checkpoint.milnce import load_milnce_checkpoint, s3d_state_dict
from temporalalignnet_torch.checkpoint.timesformer_convert import timesformer_state_dict

__all__ = ["Checkpointer", "atomic_save", "bert_state_dict_from_jax", "clip_text_state_dict",
           "clip_vision_state_dict", "decoder_state_dict_from_jax", "load_milnce_checkpoint",
           "load_reference_checkpoint",
           "merge_into", "merge_state_dict", "reference_checkpoint", "reference_state_dict",
           "save_reference_checkpoint", "latest", "s3d_state_dict", "s3d_state_dict_from_jax",
           "state_dict_from_jax", "timesformer_state_dict", "twin_state_dict"]
