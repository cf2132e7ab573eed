from temporalalignnet_torch.ops.attention import attention_reference, multihead_attention

__all__ = ["attention_reference", "multihead_attention"]
