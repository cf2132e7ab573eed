"""Multi-head attention core: softmax(Q Kᵀ / √dh + key-pad bias) V.

Semantics match torch nn.MultiheadAttention with key_padding_mask (reference
model/tfm_model.py:30-32): padded keys are excluded from every query's
softmax; queries at padded positions still produce values the caller masks.

- ``attention_reference``: the plain PyTorch version, with the semantics of
  the fused kernel (temporalalignnet_tpu/ops/pallas_attention.py): a finite
  -1e30 additive bias on padded keys, so a fully padded row averages V
  uniformly; scores and softmax in f32; P cast to the value dtype before P·V;
  output in the input dtype.  It also holds the causal mask (the CLIP text
  tower), which no kernel takes: the JAX package sends causal attention to
  plain XLA, never to its Pallas kernel (ops/attention.py:61-80 there).
- ``KernelAttention``: the autograd Function of the Hopper kernels, forward
  the custom op ``temporalalignnet::mha_fwd`` (``ops/mha_fwd.py``) and
  backward ``ops/mha_bwd.py`` (the counterpart of the
  custom VJP at pallas_attention.py:198-221).  Only q, k, v and the mask are
  saved; the backward recomputes P.
- ``multihead_attention``: dispatch on the device.  A CPU tensor takes the
  reference (autograd through plain PyTorch); a CUDA tensor goes through
  ``KernelAttention`` or raises.  Causal attention is plain PyTorch on every
  device, as in JAX; ``multihead_attention.causal_calls`` counts it.
- ``cross_attention``: queries of length S on keys and values of length M
  (the decoder's attention on its memory), plain PyTorch on every device.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1.0e30  # finite f32 mask bias; exact -inf breaks fully padded rows


def attention_reference(
    q: torch.Tensor,  # [B, H, S, Dh]
    k: torch.Tensor,
    v: torch.Tensor,
    key_padding_mask: Optional[torch.Tensor] = None,  # [B, S] True = pad
    causal: bool = False,
) -> torch.Tensor:
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if key_padding_mask is not None:
        bias = torch.zeros(key_padding_mask.shape, dtype=torch.float32, device=q.device)
        bias = bias.masked_fill(key_padding_mask.bool(), NEG_INF)
        scores = scores + bias[:, None, None, :]
    if causal:
        S = scores.shape[-1]
        keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~keep, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


class KernelAttention(torch.autograd.Function):
    """[B, H, S, Dh] attention on the card with the kernels' backward."""

    @staticmethod
    def forward(ctx, q, k, v, key_padding_mask):
        from temporalalignnet_torch.ops import mha_fwd

        ctx.save_for_backward(q, k, v, key_padding_mask)
        return mha_fwd.mha_fwd(q, k, v, key_padding_mask)

    @staticmethod
    def backward(ctx, dout):
        from temporalalignnet_torch.ops import mha_bwd

        q, k, v, key_padding_mask = ctx.saved_tensors
        dq, dk, dv = mha_bwd.mha_bwd(q, k, v, key_padding_mask, dout)
        return dq, dk, dv, None


def multihead_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_padding_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
) -> torch.Tensor:
    """[B, H, S, Dh] attention with an optional [B, S] key padding mask (True = pad)."""
    if causal:
        multihead_attention.causal_calls += 1
        return attention_reference(q, k, v, key_padding_mask, causal=True)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, key_padding_mask)
    if q.device.type == "cuda":
        return KernelAttention.apply(q, k, v, key_padding_mask)
    raise ValueError(f"no attention path for device {q.device}")


multihead_attention.causal_calls = 0


def cross_attention(
    q: torch.Tensor,  # [B, H, S, Dh]
    k: torch.Tensor,  # [B, H, M, Dh]
    v: torch.Tensor,  # [B, H, M, Dh]
    memory_key_padding_mask: Optional[torch.Tensor] = None,  # [B, M] True = pad
) -> torch.Tensor:
    """Attention of S queries on a memory of M keys and values: two
    ``torch.matmul``s and a masked softmax (``attention_reference``) on every
    device, with autograd through plain PyTorch.  No kernel backs it: the JAX
    package computes it as XLA outside any Pallas kernel
    (models/transformer.py:209-211 there), and the port's kernels take q, k
    and v of one length S (``ops/mha_fwd.py::check_shapes``).
    ``cross_attention.calls`` counts it."""
    cross_attention.calls += 1
    return attention_reference(q, k, v, memory_key_padding_mask)


cross_attention.calls = 0
