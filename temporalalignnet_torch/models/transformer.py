"""CLIP-style pre-LN transformer encoder with per-layer taps.

Counterpart of temporalalignnet_tpu/models/transformer.py, in the reference
key space (model/tfm_model.py:17-55): each block holds a packed
``attn.in_proj_weight [3D, D]`` / ``attn.in_proj_bias`` and ``attn.out_proj``
as torch nn.MultiheadAttention does, ``ln_1``, ``ln_2`` and an MLP
``mlp.c_fc`` / ``mlp.c_proj``.  Layout is batch-first [B, S, D].  The MLP's
activation is QuickGELU (the TAN's and OpenAI CLIP's) or exact GELU
(``act='gelu'``, CLIP exports trained with it); ``causal`` blocks (the CLIP
text tower) attend to no later key.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from temporalalignnet_torch.ops.attention import multihead_attention


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 x) (reference tfm_model.py:11-13)."""
    return x * torch.sigmoid(1.702 * x)


class MultiheadSelfAttention(nn.Module):
    def __init__(self, width: int, heads: int, causal: bool = False):
        super().__init__()
        self.heads = heads
        self.causal = causal
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, key_padding_mask: Optional[torch.Tensor] = None):
        B, S, D = x.shape
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
        qkv = qkv.view(B, S, 3, self.heads, D // self.heads).permute(2, 0, 3, 1, 4)
        q, k, v = (t.contiguous() for t in qkv.unbind(0))  # [B, H, S, dh] each
        if self.causal:  # the CLIP text tower's; the TAN's blocks call it as before
            out = multihead_attention(q, k, v, key_padding_mask, causal=True)
        else:
            out = multihead_attention(q, k, v, key_padding_mask)
        return self.out_proj(out.transpose(1, 2).reshape(B, S, D))


ACTS = {"quick_gelu": quick_gelu, "gelu": F.gelu}  # F.gelu: the exact (erf) form


class MLP(nn.Module):
    def __init__(self, width: int, ratio: int = 4, act: str = "quick_gelu"):
        super().__init__()
        self.c_fc = nn.Linear(width, width * ratio)
        self.c_proj = nn.Linear(width * ratio, width)
        self.act = ACTS[act]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(self.act(self.c_fc(x)))


class ResidualAttentionBlock(nn.Module):
    """Pre-LN block returning (output, ln_1(input)) (tfm_model.py:34-38)."""

    def __init__(self, width: int, heads: int, mlp_ratio: int = 4, act: str = "quick_gelu",
                 causal: bool = False):
        super().__init__()
        self.attn = MultiheadSelfAttention(width, heads, causal)
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)
        self.mlp = MLP(width, mlp_ratio, act)

    def forward(self, x: torch.Tensor, key_padding_mask: Optional[torch.Tensor] = None):
        x_norm = self.ln_1(x)
        x = x + self.attn(x_norm, key_padding_mask)
        x = x + self.mlp(self.ln_2(x))
        return x, x_norm


class TemporalEncoder(nn.Module):
    """Stack of blocks; returns the per-layer taps (length == layers):
    [ln_1⁽²⁾(out_1), ln_1⁽³⁾(out_2), ..., ln_1⁽ᴸ⁾(out_{L-1}), out_L]
    — each non-final output normalized by the next block's ln_1
    (tfm_model.py:48-55).  The caller applies its own post-LN to the last."""

    def __init__(self, width: int, layers: int, heads: int, mlp_ratio: int = 4,
                 remat: bool = False):
        super().__init__()
        self.remat = remat
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, mlp_ratio) for _ in range(layers)
        )

    def forward(
        self, x: torch.Tensor, key_padding_mask: Optional[torch.Tensor] = None
    ) -> List[torch.Tensor]:
        taps = []
        remat = self.remat and torch.is_grad_enabled()
        for block in self.resblocks:
            if remat:
                x, x_norm = checkpoint(block, x, key_padding_mask, use_reentrant=False)
            else:
                x, x_norm = block(x, key_padding_mask)
            taps.append(x_norm)
        taps.pop(0)
        taps.append(x)
        return taps
