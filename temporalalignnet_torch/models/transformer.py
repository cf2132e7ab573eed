"""CLIP-style pre-LN transformer encoder with per-layer taps.

Counterpart of temporalalignnet_tpu/models/transformer.py, in the reference
key space (model/tfm_model.py:17-55): each block holds a packed
``attn.in_proj_weight [3D, D]`` / ``attn.in_proj_bias`` and ``attn.out_proj``
as torch nn.MultiheadAttention does, ``ln_1``, ``ln_2`` and an MLP
``mlp.c_fc`` / ``mlp.c_proj``.  Layout is batch-first [B, S, D].  The MLP's
activation is QuickGELU (the TAN's and OpenAI CLIP's) or exact GELU
(``act='gelu'``, CLIP exports trained with it); ``causal`` blocks (the CLIP
text tower) attend to no later key.

Under tensor parallelism (``parallel/tensor.py::shard_model_``) the
attention and the MLP hold their shard (``hold_shard``) and its group: the
attention runs its H / tp heads between the column-parallel q, k, v and the
row-parallel ``out_proj``, the MLP its columns of ``c_fc`` and rows of
``c_proj``.  Unsharded (tp = 1) their parameters and math are as before.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from temporalalignnet_torch.ops.attention import multihead_attention
from temporalalignnet_torch.parallel import tensor as tp_ops


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
        self.tp = None  # a tp_ops.TPGroup once it holds a shard

    def hold_shard(self, tp: "tp_ops.TPGroup") -> None:
        """Take this rank's shapes (the values come from the caller's load)."""
        tp_ops.check_tp(self.out_proj.in_features, self.heads, tp.size)
        self.tp = tp
        D, n = self.out_proj.in_features, self.out_proj.in_features // tp.size
        self.in_proj_weight = _sharded(self.in_proj_weight, 3 * n, D)
        self.in_proj_bias = _sharded(self.in_proj_bias, 3 * n)
        self.out_proj.weight = _sharded(self.out_proj.weight, D, n)

    def forward(self, x: torch.Tensor, key_padding_mask: Optional[torch.Tensor] = None):
        B, S, D = x.shape
        dh = D // self.heads
        if self.tp is None:
            qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
        else:  # this rank's H / tp heads
            qkv = tp_ops.column_parallel_linear(x, self.in_proj_weight, self.in_proj_bias,
                                                self.tp.group)
        qkv = qkv.view(B, S, 3, qkv.shape[-1] // (3 * dh), dh).permute(2, 0, 3, 1, 4)
        q, k, v = (t.contiguous() for t in qkv.unbind(0))  # [B, H, S, dh] each
        if self.causal:  # the CLIP text tower's; the TAN's blocks call it as before
            out = multihead_attention(q, k, v, key_padding_mask, causal=True)
        else:
            out = multihead_attention(q, k, v, key_padding_mask)
        out = out.transpose(1, 2).reshape(B, S, -1)
        if self.tp is None:
            return self.out_proj(out)
        return tp_ops.row_parallel_linear(out, self.out_proj.weight, self.out_proj.bias,
                                          self.tp.group)


def _sharded(like: torch.Tensor, *shape) -> nn.Parameter:
    """An empty shard-shaped parameter on ``like``'s device and dtype, marked
    sharded (``parallel/tensor.py::is_sharded``)."""
    p = nn.Parameter(torch.empty(shape, device=like.device, dtype=like.dtype))
    p.tp_sharded = True
    return p


ACTS = {"quick_gelu": quick_gelu, "gelu": F.gelu}  # F.gelu: the exact (erf) form


class MLP(nn.Module):
    def __init__(self, width: int, ratio: int = 4, act: str = "quick_gelu"):
        super().__init__()
        self.c_fc = nn.Linear(width, width * ratio)
        self.c_proj = nn.Linear(width * ratio, width)
        self.act = ACTS[act]
        self.tp = None  # a tp_ops.TPGroup once it holds a shard

    def hold_shard(self, tp: "tp_ops.TPGroup") -> None:
        """Take this rank's shapes (the values come from the caller's load)."""
        D, n = self.c_fc.in_features, self.c_fc.out_features // tp.size
        self.tp = tp
        self.c_fc.weight = _sharded(self.c_fc.weight, n, D)
        self.c_fc.bias = _sharded(self.c_fc.bias, n)
        self.c_proj.weight = _sharded(self.c_proj.weight, D, n)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is None:
            return self.c_proj(self.act(self.c_fc(x)))
        g = self.tp.group
        h = self.act(tp_ops.column_parallel_linear(x, self.c_fc.weight, self.c_fc.bias, g))
        return tp_ops.row_parallel_linear(h, self.c_proj.weight, self.c_proj.bias, g)


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
