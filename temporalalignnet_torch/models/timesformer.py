"""TimeSformer video tower, divided space-time attention, for the feature
extractor (counterpart of temporalalignnet_tpu/models/timesformer.py; the
reference extractor's ``timesformer`` branch,
htm_zoo/visual/extract_feature_template.py:266-269).

Per frame a strided conv embeds the patches; the tokens carry learned space
and time positions in patch-major / frame-minor order (index 1 + p T + t)
behind a class token.  Each layer runs
- temporal attention per patch over the T frames (no class token), then
  ``temporal_dense`` into a residual;
- spatial attention per frame over 1 + P tokens, the layer's incoming class
  token replicated to every frame and the frames' class outputs averaged
  back;
- the MLP (exact GELU), all pre-LN with eps 1e-6.
Both attentions go through ``ops.attention.multihead_attention``: on the card
the Hopper ``mha_fwd`` at [B P, H, T, 64] (short route) and
[B T, H, 1 + P, 64] (long route at 224², P = 196).  Weights in HF's
TimesformerModel key space go through ``checkpoint/timesformer_convert.py``.
Defaults are the published base model (width 768, 12 layers of 12 heads,
patch 16, 8 frames of 224²).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from temporalalignnet_torch.ops.attention import multihead_attention

# TimeSformer's pixel normalization (facebookresearch/TimeSformer DATA.MEAN/STD)
TIMESFORMER_PIXEL_MEAN = (0.45, 0.45, 0.45)
TIMESFORMER_PIXEL_STD = (0.225, 0.225, 0.225)


class Attention(nn.Module):
    """Fused-QKV self-attention [N, L, D] -> [N, L, D] (TimesformerSelfAttention
    and its output dense)."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(width, 3 * width)
        self.proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        N, L, D = x.shape
        qkv = self.qkv(x).view(N, L, 3, self.heads, D // self.heads).permute(2, 0, 3, 1, 4)
        q, k, v = (t.contiguous() for t in qkv.unbind(0))  # [N, H, L, hd] each
        out = multihead_attention(q, k, v)
        return self.proj(out.transpose(1, 2).reshape(N, L, D))


class TimeSformerBlock(nn.Module):
    def __init__(self, width: int, heads: int, mlp_width: int, eps: float = 1e-6):
        super().__init__()
        self.temporal_ln = nn.LayerNorm(width, eps=eps)
        self.temporal_attn = Attention(width, heads)
        self.temporal_dense = nn.Linear(width, width)
        self.ln_before = nn.LayerNorm(width, eps=eps)
        self.attn = Attention(width, heads)
        self.ln_after = nn.LayerNorm(width, eps=eps)
        self.c_fc = nn.Linear(width, mlp_width)
        self.c_proj = nn.Linear(mlp_width, width)

    def forward(self, x: torch.Tensor, P: int, T: int) -> torch.Tensor:
        B, _, D = x.shape
        # temporal: per patch over the frames, residual through temporal_dense
        t = self.temporal_attn(self.temporal_ln(x[:, 1:].reshape(B * P, T, D)))
        tok = x[:, 1:] + self.temporal_dense(t.reshape(B, P * T, D))
        # spatial: per frame over the patches, the incoming cls on every frame
        cls_init = x[:, :1]
        sp = tok.reshape(B, P, T, D).transpose(1, 2).reshape(B * T, P, D)
        sp = torch.cat([cls_init.repeat_interleave(T, dim=0).to(sp.dtype), sp], dim=1)
        s = self.attn(self.ln_before(sp))
        cls_out = s[:, 0].reshape(B, T, D).mean(dim=1, keepdim=True)
        res = s[:, 1:].reshape(B, T, P, D).transpose(1, 2).reshape(B, P * T, D)
        h = torch.cat([cls_init, tok], dim=1) + torch.cat([cls_out, res], dim=1)
        return h + self.c_proj(F.gelu(self.c_fc(self.ln_after(h))))


class TimeSformerEncoder(nn.Module):
    """[B, T, H, W, 3] -> [B, width] (the final-LN class token) or, with
    ``return_cls=False``, the [B, 1 + P T, width] sequence."""

    def __init__(self, width: int = 768, layers: int = 12, heads: int = 12,
                 patch_size: int = 16, frames: int = 8, image_size: int = 224,
                 mlp_width: int = 3072, eps: float = 1e-6):
        super().__init__()
        self.frames = frames
        self.patch_embed = nn.Conv2d(3, width, patch_size, stride=patch_size)
        self.cls_token = nn.Parameter(torch.zeros(width))
        self.position_embedding = nn.Parameter(
            torch.zeros((image_size // patch_size) ** 2 + 1, width))
        self.time_embedding = nn.Parameter(torch.zeros(frames, width))
        self.layers = nn.ModuleList(
            TimeSformerBlock(width, heads, mlp_width, eps) for _ in range(layers))
        self.ln_post = nn.LayerNorm(width, eps=eps)

    def forward(self, video: torch.Tensor, return_cls: bool = True) -> torch.Tensor:
        B, T, H, W, C = video.shape
        if T != self.frames:
            raise ValueError(f"expected {self.frames} frames, got {T}")
        x = self.patch_embed(video.reshape(B * T, H, W, C).permute(0, 3, 1, 2))
        D = x.shape[1]
        x = x.flatten(2).transpose(1, 2)  # [B T, P, D]
        P = x.shape[1]
        pos = self.position_embedding.to(x.dtype)
        x = x.reshape(B, T, P, D) + pos[1:]
        # patch-major / frame-minor, then the time table per frame slot
        x = x.transpose(1, 2) + self.time_embedding.to(x.dtype)
        x = x.reshape(B, P * T, D)
        # the class token and its position added in f32 and rounded once, as JAX does
        cls = (self.cls_token.float() + self.position_embedding[0].float()).to(x.dtype)
        cls = cls.expand(B, 1, D)
        x = torch.cat([cls, x], dim=1)
        for layer in self.layers:
            x = layer(x, P, T)
        x = self.ln_post(x)
        return x[:, 0] if return_cls else x


def preprocess_clip(frames: torch.Tensor) -> torch.Tensor:
    """uint8 0-255 [..., H, W, 3] -> TimeSformer-normalized float32."""
    mean = torch.tensor(TIMESFORMER_PIXEL_MEAN, device=frames.device)
    std = torch.tensor(TIMESFORMER_PIXEL_STD, device=frames.device)
    return (frames.float() / 255.0 - mean) / std
