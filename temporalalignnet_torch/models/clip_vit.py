"""CLIP ViT image tower for the feature extractor (counterpart of
temporalalignnet_tpu/models/clip_vit.py; the reference's htm_zoo extractor
wraps torch CLIP, htm_zoo/visual/extract_feature_template.py:236-307).

Patch embedding (a bias-free strided conv), class token, learned positions,
``ln_pre``, the pre-LN blocks of ``models/transformer.py`` (the checkpoint's
``hidden_act``), ``ln_post`` on the class token and a bias-free projection
(``embed_dim`` 0: none).  Input channel-last [B, H, W, 3], as in JAX.  Its
attention (S = 50 at B/32, 257 at L/14) has no mask and goes through
``ops.attention.multihead_attention``: on the card the Hopper ``mha_fwd``.
Weights in HF's CLIPVisionModel key space go through
``checkpoint/clip_convert.py``.  Defaults are ViT-B/32 (width 768, 12 x 12,
patch 32, 224², projection 512).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from temporalalignnet_torch.models.transformer import ResidualAttentionBlock

# CLIP's published pixel normalization (clip.load's transform)
CLIP_PIXEL_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_PIXEL_STD = (0.26862954, 0.26130258, 0.27577711)


class CLIPImageEncoder(nn.Module):
    """[B, H, W, 3] -> [B, embed_dim]."""

    def __init__(self, width: int = 768, layers: int = 12, heads: int = 12, patch_size: int = 32,
                 image_size: int = 224, embed_dim: int = 512, hidden_act: str = "quick_gelu"):
        super().__init__()
        self.patch_embed = nn.Conv2d(3, width, patch_size, stride=patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(width))
        self.position_embedding = nn.Parameter(
            torch.zeros((image_size // patch_size) ** 2 + 1, width))
        self.ln_pre = nn.LayerNorm(width, eps=1e-5)
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, act=hidden_act) for _ in range(layers))
        self.ln_post = nn.LayerNorm(width, eps=1e-5)
        self.proj = nn.Linear(width, embed_dim, bias=False) if embed_dim else None

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(images.permute(0, 3, 1, 2))  # [B, D, h, w]
        x = x.flatten(2).transpose(1, 2)  # patches row-major, as the JAX conv's reshape
        cls = self.class_embedding.to(x.dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.position_embedding.to(x.dtype)
        x = self.ln_pre(x)
        for block in self.resblocks:
            x, _ = block(x)
        x = self.ln_post(x[:, 0])
        return self.proj(x) if self.proj is not None else x


def preprocess_frames(frames: torch.Tensor) -> torch.Tensor:
    """uint8 0-255 [..., H, W, 3] -> CLIP-normalized float32 (channel-last)."""
    mean = torch.tensor(CLIP_PIXEL_MEAN, device=frames.device)
    std = torch.tensor(CLIP_PIXEL_STD, device=frames.device)
    return (frames.float() / 255.0 - mean) / std
