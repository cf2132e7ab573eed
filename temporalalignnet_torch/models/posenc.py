"""Positional encodings (counterpart of temporalalignnet_tpu/models/posenc.py).

- the table-form sine embedding (reference model/tfm_model.py:137-148);
- the mask-driven sine embedding (reference model/tfm_model.py:106-134);
- linear interpolation of the positional table for eval windows whose length
  differs from the training length (reference model/tan_model.py:157-160,
  F.interpolate(mode='linear', align_corners=False)), with ``effective_len``
  for videos padded to a length bucket.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def sine_position_embedding(
    feature_dim: int = 512, num_features: int = 1024, temperature: float = 10000.0
) -> torch.Tensor:
    """[num_features, feature_dim] sine table."""
    pos = torch.arange(num_features, dtype=torch.float32)
    pos = pos / (pos[-1] + 1e-6) * (2 * math.pi)
    dim_t = torch.arange(feature_dim, dtype=torch.float32)
    dim_t = temperature ** (2 * torch.floor(dim_t / 2) / feature_dim)
    ang = pos[:, None] / dim_t
    # interleave sin of even channels with cos of odd channels
    emb = torch.stack((torch.sin(ang[:, 0::2]), torch.cos(ang[:, 1::2])), dim=2)
    return emb.reshape(num_features, feature_dim)


def position_embedding_sine_from_mask(
    padding_mask: torch.Tensor,  # [B, T] True = pad
    feature_dim: int = 512,
    temperature: float = 10000.0,
    normalize: bool = True,
) -> torch.Tensor:
    """[B, T, feature_dim] DETR-style 1-D sine embedding whose positions count
    only the valid steps (1 at the first), with ``normalize`` scaled so that
    each sequence's last valid step sits at 2π."""
    pos = torch.cumsum((~padding_mask.bool()).float(), dim=1)
    if normalize:
        pos = pos / (pos[:, -1:] + 1e-6) * (2 * math.pi)
    dim_t = torch.arange(feature_dim, dtype=torch.float32, device=pos.device)
    dim_t = temperature ** (2 * torch.floor(dim_t / 2) / feature_dim)
    ang = pos[:, :, None] / dim_t
    emb = torch.stack((torch.sin(ang[:, :, 0::2]), torch.cos(ang[:, :, 1::2])), dim=3)
    return emb.reshape(*pos.shape, feature_dim)


def linear_interpolate(
    table: torch.Tensor, out_len: int, effective_len: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """1-D linear resize along axis 0 with half-pixel centres.

    table [L_src, D] -> [out_len, D].  ``effective_len`` (a scalar or a [B]
    tensor) resizes onto the first effective_len rows of the output, for
    videos padded to a bucket: rows past it are garbage the caller masks.  A
    [B] tensor gives [B, out_len, D], one resize per video.
    """
    src_len = table.shape[0]
    grid = torch.arange(out_len, dtype=torch.float32, device=table.device) + 0.5
    if effective_len is None:
        coords = grid * (src_len / out_len) - 0.5
    else:
        eff = torch.as_tensor(effective_len, device=table.device).float()
        coords = grid * (src_len / eff)[..., None] - 0.5
    coords = coords.clamp(0.0, src_len - 1)
    lo = coords.floor().long()
    hi = (lo + 1).clamp(max=src_len - 1)
    w = (coords - lo.float())[..., None]
    return (table[lo] * (1.0 - w) + table[hi] * w).to(table.dtype)
