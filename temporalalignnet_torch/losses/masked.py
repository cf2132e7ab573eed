"""Masked statistics with fixed shapes (counterpart of
temporalalignnet_tpu/losses/masked.py).

The reference compresses tensors with boolean indexing (``x[~text_padding_mask]``,
train/loss.py:192,241,286); these compute the same statistics over a
fixed-shape tensor and a validity mask.
"""

from __future__ import annotations

import torch


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim=None) -> torch.Tensor:
    """Mean of x over the elements where mask is True."""
    m = mask.to(x.dtype)
    if dim is None:
        return (x * m).sum() / m.sum().clamp(min=1.0)
    return (x * m).sum(dim) / m.sum(dim).clamp(min=1.0)


def masked_std(x: torch.Tensor, mask: torch.Tensor, ddof: int = 1) -> torch.Tensor:
    """Std over the masked elements; ddof=1 is torch.std's default (loss.py:281)."""
    m = mask.to(x.dtype)
    n = m.sum()
    sq = (((x - masked_mean(x, mask)) ** 2) * m).sum()
    return torch.sqrt(sq / (n - ddof).clamp(min=1.0))


def masked_quantile(x: torch.Tensor, mask: torch.Tensor, q: float) -> torch.Tensor:
    """torch.quantile(x[mask], q) with linear interpolation, fixed shape:
    invalid entries sort to +inf at the tail, and the quantile sits at
    position q·(n-1) of the n valid ones.  The two entries are read with
    ``take``: indexing by a 0-d tensor would copy the index to the host and
    wait for the device."""
    x = x.reshape(-1).float()
    mask = mask.reshape(-1)
    xs = torch.sort(torch.where(mask, x, torch.full_like(x, float("inf")))).values
    n_max = (mask.sum() - 1).clamp(min=0)
    pos = q * n_max.float()
    lo = pos.floor().long()
    hi = torch.minimum(lo + 1, n_max)
    frac = pos - lo.float()
    return xs.take(lo) * (1.0 - frac) + xs.take(hi) * frac
