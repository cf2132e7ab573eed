"""Packed video-feature tables for the evaluators.

Unique videos go to the device once, packed at true length into one [R, C]
row table that the evaluator gathers windows from by per-video row offsets.
A bf16 model gets a bf16 table: its first projection casts to bf16 either
way, so casting on the host first changes nothing but halves the bytes.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pack_video_table(
    videos: Sequence[np.ndarray],  # each [vlen_i, C] float
    dtype: torch.dtype = torch.float32,  # the model's compute dtype
    round_rows_to: int = 8,
) -> Tuple[torch.Tensor, np.ndarray]:
    """Concatenate true-length videos into one [R, C] CPU tensor of ``dtype``.
    Returns (table, offsets [len(videos)] int32); ``round_rows_to`` pads the
    total row count only."""
    offs, off = [], 0
    for v in videos:
        offs.append(off)
        off += int(v.shape[0])
    table = np.zeros((_round_up(max(off, 1), round_rows_to), int(videos[0].shape[1])),
                     np.float32)
    for v, o in zip(videos, offs):
        table[o : o + v.shape[0]] = v
    return torch.from_numpy(table).to(dtype), np.asarray(offs, np.int32)
