"""Fixed-shape padding helpers (numpy).

The reference pads video batches by repeating the last timestep
(pad_sequence_by_last, data/loader_htm.py:13-23) and pads token lists to a
fixed width (pad_sequence_to_size, loader_htm.py:26-37).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def pad_video_by_last(feature: np.ndarray, length: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pad/truncate [t, C] to [length, C] by repeating the final frame.
    Returns (video, padding_mask) with the mask True on padded rows."""
    t = feature.shape[0]
    if t >= length:
        return feature[:length], np.zeros(length, bool)
    if t == 0:
        raise ValueError("cannot pad an empty feature window")
    pad = np.repeat(feature[-1:], length - t, axis=0)
    mask = np.zeros(length, bool)
    mask[t:] = True
    return np.concatenate([feature, pad], axis=0), mask


def pad_tokens(tokens: np.ndarray, max_words: int) -> np.ndarray:
    """Pad/truncate a 1-D token id array to max_words with 0."""
    out = np.zeros(max_words, tokens.dtype if tokens.size else np.int32)
    n = min(len(tokens), max_words)
    out[:n] = tokens[:n]
    return out
