"""Synthetic HTM-Align-style eval corpora with known alignment.

Each video's feature inside a sentence's span is a noisy copy of a direction
tied to that sentence's tokens, so alignment is learnable and the metrics have
a known ceiling.  Same generator as temporalalignnet_tpu/data/synthetic.py, so
one seed gives both packages the same corpus.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def synthetic_video_corpus(
    rng: np.random.RandomState,
    num_videos: int = 4,
    min_len: int = 80,
    max_len: int = 200,
    feature_dim: int = 1024,
    vocab_size: int = 500,
    align_ratio: float = 0.6,
    signal: float = 1.0,
) -> List[Dict]:
    """Full-length videos with per-sentence (alignability, start, end, tokens)
    annotations (format: reference htm_align/readme.md:17-20)."""
    proj = np.random.RandomState(1234).randn(vocab_size, feature_dim).astype(np.float32)
    corpus = []
    for _ in range(num_videos):
        vlen = rng.randint(min_len, max_len + 1)
        video = rng.randn(vlen, feature_dim).astype(np.float32)
        n_sent = rng.randint(6, 14)
        bounds = np.sort(rng.choice(np.arange(4, vlen - 4), size=n_sent - 1, replace=False))
        spans = np.split(np.arange(vlen), bounds)
        sents = []
        for n in range(n_sent):
            words = rng.randint(1, vocab_size, size=rng.randint(3, 10))
            s, e = int(spans[n][0]), int(spans[n][-1] + 1)
            alignable = rng.rand() < align_ratio
            if alignable:
                direction = proj[words].mean(0)
                direction /= np.linalg.norm(direction) + 1e-6
                video[s:e] += signal * direction[None, :] * np.sqrt(feature_dim)
            sents.append(
                {"aligned": int(alignable), "start": float(s), "end": float(e), "tokens": words}
            )
        corpus.append({"video": video, "sentences": sents})
    return corpus
