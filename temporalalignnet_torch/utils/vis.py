"""Visualization and inspection helpers (counterpart of
temporalalignnet_tpu/utils/vis.py; reference utils/utils.py:315-330,
train/loss.py:426-514).  matplotlib is imported only inside
``save_similarity_heatmap``, which returns None where it is missing."""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def second_to_time(secs: float) -> str:
    """seconds -> 'hh:mm:ss' (utils/utils.py:323-330)."""
    secs = int(secs)
    h, rem = divmod(secs, 3600)
    m, s = divmod(rem, 60)
    return f"{h:02d}:{m:02d}:{s:02d}"


def get_youtube_link(vid: str, start: Optional[float] = None) -> str:
    """The video's YouTube URL, at ``start`` seconds (utils/utils.py:315-320)."""
    url = f"https://www.youtube.com/watch?v={vid}"
    if start is not None:
        url += f"&t={int(start)}"
    return url


def save_similarity_heatmap(
    sim: np.ndarray,  # [N_text, T]
    out_path: str,
    gt_spans: Optional[Sequence] = None,  # [(start, end), ...] per sentence
    texts: Optional[Sequence[str]] = None,
    title: str = "",
) -> Optional[str]:
    """The sentence-by-time similarity heatmap with the ground-truth spans
    drawn over it (the reference keeps it behind an ``if False:`` debug
    block, train/loss.py:375-421).  Returns the written path, or None
    without matplotlib."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None

    n, t = sim.shape
    fig, ax = plt.subplots(figsize=(min(16, t / 8 + 2), min(8, n / 2 + 2)))
    im = ax.imshow(sim, aspect="auto", interpolation="nearest", cmap="viridis")
    if gt_spans is not None:
        for i, (s, e) in enumerate(gt_spans):
            ax.plot([s, e], [i, i], color="red", linewidth=2)
    if texts is not None:
        ax.set_yticks(range(n))
        ax.set_yticklabels([str(x)[:40] for x in texts], fontsize=6)
    ax.set_xlabel("time (s)")
    ax.set_title(title)
    fig.colorbar(im)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_path
