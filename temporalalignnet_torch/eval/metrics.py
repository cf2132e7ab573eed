"""Eval metrics in plain numpy (copy of temporalalignnet_tpu/eval/metrics.py).

- roc_auc_score: rank-based AUC with average ranks for ties, numerically equal
  to sklearn.metrics.roc_auc_score (used at eval_zeroshot_align.py:248).
- retrieval_metrics: R@1/R@5/R@10/MedianRank of the diagonal
  (eval_zeroshot_retrieval.py:13-26).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def roc_auc_score(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """AUC = P(score_pos > score_neg) + 0.5 P(tie), via the Mann-Whitney U
    statistic with midranks."""
    y_true = np.asarray(y_true).astype(bool).ravel()
    y_score = np.asarray(y_score, np.float64).ravel()
    n_pos = int(y_true.sum())
    n_neg = y_true.size - n_pos
    if n_pos == 0 or n_neg == 0:
        raise ValueError("roc_auc_score needs both classes present")
    order = np.argsort(y_score, kind="mergesort")
    sorted_scores = y_score[order]
    # midranks (1-based), averaged over tie groups
    ranks = np.empty(y_score.size, np.float64)
    i = 0
    while i < y_score.size:
        j = i
        while j + 1 < y_score.size and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i : j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    u = ranks[y_true].sum() - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def retrieval_metrics(sim: np.ndarray, prefix: str = "") -> Dict[str, float]:
    """Diagonal-rank retrieval metrics: sim [Q, G], ground truth on the diagonal.
    rank[i] = number of entries in row i strictly greater than sim[i, i]."""
    sim = np.asarray(sim)
    if sim.shape[0] != sim.shape[1]:
        raise ValueError(f"retrieval_metrics needs a square sim, got {sim.shape}")
    ranks = (sim > np.diag(sim)[:, None]).sum(axis=1)
    return {
        f"{prefix}R1": float((ranks == 0).mean()),
        f"{prefix}R5": float((ranks < 5).mean()),
        f"{prefix}R10": float((ranks < 10).mean()),
        f"{prefix}MR": float(np.median(ranks) + 1),
    }
