"""Console meters (counterpart of temporalalignnet_tpu/utils/meters.py;
reference utils/utils.py:139-231): ``AverageMeter`` keeps a global average
and a sliding local window, ``ProgressMeter`` prints one status line per log
step, to stderr: the trainer's stdout carries only its JSON lines.
``calc_topk_accuracy`` and ``ConfusionMeter`` score classifiers
(utils.py:89-114, :234-285)."""

from __future__ import annotations

import collections
import sys
from typing import Iterable, List

import numpy as np


class AverageMeter:
    """Running average and local sliding-window average (utils.py:139-214)."""

    def __init__(self, name: str, fmt: str = ":f", window: int = 30):
        self.name = name
        self.fmt = fmt
        self.window = window
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self.history: collections.deque = collections.deque(maxlen=self.window)

    def update(self, val: float, n: int = 1) -> None:
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.history.append(float(val))

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)

    @property
    def local_avg(self) -> float:
        return sum(self.history) / max(len(self.history), 1)

    def __str__(self) -> str:
        fmtstr = "{name} {val" + self.fmt + "} ({avg" + self.fmt + "})"
        return fmtstr.format(name=self.name, val=self.val, avg=self.avg)


def calc_topk_accuracy(scores, targets, topk=(1,)) -> List[float]:
    """Fraction of rows whose target is among the top-k scores, for each k
    (utils.py:89-114); numpy, [B, C] scores and [B] targets."""
    scores, targets = np.asarray(scores), np.asarray(targets)
    order = np.argsort(-scores, axis=1)
    return [float((order[:, :k] == targets[:, None]).any(axis=1).mean()) for k in topk]


class ConfusionMeter:
    """Row = ground truth, column = prediction (utils.py:234-285)."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.mat = np.zeros((num_classes, num_classes), np.int64)

    def update(self, preds, targets) -> None:
        for p, t in zip(np.asarray(preds).reshape(-1), np.asarray(targets).reshape(-1)):
            self.mat[int(t), int(p)] += 1

    def accuracy(self) -> float:
        total = self.mat.sum()
        return float(self.mat.trace() / total) if total else 0.0

    def __str__(self) -> str:
        return f"ConfusionMeter(acc={self.accuracy():.4f})\n{self.mat}"


class ProgressMeter:
    """Batched status line printer (utils.py:217-231)."""

    def __init__(self, num_batches: int, meters: Iterable[AverageMeter], prefix: str = ""):
        num_digits = len(str(num_batches // 1))
        self.batch_fmtstr = "{:" + str(num_digits) + "d}/" + str(num_batches)
        self.meters = list(meters)
        self.prefix = prefix

    def display(self, batch: int) -> str:
        entries = [self.prefix + self.batch_fmtstr.format(batch)]
        entries += [str(m) for m in self.meters]
        line = "\t".join(entries)
        print(line, flush=True, file=sys.stderr)
        return line
