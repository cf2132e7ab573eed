"""Console meters (counterpart of temporalalignnet_tpu/utils/meters.py;
reference utils/utils.py:139-231): ``AverageMeter`` keeps a global average
and a sliding local window, ``ProgressMeter`` prints one status line per log
step, to stderr: the trainer's stdout carries only its JSON lines."""

from __future__ import annotations

import collections
import sys
from typing import Iterable


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
