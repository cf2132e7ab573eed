"""Non-blocking metrics logging (counterpart of
temporalalignnet_tpu/utils/logging.py; reference
utils/tensorboard_utils.py:76-110, the tensorboardX PlotterThread).

``MetricsWriter`` queues scalar writes for a daemon thread, so logging never
blocks the train step: one JSON line per ``add_scalars`` call in
``<logdir>/<name>.metrics.jsonl`` always (``name``: ``train``, or ``e2e``
for the end-to-end trainer), and TensorBoard events under
``<logdir>/<name>/`` when ``tensorboardX`` imports (an optional extra, not a
dependency; ``torch.utils.tensorboard`` is not used, since it imports
TensorFlow where that is installed).  Under a process group only rank 0
writes: the other ranks' writers take the calls and write nothing.

``Logger`` tees console lines into a file and ``denormalize`` undoes the
ImageNet normalization for display (reference utils/utils.py:124-136,
:73-86).
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from typing import Dict

import numpy as np

from temporalalignnet_torch.parallel.distributed import is_master


class MetricsWriter:
    """Queue-backed scalar writer; one JSONL line per add_scalars call."""

    def __init__(self, logdir: str, name: str = "train"):
        self.path = os.path.join(logdir, f"{name}.metrics.jsonl")
        self.enabled = is_master()
        if not self.enabled:
            return
        os.makedirs(logdir, exist_ok=True)
        self._file = open(self.path, "a", buffering=1)
        try:
            from tensorboardX import SummaryWriter  # optional

            self._tb = SummaryWriter(logdir=os.path.join(logdir, name), flush_secs=60)
        except Exception:
            self._tb = None
        self._q: queue.Queue = queue.Queue(maxsize=128)
        self._running = True
        self._thread = threading.Thread(target=self._drain, daemon=True)
        self._thread.start()

    def add_scalars(self, step: int, scalars: Dict[str, float], prefix: str = "") -> None:
        if not self.enabled:
            return
        payload = {"step": int(step), "time": time.time(),
                   **{f"{prefix}{k}": float(v) for k, v in scalars.items()}}
        try:
            self._q.put_nowait(payload)
        except queue.Full:
            pass  # drop rather than block the step (the PlotterThread contract)

    def _drain(self) -> None:
        while self._running or not self._q.empty():
            try:
                payload = self._q.get(timeout=0.25)
            except queue.Empty:
                continue
            self._file.write(json.dumps(payload) + "\n")
            if self._tb is not None:
                for k, v in payload.items():
                    if k not in ("step", "time"):
                        self._tb.add_scalar(k, v, payload["step"])

    def close(self) -> None:
        """Writes what is queued, then closes the sinks."""
        if not self.enabled:
            return
        self._running = False
        self._thread.join(timeout=5)
        self._file.close()
        if self._tb is not None:
            self._tb.close()


class Logger:
    """Tee console lines into a log file (reference utils/utils.py:124-136)."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = path
        self._file = open(path, "a", buffering=1)

    def log(self, msg: str) -> None:
        print(msg, flush=True)
        self._file.write(msg + "\n")

    def close(self) -> None:
        self._file.close()


def denormalize(frames, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225)) -> np.ndarray:
    """Undo ImageNet normalization on [..., H, W, 3] float frames, clipped to
    [0, 1] (reference utils/utils.py:73-86, channel-last here)."""
    frames = np.asarray(frames, np.float32)
    return np.clip(frames * np.asarray(std) + np.asarray(mean), 0.0, 1.0)
