"""Per-step timing and profiling of the train loop (counterpart of
temporalalignnet_tpu/utils/profiling.py and its ``device_memory_stats``).

- ``StepTimer``: wall-clock steps/s with the first step (the kernels' build
  and warm-up) left out; the trainer logs it as ``device/sps`` (reference
  train/main.py:129).
- ``StepBreakdown``: the train loop fences every step on the loss's
  device-to-host copy, so an iteration's wall time splits exactly into
  ``data`` (waiting on the input pipeline), ``dispatch`` (the step's host
  code, which queues its kernels), ``fence`` (waiting for the card to finish
  the step) and ``other`` (logging, checkpoints); ``fence / wall`` is a lower
  bound of the card's duty cycle.  It adds no synchronisation of its own.
- ``trace(logdir)``: a ``torch.profiler`` session (CPU and, on a CUDA host,
  the card's kernels) around the block, written as a Chrome / Perfetto
  trace ``trace_<pid>.json`` under ``logdir``.
- ``device_memory_stats()``: bytes in use, peak and limit of the current
  CUDA device from ``torch.cuda.memory_stats`` (the keys JAX reads from
  ``Device.memory_stats``); empty without CUDA.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional


class StepTimer:
    """Wall-clock steps/s since the first step (the warm-up, left out)."""

    def __init__(self):
        self._count = 0
        self._t0 = 0.0
        self.last_sps = 0.0

    def tick(self) -> float:
        self._count += 1
        now = time.perf_counter()
        if self._count == 1:
            self._t0 = now
        elif now > self._t0:
            self.last_sps = (self._count - 1) / (now - self._t0)
        return self.last_sps


class StepBreakdown:
    """Shares of the loop's wall time: data, dispatch, fence and other."""

    def __init__(self):
        self._acc = {"data": 0.0, "dispatch": 0.0, "fence": 0.0}
        self._t0 = time.perf_counter()

    def add(self, kind: str, seconds: float) -> None:
        self._acc[kind] += seconds

    @contextlib.contextmanager
    def measure(self, kind: str) -> Iterator[None]:
        t = time.perf_counter()
        try:
            yield
        finally:
            self.add(kind, time.perf_counter() - t)

    def snapshot(self) -> Dict[str, float]:
        """Percentages since the last snapshot; resets the window."""
        now = time.perf_counter()
        wall = max(now - self._t0, 1e-9)
        out = {f"{k}_pct": 100.0 * v / wall for k, v in self._acc.items()}
        out["other_pct"] = max(0.0, 100.0 - sum(out.values()))
        out["duty_pct"] = out["fence_pct"]
        self._acc = dict.fromkeys(self._acc, 0.0)
        self._t0 = now
        return out


@contextlib.contextmanager
def trace(logdir: Optional[str]) -> Iterator[None]:
    """A torch.profiler session around the block, exported to
    ``<logdir>/trace_<pid>.json``; nothing when ``logdir`` is falsy."""
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}.json"))


def device_memory_stats() -> Dict[str, float]:
    """{bytes_in_use, peak_bytes_in_use, bytes_limit} of the current CUDA
    device; {} without CUDA."""
    import torch

    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return {}
    stats = torch.cuda.memory_stats()
    dev = torch.cuda.current_device()
    return {"bytes_in_use": float(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": float(stats.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": float(torch.cuda.get_device_properties(dev).total_memory)}
