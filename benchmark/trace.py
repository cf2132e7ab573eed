"""A device trace of a short steady slice of a cell's units, and what the
per-layer metrics read from it.

``profile_slice(units, dispatch, sync)`` runs ``units`` units under
``torch.profiler`` with CUDA activity only (recording every host operation
as well would slow a host-bound cell's host two- to threefold and so read
its idle share wrong) and returns a ``Slice``: every device operation
(kernels, copies, sets) as (name, start s, end s) and the slice's wall span
on the host's clock, from its first dispatch to the sync after its last.

A session that recorded no kernel, or not all of them, fails: each kernel
must appear a multiple of ``units`` times (each unit runs the same
kernels), and the device operations must cover the span that CUDA events
timed around the slice to within 10 %.  A failed session is tried again,
at most ``TRIES`` times in all; then the run fails.  Nothing falls back to
another source.

What the host was doing in each idle gap comes from one more unit traced
with host operations too (``host_labels``): the host operation that
launched the kernel which ends the gap.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import torch

TRIES = 3
_MANGLED = re.compile(r"_Z(?:N)?(\d+)")
_ANON = "(anonymous namespace)::"


class TraceError(RuntimeError):
    pass


def kernel_name(name: str) -> str:
    """A kernel's bare function name: the profiler's demangled name without
    its return type, namespaces, template arguments and parameters (or the
    first identifier of a mangled name)."""
    m = _MANGLED.match(name)
    if m:
        return name[m.end():m.end() + int(m.group(1))]
    if name.startswith("void "):
        name = name[5:]
    name = name.replace(_ANON, "")
    cut = min((i for i in (name.find("<"), name.find("(")) if i >= 0), default=len(name))
    return name[:cut].rsplit("::", 1)[-1]


@dataclass
class Slice:
    units: int
    span_s: float
    device_ops: List[Tuple[str, float, float]]  # (name, start, end) in seconds
    labels: Dict[str, str] = field(default_factory=dict)  # kernel -> launching host op

    @property
    def kernels(self) -> List[Tuple[str, float, float]]:
        return [op for op in self.device_ops if not op[0].startswith(("Memcpy", "Memset"))]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals, sorted."""
        out: List[List[float]] = []
        for _, s, e in sorted(self.device_ops, key=lambda op: op[1]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def device_time(self, prefixes: Tuple[str, ...]) -> float:
        """Seconds of the kernels whose name starts with one of ``prefixes``."""
        return sum(e - s for n, s, e in self.kernels if kernel_name(n).startswith(prefixes))

    def top_ops(self, k: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for n, s, e in self.device_ops:
            by[n] = by.get(n, 0.0) + (e - s)
        return [[n[:120], v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[List]:
        """The longest gaps between device operations, each named by the host
        operation that launched the operation ending it."""
        ops = sorted(self.device_ops, key=lambda op: op[1])
        gaps, end = [], None
        for n, s, e in ops:
            if end is not None and s > end:
                gaps.append((s - end, n))
            end = e if end is None else max(end, e)
        gaps.sort(key=lambda g: -g[0])
        return [[f"{self.labels.get(n, 'launch')} -> {kernel_name(n)}"[:120], g]
                for g, n in gaps[:k]]


def _session(units: int, dispatch: Callable[[int], None], sync: Callable[[], None]) -> Slice:
    from torch.profiler import ProfilerActivity, profile

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        start.record()
        for i in range(units):
            dispatch(i)
        end.record()
        sync()
        span = time.perf_counter() - t0
    timed = start.elapsed_time(end) / 1e3
    device = [(ev.name, ev.time_range.start / 1e6, ev.time_range.end / 1e6)
              for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA
              and ev.time_range.end > ev.time_range.start]
    sl = Slice(units, span, device)
    if not sl.kernels:
        raise TraceError("the profiler recorded no kernel")
    counts: Dict[str, int] = {}
    for n, _, _ in sl.kernels:
        counts[n] = counts.get(n, 0) + 1
    odd = {n: c for n, c in counts.items() if c % units}
    if odd:
        raise TraceError(f"kernels recorded a number of times that {units} units do not divide "
                         f"(lost activity): {list(odd.items())[:4]}")
    first = min(s for _, s, _ in device)
    last = max(e for _, _, e in device)
    if last - first < 0.9 * timed:
        raise TraceError(f"the device operations span {last - first:.6f} s of the {timed:.6f} s "
                         "that CUDA events timed (lost activity)")
    return sl


def host_labels(dispatch: Callable[[int], None], sync: Callable[[], None]) -> Dict[str, str]:
    """{kernel name: the innermost host operation that launched it} over one
    unit traced with host operations."""
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        dispatch(0)
        sync()
    labels: Dict[str, str] = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CPU:
            for k in ev.kernels:
                labels.setdefault(k.name, ev.name)
    return labels


def profile_slice(units: int, dispatch: Callable[[int], None],
                  sync: Callable[[], None]) -> Slice:
    errors = []
    for _ in range(TRIES):
        try:
            sl = _session(units, dispatch, sync)
            break
        except TraceError as e:
            errors.append(str(e))
    else:
        raise TraceError(f"{TRIES} profiler sessions failed: {errors}")
    sl.labels = host_labels(lambda i: dispatch(units + i), sync)
    return sl
