"""The benchmark's driver: one cell, one seed, one run.

Everything a cell is made of is found by name from ``BENCHMARK.json`` at the
checkout's root:

- the cell's configuration ``configs/<config>.json`` (under this folder,
  the file that ``BENCHMARK.json`` names);
- its workload ``workloads/<cell>.json``: the program driver it runs
  (``drivers/<driver>.py``), the traffic, the end-to-end rate it reports
  and the limits of its correctness check;
- each per-layer metric ``metrics/<metric>.py``, a ``read(run)`` that
  returns a number or None.

A run builds the cell's program from the seed, drives its first steps and
warms up every shape it uses (the set-up, ``setup_s``), measures for
``--seconds``, then, with ``--trace 1``, profiles a short steady slice.
Once the window has closed it reads the peak memory, frees the program,
runs the plain reference and prints the checks on standard error and, last
on standard output, one JSON line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "temporalalignnet_tpu")


class Refused(SystemExit):
    """A run that prints no result: the message goes to standard error."""

    def __init__(self, msg: str):
        print(msg, file=sys.stderr, flush=True)
        super().__init__(2)


# ------------------------------------------------------------------ discovery


def checkout(bench_dir: Path = BENCH_DIR) -> Path:
    return bench_dir.parent


def manifest(bench_dir: Path = BENCH_DIR) -> dict:
    path = checkout(bench_dir) / "BENCHMARK.json"
    if not path.exists():
        raise Refused(f"no {path.name} beside {bench_dir.name}/")
    return json.loads(path.read_text())


def find(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise Refused(f"no {what} {name!r} in BENCHMARK.json")


def config_of(man: dict, cell: dict, bench_dir: Path = BENCH_DIR) -> dict:
    entry = find(man["configs"], cell["config"], "configuration")
    return json.loads((checkout(bench_dir) / entry["file"]).read_text())


def workload_of(cell_name: str, bench_dir: Path = BENCH_DIR) -> dict:
    path = bench_dir / "workloads" / f"{cell_name}.json"
    if not path.exists():
        raise Refused(f"cell {cell_name!r} has no {path.relative_to(bench_dir.parent)}")
    return json.loads(path.read_text())


def _load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, bench_dir: Path = BENCH_DIR):
    path = bench_dir / "metrics" / f"{metric}.py"
    if not path.exists():
        raise Refused(f"per-layer metric {metric!r} has no reader {path.name}")
    return _load_file(path, "bench_metric_" + metric.replace(".", "_").replace("-", "_")).read


def driver_class(name: str):
    importlib.import_module(f"{__package__}.drivers")
    mod = importlib.import_module(f"{__package__}.drivers.{name}")
    return mod.Driver


def reports(entry: dict, cell_name: str, cell_e2e: List[str]) -> bool:
    """Whether a metric of BENCHMARK.json belongs to the cell: by its
    ``workloads``, or, without them, by the end-to-end metric it moves."""
    if "workloads" in entry:
        return cell_name in entry["workloads"]
    return entry.get("moves", entry["name"]) in cell_e2e


def cell_metrics(man: dict, cell_name: str, rate: str) -> Dict[str, List[dict]]:
    e2e = [m for m in man["end_to_end"]
           if m["name"] == "setup_s" or m["name"] == rate
           or ("workloads" in m and cell_name in m["workloads"])]
    names = [m["name"] for m in e2e]
    per_layer = [m for m in man["per_layer"] if reports(m, cell_name, names)]
    return {"end_to_end": e2e, "per_layer": per_layer}


def listing(bench_dir: Path = BENCH_DIR) -> dict:
    """Every cell with its configuration, driver and metrics."""
    man = manifest(bench_dir)
    cells = {}
    for cell in man["workloads"]:
        wl = workload_of(cell["name"], bench_dir)
        config_of(man, cell, bench_dir)
        ms = cell_metrics(man, cell["name"], wl["rate"]["metric"])
        for m in ms["per_layer"]:
            reader(m["name"], bench_dir)
        cells[cell["name"]] = {
            "config": cell["config"], "driver": wl["driver"],
            "end_to_end": [m["name"] for m in ms["end_to_end"]],
            "per_layer": [m["name"] for m in ms["per_layer"]]}
    return {"configs": [c["name"] for c in man["configs"]], "cells": cells}


# ------------------------------------------------------------------ the run


class Run:
    """What a per-layer metric's ``read(run)`` sees."""

    def __init__(self, window_s: float, units: int, peaks: Dict[str, float], driver, sl):
        self.window_s, self.units, self.peaks, self.slice = window_s, units, peaks, sl
        self._driver = driver

    def mfu(self) -> float:
        """% of the bf16 peak that the window's model FLOPs make."""
        flops = self._driver.flops_per_unit() * self.units
        return 100.0 * flops / self.window_s / self.peaks["bf16_flops"]

    def idle_pct(self) -> Optional[float]:
        """% of the window's wall time in which no device operation ran: the
        traced slice's device time a unit (the union of its operations'
        intervals), times the window's units, against the window's time.
        The slice's own span is not the divisor: under the profiler each
        kernel costs the host and the device more, so the slice runs slower
        than the window it stands for."""
        if self.slice is None:
            return None
        busy = self.slice.busy_s / self.slice.units * self.units
        return 100.0 * (1.0 - busy / self.window_s)

    def roofline_pct(self, family: str, prefixes) -> Optional[float]:
        """The slice's bound for the kernels of ``family`` over the device
        time of the kernels named with ``prefixes``; None where none ran."""
        if self.slice is None:
            return None
        bound = self._driver.kernel_bounds(self.peaks).get(family)
        spent = self.slice.device_time(tuple(prefixes))
        if not bound or spent <= 0:
            return None
        return 100.0 * bound * self.slice.units / spent


def _power_limit() -> Optional[float]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True, text=True,
                             timeout=30)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    base = root / "build" / "bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", help="the cell's name in BENCHMARK.json")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seconds", type=float, default=None,
                   help="the measured window (default: BENCHMARK.json's run_seconds)")
    p.add_argument("--trace", type=int, default=0, choices=(0, 1))
    p.add_argument("--list", action="store_true", help="list the cells and metrics found")
    return p.parse_args(argv)


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, t0: float,
             device: str = "cuda", bench_dir: Path = BENCH_DIR,
             config_override: Optional[dict] = None, workload_override: Optional[dict] = None
             ) -> dict:
    """One run of the cell; returns the result line's object.  ``device``
    'cpu' and the overrides serve the CPU tests (tiny shapes, no card)."""
    import torch

    from .trace import profile_slice
    from .work import card_peaks

    man = manifest(bench_dir)
    cell = find(man["workloads"], cell_name, "cell")
    cfg = {**config_of(man, cell, bench_dir), **(config_override or {})}
    wl = workload_of(cell_name, bench_dir)
    if workload_override:
        wl = {**wl, **workload_override}
    metrics_of = cell_metrics(man, cell_name, wl["rate"]["metric"])
    cuda = device == "cuda"
    imported = time.time() - t0
    if cuda:
        torch.cuda.set_device(0)
        torch.zeros(1, device=device)
        torch.cuda.synchronize()
    drv = driver_class(wl["driver"])(cfg, wl, seed, torch.device(device))
    context = time.time() - t0 - imported
    drv.setup()
    drv.sync()
    setup_s = time.time() - t0
    print(f"setup {setup_s:.3f} s: imports {imported:.3f}, cuda context {context:.3f}, "
          + ", ".join(f"{n} {s:.3f}" for n, s in drv.marks.items), file=sys.stderr)
    units = 0
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        drv.dispatch(units)
        units += 1
    drv.sync()
    window_s = time.perf_counter() - start
    print(f"window {units} units in {window_s:.4f} s", file=sys.stderr)
    sl = None
    if trace:
        sl = profile_slice(wl["trace_units"], lambda i: drv.dispatch(units + i), drv.sync)
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    bad = forbidden_modules()
    if bad:
        raise Refused(f"modules of JAX or of the JAX package are loaded: {bad}")
    failed = drv.failed()
    drv.release()
    limits = wl["limits"]  # the numbers this cell compares
    checks = {k: v for k, v in drv.check().items() if k in limits}
    correct = set(checks) == set(limits) and all(
        math.isfinite(v) and v <= limits[k] for k, v in checks.items())
    rate = wl["rate"]
    items = units * rate["per_unit"]
    units_of = {m["name"]: m["unit"] for m in man["end_to_end"] + man["per_layer"]}
    metrics = {}
    if not trace:
        for m in metrics_of["end_to_end"]:
            if m["name"] == "setup_s":
                value = setup_s
            elif m["name"] == rate["metric"]:
                value = items / window_s
            else:
                continue
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        peaks = card_peaks(torch.cuda.get_device_name(0)) if cuda else {
            "hbm_bytes_per_s": 3.35e12, "bf16_flops": 989e12}
        run = Run(window_s, units, peaks, drv, sl)
        for m in metrics_of["per_layer"]:
            value = reader(m["name"], bench_dir)(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units_of[m["name"]]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": memory_peak}
    if cuda:
        dev["power_limit_w"] = _power_limit()
    out = {"correct": correct, "attempted": items, "failed": failed,
           "metrics": metrics, "device": dev}
    if sl is not None:
        dev["busy_s"] = sl.busy_s
        dev["window_s"] = sl.span_s
        out["breakdown"] = {"device_ops": sl.top_ops(10), "idle_gaps": sl.idle_gaps(10)}
    out["checks"] = {k: {"value": v, "limit": limits[k]} for k, v in checks.items()}
    return out


def main(argv=None, t0: Optional[float] = None) -> int:
    t0 = time.time() if t0 is None else t0
    args = parse(argv)
    if args.list:
        print(json.dumps(listing(), indent=1))
        return 0
    if not args.workload:
        raise Refused("--workload is required")
    man = manifest()
    cell = find(man["workloads"], args.workload, "cell")
    cache_dirs(checkout())
    try:
        import torch
    except ImportError as e:
        raise Refused(f"no torch: {e}") from None
    try:
        import temporalalignnet_torch  # noqa: F401  the program under test
    except ImportError as e:
        raise Refused(f"the program is not in this checkout: {e}") from None
    if not torch.cuda.is_available():
        raise Refused("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < cell["chips"]:
        raise Refused(f"cell {cell['name']} needs {cell['chips']} cards, "
                      f"{torch.cuda.device_count()} here")
    seconds = man["run_seconds"] if args.seconds is None else args.seconds
    out = run_cell(args.workload, args.seed, seconds, bool(args.trace), t0)
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
