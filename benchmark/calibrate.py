"""The readings a cell's correctness limits are set from, at the cell's own
size, several seeds in one process (the benchmark's runs do not run this):

    python3 benchmark/calibrate.py --workload <cell> --seeds 11 12 13 [--seconds 2]
        [--control-seeds 3]

For each seed, one JSON line with:

- ``program``: the numbers a run compares, of the program's timed path
  against the float32 reference (the lower reading is their largest);
- on the first ``--control-seeds`` seeds, ``control``: the reference
  computed in float8 products put in the program's place (the nearest
  precision below the configuration's bf16), and the faults a cell can
  have: for training ``half_batch`` (the reference on the first half of
  each batch, its means over that half); for the eval forward
  ``stale_answer`` (each kept answer held against the reference of another
  batch).  A step that returns its state unchanged reads 1 on
  ``change_gap`` by the measure itself and needs no run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
if sys.path and Path(sys.path[0] or ".").resolve() == HERE:
    sys.path.pop(0)
sys.path.insert(0, str(HERE.parent))

import torch  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.drivers.tan_infer import answer_gaps  # noqa: E402
from benchmark.reference.common import leaf_report, training_numbers  # noqa: E402


def readings(cell: str, seed: int, seconds: float, control: bool) -> dict:
    man = harness.manifest()
    entry = harness.find(man["workloads"], cell, "cell")
    cfg = harness.config_of(man, entry)
    wl = harness.workload_of(cell)
    drv = harness.driver_class(wl["driver"])(cfg, wl, seed, torch.device("cuda"))
    drv.setup()
    start, units = time.perf_counter(), 0
    while time.perf_counter() - start < seconds:
        drv.dispatch(units)
        units += 1
    drv.sync()
    drv.release()
    out = {"cell": cell, "seed": seed, "units": units}
    if wl["driver"] == "tan_infer":
        ref = drv.reference("f32")
        out["program"] = answer_gaps(drv.kept, ref) if drv.kept else None
        if control:
            fp8 = drv.reference("fp8")
            out["control"] = answer_gaps([(i, fp8[i]) for i, _ in drv.kept], ref)
            P = len(drv.pool)
            stale = [((i - 1) % P, o) for i, o in drv.kept]  # the previous call's batch
            out["stale_answer"] = answer_gaps(stale, drv.reference("f32", {i for i, _ in stale}))
        return out
    ref = drv.reference("f32")
    out["program"] = training_numbers(drv.prog, ref)
    out["program_losses"], out["reference_losses"] = drv.prog["losses"], ref["losses"]
    out["program_leaves"] = leaf_report(drv.prog, ref)
    if control:
        fp8 = drv.reference("fp8")
        out["control"] = training_numbers(fp8, ref)
        out["control_leaves"] = leaf_report(fp8, ref)
        out["half_batch"] = training_numbers(drv.reference("f32", half=True), ref)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--out", default=None, help="also append the lines to this file")
    args = p.parse_args(argv)
    harness.cache_dirs(harness.checkout())
    if not torch.cuda.is_available():
        raise harness.Refused("no CUDA device: the readings are the card's")
    for i, seed in enumerate(args.seeds):
        line = json.dumps(readings(args.workload, seed, args.seconds, i < args.control_seeds))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
