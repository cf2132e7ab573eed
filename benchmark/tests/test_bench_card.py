"""The cells on the card (``cuda``): each runs briefly through ``run.py``,
traced, and proves correct, with every per-layer metric of the cell and
every share at most 100 %."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
CELLS = [c["name"] for c in harness.manifest()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                          "4242424242", "--seconds", "3", "--trace", "1"], cwd=str(ROOT),
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["busy_s"] > 0
    wl = harness.workload_of(cell)
    expected = harness.cell_metrics(harness.manifest(), cell, wl["rate"]["metric"])["per_layer"]
    assert set(line["metrics"]) == {m["name"] for m in expected}
    for name, m in line["metrics"].items():
        if "roofline" in name or "mfu" in name:
            assert 0 < m["value"] <= 100.0, (name, m)
