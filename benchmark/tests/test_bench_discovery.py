"""The harness is driven by data: a cell, a configuration and a per-layer
metric added as files (and entries of BENCHMARK.json) in a copy of the
benchmark are found without an edit to any file that was there; without a
card, or without the program, a run exits non-zero and prints nothing."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


def _copy(tmp_path: Path) -> Path:
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return tmp_path


def _run(cwd: Path, *args, env_root=None):
    env = {"PATH": "/usr/bin:/bin", "HOME": str(cwd)}
    if env_root:
        env["PYTHONPATH"] = env_root
    return subprocess.run([sys.executable, "benchmark/run.py", *args], cwd=str(cwd), env=env,
                          capture_output=True, text=True, timeout=300)


def test_new_files_are_found_without_edits(tmp_path):
    root = _copy(tmp_path)
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    bench = root / "benchmark"
    shutil.copy(bench / "configs" / "tan-w2v-s3d-e6d6.json", bench / "configs" / "tan-w2v-t128.json")
    wl = json.loads((bench / "workloads" / "tan.stage1_graph.json").read_text())
    wl["traffic"]["seq_len"] = 128
    (bench / "workloads" / "tan-t128.stage1.json").write_text(json.dumps(wl))
    (bench / "metrics" / "steps_seen.train.py").write_text(
        "def read(run):\n    return float(run.units)\n")
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append({**man["configs"][0], "name": "tan-w2v-t128",
                           "file": "benchmark/configs/tan-w2v-t128.json"})
    man["workloads"].append({"name": "tan-t128.stage1", "config": "tan-w2v-t128",
                             "traffic": "stage1_t128", "chips": 1, "why": "longer windows"})
    man["end_to_end"][0]["workloads"].append("tan-t128.stage1")
    man["per_layer"].append({"name": "steps_seen.train", "unit": "units", "better": "higher",
                             "source": "program_counter", "layer": "train step",
                             "moves": "train_windows_per_s",
                             "workloads": ["tan.stage1_graph", "tan-t128.stage1"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    out = _run(root, "--list")
    assert out.returncode == 0, out.stderr
    listing = json.loads(out.stdout)
    assert "tan-w2v-t128" in listing["configs"]
    cell = listing["cells"]["tan-t128.stage1"]
    assert cell["config"] == "tan-w2v-t128" and cell["driver"] == "tan_train"
    assert "steps_seen.train" in cell["per_layer"]
    assert "steps_seen.train" in listing["cells"]["tan.stage1_graph"]["per_layer"]
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"


def test_without_the_program_a_run_prints_nothing(tmp_path):
    root = _copy(tmp_path)  # BENCHMARK.json and the benchmark's files only
    out = _run(root, "--workload", "tan.stage1_graph", "--seed", "1", "--seconds", "1")
    assert out.returncode != 0 and out.stdout == ""


def test_without_a_card_a_run_prints_nothing():
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here: the card's runs are test_bench_card.py's")
    out = _run(ROOT, "--workload", "tan.stage1_graph", "--seed", "1", "--seconds", "1",
               env_root=str(ROOT))
    assert out.returncode != 0 and out.stdout == ""
    assert "no CUDA device" in out.stderr
