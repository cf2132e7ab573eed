"""What the benchmark loads: no module that ``run.py`` reaches is JAX's or
the JAX package's, and the plain references load nothing of the program.
Top-level module names are compared whole: the port's name begins with the
JAX package's."""

import ast
import json
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "temporalalignnet_tpu"}

REACH = """
import importlib, json, sys
sys.path.insert(0, {root!r})
import benchmark.harness as h
for d in ("tan_train", "tan_infer"):
    importlib.import_module("benchmark.drivers." + d)
# what the drivers import from the program when they set up
for m in ("temporalalignnet_torch.core.config", "temporalalignnet_torch.models.net",
          "temporalalignnet_torch.train.optimizer", "temporalalignnet_torch.train.train_step",
          "torch.profiler"):
    importlib.import_module(m)
h.listing()  # every metric reader
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""

REFERENCE = """
import importlib, json, sys
sys.path.insert(0, {root!r})
for m in ("benchmark.reference.common", "benchmark.reference.tan", "benchmark.work",
          "benchmark.traffic", "benchmark.trace"):
    importlib.import_module(m)
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""


def _top_level(code: str):
    out = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT))], capture_output=True,
                         text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_nothing_run_reaches_is_jax():
    loaded = _top_level(REACH)
    assert "temporalalignnet_torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_the_references_load_nothing_of_the_program():
    loaded = _top_level(REFERENCE)
    assert not loaded & (FORBIDDEN | {"temporalalignnet_torch"})


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_source_under_the_benchmark_imports_jax():
    for path in BENCH.rglob("*.py"):
        assert not set(_imports(path)) & FORBIDDEN, path
    for path in (BENCH / "reference").rglob("*.py"):
        assert "temporalalignnet_torch" not in set(_imports(path)), path
