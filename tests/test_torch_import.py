"""The PyTorch port imports no JAX and nothing of the JAX package."""

import os
import re
import subprocess
import sys
from pathlib import Path

import torch

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "temporalalignnet_torch"
PORT_SOURCES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]

_IMPORT_ALL = """
import importlib, pkgutil, sys
for m in ("jax", "flax", "optax", "orbax"):
    sys.modules[m] = None  # any import of them raises ImportError
import temporalalignnet_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names + ["chip_smoke"]:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m.startswith("temporalalignnet_tpu"))
assert not leaked, leaked
print(" ".join(names))
"""
# the end-to-end S3D path and the tools (slice 6) among them
SLICE_6 = {"temporalalignnet_torch.models.s3d", "temporalalignnet_torch.data.clips",
           "temporalalignnet_torch.train.end2end", "temporalalignnet_torch.train.end2end_cli",
           "temporalalignnet_torch.eval.linear_probe", "temporalalignnet_torch.tools",
           "temporalalignnet_torch.tools.extract_features",
           "temporalalignnet_torch.tools.generate_htm_aa"}


def test_port_imports_with_jax_blocked():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, capture_output=True, text=True,
        timeout=300, env={**os.environ, "PYTHONPATH": str(REPO)},
    )
    assert out.returncode == 0, out.stderr
    imported = set(out.stdout.split())
    assert len(imported) >= 28  # every module of the port was imported
    assert SLICE_6 <= imported, SLICE_6 - imported


def test_port_sources_never_import_the_jax_package():
    pattern = re.compile(
        r"^\s*(from\s+(temporalalignnet_tpu|jax|flax|optax|orbax)\b"
        r"|import\s+(temporalalignnet_tpu|jax|flax|optax|orbax)\b)", re.M)
    offenders = {str(p.relative_to(REPO)): pattern.findall(p.read_text())
                 for p in PORT_SOURCES}
    assert {k: v for k, v in offenders.items() if v} == {}
    assert len(PORT_SOURCES) >= 28
    assert {str(p.relative_to(REPO)) for p in PORT_SOURCES} >= {
        m.replace(".", "/") + ("/__init__.py" if m.endswith("tools") else ".py") for m in SLICE_6}
