"""The PyTorch port imports no JAX and nothing of the JAX package, nor any
package the machine with the card lacks (transformers, regex, ftfy,
safetensors, msgpack)."""

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

BLOCKED = ("jax", "flax", "optax", "orbax", "transformers", "regex", "ftfy", "safetensors",
           "msgpack")

_IMPORT_ALL = f"""
import importlib, pkgutil, sys
for m in {BLOCKED!r}:
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
# the BERT, CLIP and TimeSformer towers and their key maps (slice 7)
SLICE_7 = {"temporalalignnet_torch.models.bert", "temporalalignnet_torch.models.clip_text",
           "temporalalignnet_torch.models.clip_vit", "temporalalignnet_torch.models.timesformer",
           "temporalalignnet_torch.checkpoint.clip_convert",
           "temporalalignnet_torch.checkpoint.timesformer_convert"}

# the serving export, the bare reference checkpoint and the inspection helpers (slice 8)
SLICE_8 = {"temporalalignnet_torch.tools.export_eval", "temporalalignnet_torch.tools.export_torch",
           "temporalalignnet_torch.utils.vis"}
# data parallelism over torch.distributed (slice 9)
SLICE_9 = {"temporalalignnet_torch.parallel", "temporalalignnet_torch.parallel.distributed",
           "temporalalignnet_torch.parallel.mesh"}
# the offline text pipeline and tensor parallelism (slice 10)
SLICE_10 = {"temporalalignnet_torch.tools.filters", "temporalalignnet_torch.tools.convert_captions",
            "temporalalignnet_torch.tools.sentencify", "temporalalignnet_torch.tools.process_htm",
            "temporalalignnet_torch.tools.whisper_asr", "temporalalignnet_torch.parallel.tensor"}
# the bench tools (slice 11)
SLICE_11 = {"temporalalignnet_torch.tools.bench_train_step",
            "temporalalignnet_torch.tools.bench_e2e_step",
            "temporalalignnet_torch.tools.bench_loader"}


def test_port_imports_with_jax_blocked():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, capture_output=True, text=True,
        timeout=300, env={**os.environ, "PYTHONPATH": str(REPO)},
    )
    assert out.returncode == 0, out.stderr
    imported = set(out.stdout.split())
    assert len(imported) >= 34  # every module of the port was imported
    slices = SLICE_6 | SLICE_7 | SLICE_8 | SLICE_9 | SLICE_10 | SLICE_11
    assert slices <= imported, slices - imported


def test_port_sources_never_import_the_jax_package():
    names = "|".join(("temporalalignnet_tpu",) + BLOCKED)
    pattern = re.compile(rf"^\s*(from\s+({names})\b|import\s+({names})\b)", re.M)
    offenders = {str(p.relative_to(REPO)): pattern.findall(p.read_text())
                 for p in PORT_SOURCES}
    assert {k: v for k, v in offenders.items() if v} == {}
    assert len(PORT_SOURCES) >= 34
    assert {str(p.relative_to(REPO)) for p in PORT_SOURCES} >= {
        m.replace(".", "/") + ("/__init__.py" if m.endswith(("tools", "parallel")) else ".py")
        for m in SLICE_6 | SLICE_7 | SLICE_8 | SLICE_9 | SLICE_10 | SLICE_11}
