"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every ``csrc/<name>.cu`` becomes ``build/torch_kernels/lib<name>-<hash>.so`` at
the repository root, compiled for ``sm_90a`` into a shared library with a
plain C interface.  The hash covers the source, the ``csrc/*.cuh`` headers and
the flags, so an edited source builds anew and an unchanged one loads the
library already there.
``build_all`` starts one nvcc per source, all at once, and waits for them.

Nothing here runs at import: the CPU tests import every module, on hosts
without nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills go to the build log
]

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the toolkit is")
    return path


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: List[str] = None) -> Dict[str, Path]:
    """Compile every named source (default: all) that has no library yet, one
    nvcc each, in parallel.  Returns {name: library path}; raises with the
    compiler's output if any build fails."""
    names = sources() if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {n: _target(n) for n in names}
    todo = {n: t for n, t in targets.items() if not t.exists()}
    if todo:
        nvcc = _nvcc()
        procs = {}
        for n, t in todo.items():
            tmp = t.with_suffix(f".{os.getpid()}.tmp")
            log = open(t.with_suffix(".log"), "w")
            procs[n] = (
                subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
                    stdout=log, stderr=subprocess.STDOUT,
                ),
                tmp, log,
            )
        failed = []
        for n, (proc, tmp, log) in procs.items():
            rc = proc.wait()
            log.close()
            if rc == 0:
                os.replace(tmp, targets[n])
            else:
                failed.append(n)
        if failed:
            logs = "\n".join(build_log(n) for n in failed)
            raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return targets


def build_log(name: str) -> str:
    """The compiler's output of the last build of ``name`` (ptxas -v lines)."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """The card's number of SMs, which the launchers size their grids by."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all([name])[name]))
        _loaded[name] = lib
    return lib
