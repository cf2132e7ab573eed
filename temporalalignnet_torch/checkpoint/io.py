"""Runtime and epoch checkpoints with best-k rotation (counterpart of
temporalalignnet_tpu/checkpoint/orbax_io.py::Checkpointer; reference
utils/utils.py:23-57):

- ``save_runtime``: every ``--runtime_save_iter`` steps, ``runtime/`` keeps
  only the newest (utils.py:23-36; orbax ``max_to_keep=1``);
- ``save_epoch``: one file per epoch under ``epoch/``, the ``MAX_BEST`` with
  the highest ``best_metric`` kept (``Recall`` for the TAN trainer; the
  end-to-end trainer ranks by ``loss``, saved as minus the epoch's mean
  loss; utils.py:39-57; orbax ``best_fn`` with
  ``best_mode='max'``): a stable sort by the metric in epoch order, the last
  ``MAX_BEST`` survive, so the newer of two equal epochs wins, and the epoch
  just saved goes at once when it ranks below all the others.  A metric the
  epoch's dict lacks counts 0.0.  Saving an epoch again replaces its file.

Each file is a ``torch.save`` dict, written to a temporary file and renamed
over its final name (``atomic_save``); older files are deleted only after
that, so a kill at any point leaves every finished checkpoint readable.
Temporary files a kill left behind are deleted when the next Checkpointer
opens the directory.  ``latest_step``/``restore`` take the newest checkpoint
of the two kinds by its training step (the runtime one on a tie), where the
JAX Checkpointer compares a runtime step with an epoch index; the module's
``latest(directory)`` finds the same file without opening a Checkpointer,
which would create the subdirectories and clear temporary files.

Under a process group only rank 0 writes (and rotates and clears) files;
every rank keeps the same bookkeeping and waits at a barrier after each
save, so a file is complete before any rank goes on (JAX's ``is_master``
gates, train/cli.py:332); ``--resume`` reads the same file on every rank.

The files hold whatever the trainer passes (the reference layout plus the
port's resume state, ``train/cli.py``); the epoch files also the
``metrics`` they were ranked by, read back when a Checkpointer opens the
directory.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Any, Dict, Optional, Tuple

import torch

from temporalalignnet_torch.checkpoint.convert import atomic_save
from temporalalignnet_torch.parallel.distributed import barrier, is_master

MAX_BEST = 5
_RUNTIME = re.compile(r"^step_(\d+)\.pth\.tar$")
_EPOCH = re.compile(r"^epoch_(\d+)\.pth\.tar$")


def _listed(directory: str, pattern: re.Pattern) -> Dict[int, str]:
    """{number in the name: path} of the finished checkpoints in ``directory``
    (none if it does not exist)."""
    out = {}
    for name in (os.listdir(directory) if os.path.isdir(directory) else ()):
        m = pattern.match(name)
        if m:
            out[int(m.group(1))] = os.path.join(directory, name)
    return out


def _header(path: str) -> Dict[str, Any]:
    """A checkpoint's dict with its tensors memory-mapped, not read."""
    return torch.load(path, map_location="cpu", weights_only=True, mmap=True)


def _newest(runtime_dir: str, epoch_steps: Dict[str, int]) -> Optional[Tuple[int, str]]:
    """(training step, path) of the newest of the runtime checkpoints in
    ``runtime_dir`` and the epoch checkpoints ``epoch_steps`` {path: step},
    the runtime one on a tie; None if there are none."""
    candidates = [(s, 1, p) for s, p in _listed(runtime_dir, _RUNTIME).items()]
    candidates += [(s, 0, p) for p, s in epoch_steps.items()]
    if not candidates:
        return None
    step, _, path = max(candidates)
    return step, path


def latest(directory: str) -> Optional[Tuple[int, str]]:
    """(training step, path) of the newest checkpoint of an experiment
    directory, found without changing the directory; None if it holds none."""
    epochs = _listed(os.path.join(directory, "epoch"), _EPOCH).values()
    return _newest(os.path.join(directory, "runtime"),
                   {p: int(_header(p)["iteration"]) for p in epochs})


class Checkpointer:
    """Runtime and epoch checkpoints of one experiment directory."""

    def __init__(self, directory: str, best_metric: str = "Recall"):
        """``best_metric``: the key of ``save_epoch``'s metrics that ranks the
        epochs (default the HTM-Align recall, train/main.py:165-212)."""
        self.best_metric = best_metric
        self.runtime_dir = os.path.join(directory, "runtime")
        self.epoch_dir = os.path.join(directory, "epoch")
        if is_master():
            for d in (self.runtime_dir, self.epoch_dir):
                os.makedirs(d, exist_ok=True)
                for tmp in glob.glob(os.path.join(d, "*.pth.tar.tmp*")):
                    os.remove(tmp)
        barrier()
        # epoch -> (rank metric, training step), read from the files' headers
        self._epochs: Dict[int, Tuple[float, int]] = {}
        for epoch, path in _listed(self.epoch_dir, _EPOCH).items():
            head = _header(path)
            self._epochs[epoch] = (self._metric(head.get("metrics")), int(head["iteration"]))

    def _metric(self, metrics: Optional[dict]) -> float:
        return float((metrics or {}).get(self.best_metric, 0.0))

    # ------------------------------------------------------------------ save

    def save_runtime(self, state: Dict[str, Any], step: int) -> str:
        path = os.path.join(self.runtime_dir, f"step_{step:09d}.pth.tar")
        if is_master():
            atomic_save(state, path)
            for s, old in _listed(self.runtime_dir, _RUNTIME).items():
                if s != step:
                    os.remove(old)
        barrier()
        return path

    def save_epoch(self, state: Dict[str, Any], epoch: int,
                   metrics: Optional[dict] = None) -> str:
        """``state`` must hold ``iteration`` (its training step)."""
        path = self.epoch_path(epoch)
        if is_master():
            atomic_save(dict(state, metrics=dict(metrics or {})), path)
        self._epochs[epoch] = (self._metric(metrics), int(state["iteration"]))
        for e in self._rotated_out():
            if is_master():
                os.remove(self.epoch_path(e))
            del self._epochs[e]
        barrier()
        return path

    def _ranked(self):
        """Epochs from worst to best; the sort is stable, so of equal metrics
        the later epoch ranks higher."""
        return sorted(sorted(self._epochs), key=lambda e: self._epochs[e][0])

    def _rotated_out(self):
        ranked = self._ranked()
        return ranked[:max(len(ranked) - MAX_BEST, 0)]

    def epoch_path(self, epoch: int) -> str:
        return os.path.join(self.epoch_dir, f"epoch_{epoch:05d}.pth.tar")

    # --------------------------------------------------------------- restore

    def epochs(self):
        """The epochs whose checkpoints survive, in order."""
        return sorted(self._epochs)

    def best_epoch(self) -> Optional[int]:
        return self._ranked()[-1] if self._epochs else None

    def latest(self) -> Optional[Tuple[int, str]]:
        """(training step, path) of the newest checkpoint, or None."""
        return _newest(self.runtime_dir,
                       {self.epoch_path(e): s for e, (_, s) in self._epochs.items()})

    def latest_step(self) -> Optional[int]:
        found = self.latest()
        return None if found is None else found[0]

    def restore(self) -> Dict[str, Any]:
        """The newest checkpoint's dict, tensors on the CPU."""
        found = self.latest()
        if found is None:
            raise FileNotFoundError(f"no checkpoint under {self.runtime_dir} or {self.epoch_dir}")
        return torch.load(found[1], map_location="cpu", weights_only=True)
