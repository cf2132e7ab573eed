"""Write a checkpoint of the port's trainer as a bare reference ``.pth.tar``
(counterpart of temporalalignnet_tpu/tools/export_torch.py).

The reference's tools read flat torch dicts ``{epoch, state_dict, best_acc,
optimizer, iteration}`` (reference utils/utils.py:39-57, train/main.py:
146-151) with the non-strict ``neq_load_customized``.  The port's trainer
already writes its weights in that layout (``train/cli.py``), with its
resume state and AdamW's state beside them; this tool keeps the weights
only: ``resume`` is dropped and ``optimizer`` written ``{}``, as the JAX tool
writes without one.  A Stage-2 checkpoint keeps the twin's ``online.*`` /
``target.*`` / ``bert.*`` keys as ``checkpoint.twin_state_dict`` gives them.

    python -m temporalalignnet_torch.tools.export_torch \\
        --params exp/cotrain_word2vec_len64_e6d6_bs64_lr0.0001 \\
        --out cotrain_export.pth.tar --epoch 3

``--params`` is a checkpoint file of the trainer (runtime, epoch or
``latest.pth.tar``) or an experiment directory, whose newest runtime or
epoch checkpoint ``checkpoint.latest`` finds.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> str:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--params", required=True,
                   help="a checkpoint file of the trainer, or an experiment directory")
    p.add_argument("--out", required=True, help="output .pth.tar path")
    p.add_argument("--epoch", type=int, default=0)
    p.add_argument("--iteration", type=int, default=0)
    p.add_argument("--best_acc", type=float, default=0.0)
    args = p.parse_args(argv)

    import torch

    from temporalalignnet_torch.checkpoint import atomic_save, latest

    path = args.params
    if os.path.isdir(path):
        found = latest(path)
        if found is None:
            raise SystemExit(f"--params {path}: no runtime or epoch checkpoint found")
        path = found[1]
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = sd.get("state_dict", sd)
    atomic_save({"epoch": args.epoch, "state_dict": sd, "best_acc": args.best_acc,
                 "optimizer": {}, "iteration": args.iteration}, args.out)
    kind = "twin (online/target)" if any(k.startswith("target.") for k in sd) else "plain"
    print(f"wrote {kind} reference checkpoint: {args.out} (from {path})")
    return args.out


if __name__ == "__main__":
    main()
