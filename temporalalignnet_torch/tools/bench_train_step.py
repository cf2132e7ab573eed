"""Train-step bench: the fused MIL-NCE kernels against the plain-logits loss
(counterpart of temporalalignnet_tpu/tools/bench_train_step.py).

Times the whole train step (forward, loss, gradient, AdamW and, at
``--stage 2``, the EMA twin) of the E6D6 TAN at the train CLI's widths, for
Stage 1 ('init') or Stage 2 ('cotrain' with agreement targets, a loss
threshold and the alignability head), with the loss either from the
[B, S, T, B, N] logits or from the MIL-NCE kernels' logsumexps over the
per-layer features (``--fused 1``, ``ops/milnce.py``).

  python -m temporalalignnet_torch.tools.bench_train_step --stage 1 --fused 1

Weights are random from a ``torch.Generator`` seeded with 0 and the batch is
``data/synthetic.py::synthetic_batch`` on ``RandomState(0)``, both on the
device before the timing.  Compute is bf16 on the card (f32 on the CPU), the
params and the capturable AdamW f32.  After 3 warm-up steps, ``--repeats``
rounds of ``--iters`` back-to-back steps; each round ends with
``torch.cuda.synchronize()`` and a fetch of the last loss, and the best
round's rate is reported.  ``temp_mb`` is the peak memory allocated during
the last warm-up step less what was allocated before it (activations and
scratch; null on the CPU).

On the card a ``--fused 1`` step launches ``mha_fwd`` 12 times (24 at
``--stage 2``: the twin's forward), ``mha_bwd`` 12 and each MIL-NCE kernel
twice; ``--fused 0`` only the attention kernels.  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict

import numpy as np

VOCAB_SIZE = 66251


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--stage", type=int, default=1, choices=[1, 2])
    p.add_argument("--fused", type=int, default=0)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--seq_len", type=int, default=64)
    p.add_argument("--max_sentences", type=int, default=16)
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--remat", type=int, default=0,
                   help="rematerialize encoder blocks in backward "
                        "(activation-memory lever; expect a FLOPs cost)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def configs(args) -> tuple:
    """(ModelConfig, LossConfig, TrainConfig) of ``args``."""
    from temporalalignnet_torch.core.config import LossConfig, ModelConfig, TrainConfig

    fused = bool(args.fused)
    stage2 = dict(model="cotrain", learn_agreement=True, temporal_agreement_type="keep",
                  loss_threshold=0.5, use_alignability_head=True)
    loss_cfg = LossConfig(use_fused_milnce=fused, **(stage2 if args.stage == 2 else {}))
    mcfg = ModelConfig(use_alignability_head=loss_cfg.use_alignability_head,
                       fused_milnce=fused, remat=bool(args.remat))
    tcfg = TrainConfig(lr=1e-4, warmup_iterations=10, total_iterations=10_000)
    return mcfg, loss_cfg, tcfg


def make_batch(args, mcfg) -> Dict[str, np.ndarray]:
    from temporalalignnet_torch.data.synthetic import synthetic_batch

    return synthetic_batch(np.random.RandomState(0), batch_size=args.batch_size,
                           seq_len=args.seq_len, max_sentences=args.max_sentences,
                           feature_dim=mcfg.video_embed_dim, vocab_size=VOCAB_SIZE,
                           max_words=32)


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    import torch

    from temporalalignnet_torch.models.net import TANWithText
    from temporalalignnet_torch.train.optimizer import Optimizer
    from temporalalignnet_torch.train.train_step import EMATwin, make_train_step

    device = torch.device(args.device)
    cuda = device.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device here (pass --device cpu for the CPU path)")
    mcfg, loss_cfg, tcfg = configs(args)
    model = TANWithText(mcfg, vocab_size=VOCAB_SIZE)
    model.init_weights(torch.Generator().manual_seed(0))
    model.to(device)
    twin = EMATwin(model, tcfg) if loss_cfg.model == "cotrain" else None
    step = make_train_step(model, Optimizer(model, tcfg), tcfg, loss_cfg,
                           compute_dtype=torch.bfloat16 if cuda else torch.float32, twin=twin)
    batch = {k: torch.from_numpy(v).to(device) for k, v in make_batch(args, mcfg).items()}

    def fence(metrics) -> None:
        if cuda:
            torch.cuda.synchronize()
        metrics["loss"].item()

    temp_mb = None
    for _ in range(2):  # warm-up: the kernels' build, AdamW's state
        step(batch)
    if cuda:  # the third warm-up step's memory
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    fence(step(batch))
    if cuda:
        temp_mb = round((torch.cuda.max_memory_allocated() - before) / 2**20, 1)

    best = 0.0
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        for _ in range(args.iters):
            metrics = step(batch)
        fence(metrics)
        best = max(best, args.iters / (time.perf_counter() - t0))

    out = {
        "metric": f"stage{args.stage}_train_steps_per_sec",
        "fused_milnce": bool(args.fused),
        "remat": bool(args.remat),
        "temp_mb": temp_mb,
        "value": round(best, 2),
        "unit": "steps/s",
        "batch_size": args.batch_size,
        "backend": device.type,
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
