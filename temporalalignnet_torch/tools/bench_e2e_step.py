"""End-to-end S3D fine-tune step bench: the heaviest compute path of the
project (counterpart of temporalalignnet_tpu/tools/bench_e2e_step.py).

Times the whole e2e train step (S3D forward over the clips, the word2vec
text tower, the symmetric InfoNCE, backward and AdamW; ``train/end2end.py``)
at the reference recipe, 16 frames at 224² and 2 clips a video (reference
end2end/main_nce.py:60-101, num_sample_per_video=2; S3D at
model/s3d_milnce/s3dg.py:321-348), on synthetic clips already on the
device: the device half of the pipeline (the host's decode and feed is
``tools/bench_loader.py``'s).

  python -m temporalalignnet_torch.tools.bench_e2e_step --batch_size 8
  python -m temporalalignnet_torch.tools.bench_e2e_step --train_bn_stats 1
  python -m temporalalignnet_torch.tools.bench_e2e_step --freeze_early 1 --f32

Weights are random from a ``torch.Generator`` seeded with 0; the clips
(``rand``) and the ids (``randint``) come from ``RandomState(0)``.  On the
card the model and the clips are channels-last 3-D and compute is bf16
unless ``--f32``; the CPU runs f32.  After 3 warm-up steps, ``--repeats``
rounds of ``--iters`` back-to-back steps, each ending with
``torch.cuda.synchronize()`` and a fetch of the last loss; the best round's
rate is reported.

- ``temp_mb``: the peak memory allocated during the last warm-up step less
  what was allocated before it; ``hbm_mb``: that peak itself (params,
  optimizer state and clips included); null on the CPU.
- ``gflops_per_step``: the first warm-up step counted under
  ``torch.utils.flop_counter.FlopCounterMode``: the convolutions and matrix
  products of the forward and the backward, at 2 FLOPs per multiply-add.
  Elementwise work (BN, ReLU, gating, pooling, AdamW) is not counted.
  ``achieved_tflops`` = steps/s x that count.
- ``--profile_dir``: a ``torch.profiler`` trace of 10 steps after the timing,
  written as ``trace_<pid>.json`` there (``utils/profiling.py::trace``).

The step launches none of the port's kernels.  Prints one JSON line:
clips/s (= batch_size x clips_per_video x steps/s) and the numbers above.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--batch_size", type=int, default=8,
                   help="videos per step (reference --batch_size; clips per "
                        "step = batch_size * clips_per_video)")
    p.add_argument("--clips_per_video", type=int, default=2,
                   help="num_sample_per_video (main_nce.py recipe: 2)")
    p.add_argument("--num_frames", type=int, default=16)
    p.add_argument("--crop_size", type=int, default=224)
    p.add_argument("--train_bn_stats", type=int, default=0,
                   help="1 = BN in train mode with running-stat updates "
                        "(reference WITHOUT freeze_bn surgery)")
    p.add_argument("--freeze_early", type=int, default=0,
                   help="1 = stop gradients into the early S3D blocks")
    p.add_argument("--f32", action="store_true",
                   help="float32 compute (default bf16 on the card)")
    p.add_argument("--fold_s2d", type=int, default=1,
                   help="0 = explicit space_to_depth transpose before conv1")
    p.add_argument("--num_classes", type=int, default=512)
    p.add_argument("--max_words", type=int, default=16)
    p.add_argument("--vocab_size", type=int, default=66251)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--profile_dir", default="",
                   help="write a torch.profiler trace of 10 "
                        "steady-state steps after timing")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def model_kwargs(args) -> dict:
    return dict(num_classes=args.num_classes, vocab_size=args.vocab_size,
                freeze_early=bool(args.freeze_early),
                train_bn_stats=bool(args.train_bn_stats), fold_s2d=bool(args.fold_s2d))


def train_config():
    from temporalalignnet_torch.core.config import TrainConfig

    return TrainConfig(lr=1e-5, wd=1e-5, warmup_iterations=10, total_iterations=10_000)


def make_batch(args) -> Dict[str, np.ndarray]:
    """clips [B, n, T, S, S, 3] f32 in [0, 1] and input_ids [B, n, W] int32."""
    rng = np.random.RandomState(0)
    B, n, T, S = args.batch_size, args.clips_per_video, args.num_frames, args.crop_size
    return {"clips": rng.rand(B, n, T, S, S, 3).astype(np.float32),
            "input_ids": rng.randint(1, args.vocab_size, (B, n, args.max_words)).astype(
                np.int32)}


def count_flops(fn):
    """(fn(), the FLOPs ``FlopCounterMode`` counted in it): convolutions and
    matrix products, forward and backward, 2 per multiply-add."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        out = fn()
    return out, counter.get_total_flops()


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    import torch

    from temporalalignnet_torch.train.end2end import (S3DWithText, make_e2e_optimizer,
                                                      make_e2e_train_step)
    from temporalalignnet_torch.utils.profiling import trace

    device = torch.device(args.device)
    cuda = device.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device here (pass --device cpu for the CPU path)")
    dtype = torch.float32 if (args.f32 or not cuda) else torch.bfloat16
    model = S3DWithText(**model_kwargs(args))
    model.init_weights(torch.Generator().manual_seed(0))
    layout = torch.channels_last_3d if cuda else torch.contiguous_format
    model.to(device=device, memory_format=layout)
    step = make_e2e_train_step(model, make_e2e_optimizer(model, train_config()),
                               temperature=0.07, compute_dtype=dtype)
    batch = {k: torch.from_numpy(v).to(device) for k, v in make_batch(args).items()}
    # [B, n, T, S, S, 3] contiguous: the step's permute makes it channels-last 3-D
    batch["clips"] = batch["clips"].to(dtype)
    B, n, T, S = args.batch_size, args.clips_per_video, args.num_frames, args.crop_size

    def fence(metrics) -> None:
        if cuda:
            torch.cuda.synchronize()
        metrics["loss"].item()

    temp_mb = hbm_mb = None
    _, flops = count_flops(lambda: step(batch))  # warm-up: the first step counted
    step(batch)
    if cuda:  # the third warm-up step's memory
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    fence(step(batch))
    if cuda:
        peak = torch.cuda.max_memory_allocated()
        temp_mb = round((peak - before) / 2**20, 1)
        hbm_mb = round(peak / 2**20, 1)
    gflops = round(flops / 1e9, 1) or None

    best = 0.0
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        for _ in range(args.iters):
            metrics = step(batch)
        fence(metrics)
        best = max(best, args.iters / (time.perf_counter() - t0))

    if args.profile_dir:  # a device trace of 10 steady-state steps
        with trace(args.profile_dir):
            for _ in range(10):
                metrics = step(batch)
            fence(metrics)

    out = {
        "metric": "e2e_s3d_clips_per_sec",
        "value": round(best * B * n, 2),
        "unit": "clips/s",
        "steps_per_sec": round(best, 3),
        "batch_size": B,
        "clips_per_video": n,
        "num_frames": T,
        "crop_size": S,
        "train_bn_stats": bool(args.train_bn_stats),
        "freeze_early": bool(args.freeze_early),
        "fold_s2d": bool(args.fold_s2d),
        "dtype": str(dtype).removeprefix("torch."),
        "temp_mb": temp_mb,
        "hbm_mb": hbm_mb,
        "gflops_per_step": gflops,
        "achieved_tflops": round(best * gflops / 1e3, 1) if gflops else None,
        "backend": device.type,
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
