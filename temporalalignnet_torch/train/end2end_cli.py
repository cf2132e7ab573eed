"""End-to-end S3D fine-tune CLI (counterpart of
temporalalignnet_tpu/train/end2end_cli.py; reference end2end/main_nce.py):

  python -m temporalalignnet_torch.train.end2end_cli \\
      --htm_aa_csv htm_aa_v1.csv --video_root /data/videos \\
      --vocab s3d_dict.npy --pretrain s3d_howto100m.pth ...

S3D-G and the word2vec text tower (``train/end2end.py``) trained with the
symmetric InfoNCE on HTM-AA clips (``data/clips.py``), AdamW with warm-up and
cosine decay, frozen BN unless ``--train_bn_stats 1``.  Runs on ``--device
cuda`` (the default) with bf16 compute and the convolutions in
``channels_last_3d``; ``--device cpu`` runs f32.

- ``--pretrain``: an ``s3d_howto100m.pth``-format file (the MIL-NCE release,
  or this trainer's ``params_latest.pth``) merged non-strictly into the fresh
  model, the merge printed as ``[pretrain]`` lines (missing keys keep their
  init, unexpected ones are dropped);
- checkpoints under ``<prefix>/e2e_bs<B>_lr<lr>_f<frames>/``: ``runtime/``
  every ``--runtime_save_iter`` steps (the newest kept) and ``epoch/`` at
  each epoch end, the 5 with the lowest mean loss kept (ranked by
  ``{"loss": -mean}``, as the JAX trainer ranks them); each holds the
  state_dict, the optimizer state, the epoch and the step;
- the final export ``params_latest.pth``: the model's state_dict in the
  ``s3d_howto100m.pth`` key space (the S3D keys and ``text_module.*``),
  which ``--pretrain`` and ``tools/extract_features.py`` read back (the JAX
  trainer exports an orbax directory, which the port does not read);
- ``--debug_batch_hash 1`` prints a crc32 of every batch tensor;
- ``e2e/*`` scalars every ``--log_every`` steps to
  ``<experiment>/e2e.metrics.jsonl``; the last stdout line is
  ``{"final_step": ..., <the last step's metrics>}``.

Data parallelism (JAX train/end2end_cli.py:75-163; reference
main_nce.py:140-158, 229-231, 283-285): ``--multihost`` with
``--coordinator host:port --num_processes N --process_id i`` in each
process (or torchrun's or SLURM's environment), one process per card.
``--batch_size`` stays the global batch; each process builds its rows of it
(a ``[multihost]`` line says which), the InfoNCE takes every process's
embeddings as negatives, ``--train_bn_stats 1`` normalises with the global
batch statistics, and the gradients are averaged before each update
(``train/end2end.py``).  Only process 0 writes checkpoints, the metrics log,
the log lines and the export; ``--debug_batch_hash`` prints each process's
rows, tagged with its rank.
"""

from __future__ import annotations

import argparse
import json
import os
import zlib
from typing import Optional


def build_parser() -> argparse.ArgumentParser:
    from temporalalignnet_torch.parallel.distributed import add_multihost_flags

    p = argparse.ArgumentParser("temporalalignnet_torch end2end S3D fine-tune")
    p.add_argument("--htm_aa_csv", required=True)
    p.add_argument("--video_root", required=True)
    p.add_argument("--vocab", required=True)
    p.add_argument("--pretrain", default=None,
                   help="s3d_howto100m.pth-format file (or this trainer's params_latest.pth)")
    p.add_argument("--num_frames", type=int, default=16)
    p.add_argument("--fps", type=int, default=5)
    p.add_argument("--crop_size", type=int, default=224)
    p.add_argument("--num_sample_per_video", type=int, default=2)
    p.add_argument("--batch_size", type=int, default=16, help="videos per optimizer step")
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--wd", type=float, default=1e-5)
    p.add_argument("--warmup_iterations", type=int, default=200)
    p.add_argument("--backprop_freq", type=int, default=1)
    p.add_argument("--temperature", type=float, default=0.07)
    p.add_argument("--freeze_early", type=int, default=0)
    p.add_argument("--train_bn_stats", type=int, default=0,
                   help="1 = BN in train mode (no FrozenBN surgery); default: frozen running "
                        "statistics, the reference recipe")
    p.add_argument("--num_classes", type=int, default=512,
                   help="joint embedding dim (512 in the reference recipe)")
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--prefix", default="exp_e2e")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_every", type=int, default=5)
    p.add_argument("--runtime_save_iter", type=int, default=1000)
    p.add_argument("--max_steps", type=int, default=0)
    p.add_argument("--max_words", type=int, default=32)
    p.add_argument("--decoder", default="ffmpeg", choices=["ffmpeg", "synthetic"],
                   help="synthetic = deterministic pseudo-frames from the clip identity "
                        "(no ffmpeg binary needed)")
    p.add_argument("--check_existence", type=int, default=1,
                   help="0 skips the per-video file-existence filter (video_loader.py:71-73)")
    add_multihost_flags(p)
    p.add_argument("--debug_batch_hash", type=int, default=0,
                   help="1 = print a crc32 of every batch tensor")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def load_pretrain(path: str, model) -> None:
    """``--pretrain``: the file merged non-strictly into ``model``, each line
    of the merge printed under ``[pretrain]``."""
    from temporalalignnet_torch.checkpoint import (load_milnce_checkpoint, merge_state_dict,
                                                   s3d_state_dict)

    loaded = s3d_state_dict(load_milnce_checkpoint(path))
    merged, report = merge_state_dict(model.state_dict(), loaded)
    model.load_state_dict(merged, strict=True)
    for line in report:
        print(f"[pretrain] {line}", flush=True)


def main(argv: Optional[list] = None) -> dict:
    args = build_parser().parse_args(argv)
    import torch

    from temporalalignnet_torch.parallel import distributed

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device here (pass --device cpu for the CPU path)")
    started = distributed.start_multihost(args)
    try:
        return _train(args, distributed.default_group())
    finally:
        if started:
            distributed.destroy()


def _train(args, group) -> dict:
    import numpy as np
    import torch

    from temporalalignnet_torch.checkpoint import Checkpointer, atomic_save
    from temporalalignnet_torch.core.config import Precision, TrainConfig
    from temporalalignnet_torch.data import TrainLoader
    from temporalalignnet_torch.data.clips import HTMClipDataset, synthetic_decode
    from temporalalignnet_torch.models.word2vec import Word2VecTokenizer
    from temporalalignnet_torch.train.end2end import (S3DWithText, make_e2e_optimizer,
                                                      make_e2e_train_step)
    from temporalalignnet_torch.parallel.distributed import (barrier, is_master, master_print,
                                                             process_device, rank, world_size)
    from temporalalignnet_torch.parallel.mesh import local_batch_rows
    from temporalalignnet_torch.utils import AverageMeter, MetricsWriter, StepTimer

    device = process_device(args.device)
    compute = torch.float32 if device.type == "cpu" else Precision().compute

    tokenizer = Word2VecTokenizer(args.vocab, max_words=args.max_words)
    dataset = HTMClipDataset(
        args.htm_aa_csv, args.video_root, tokenizer=tokenizer, num_frames=args.num_frames,
        fps=args.fps, num_sample_per_video=args.num_sample_per_video,
        crop_size=args.crop_size, max_words=args.max_words,
        decoder=synthetic_decode if args.decoder == "synthetic" else None,
        check_existence=bool(args.check_existence))
    if len(dataset) == 0:
        raise SystemExit("no videos found")
    steps_per_epoch = max(len(dataset) // args.batch_size, 1)
    tcfg = TrainConfig(lr=args.lr, wd=args.wd, warmup_iterations=args.warmup_iterations,
                       total_iterations=steps_per_epoch * args.epochs,
                       backprop_freq=args.backprop_freq, seed=args.seed)

    model = S3DWithText(num_classes=args.num_classes, vocab_size=tokenizer.vocab_size,
                        freeze_early=bool(args.freeze_early),
                        train_bn_stats=bool(args.train_bn_stats))
    model.init_weights(torch.Generator().manual_seed(args.seed))
    if args.pretrain:
        load_pretrain(args.pretrain, model)
    layout = torch.channels_last_3d if device.type == "cuda" else torch.contiguous_format
    model.to(device=device, memory_format=layout)
    optimizer = make_e2e_optimizer(model, tcfg)
    step_fn = make_e2e_train_step(model, optimizer, args.temperature, compute, group)
    local_rows = None
    if group is not None:  # every process builds its rows of each global batch
        try:
            local_rows = local_batch_rows(args.batch_size, group)
        except ValueError as e:
            raise SystemExit(f"--batch_size: {e}") from None
        print(f"[multihost] process {rank()}/{world_size()} builds batch rows "
              f"[{local_rows[0]}, {local_rows[1]})", flush=True)

    exp_dir = os.path.join(args.prefix, f"e2e_bs{args.batch_size}_lr{args.lr}_f{args.num_frames}")
    if is_master():
        os.makedirs(exp_dir, exist_ok=True)
    ckpt = Checkpointer(exp_dir, best_metric="loss")
    writer = MetricsWriter(exp_dir, name="e2e")
    timer = StepTimer()
    loss_meter = AverageMeter("loss", ":.4f")
    loader = TrainLoader(dataset, args.batch_size, seed=args.seed,
                         num_workers=args.num_workers, pin_memory=device.type == "cuda",
                         local_rows=local_rows)

    def training_state(epoch: int) -> dict:
        return {"epoch": epoch, "iteration": global_step,
                "state_dict": {k: v.detach().cpu() for k, v in model.state_dict().items()},
                "optimizer": optimizer.state_dict()}

    global_step, stop, last = 0, False, {}
    for epoch in range(args.epochs):
        if stop:
            break
        loader.set_epoch(epoch)
        for batch in loader:
            if args.debug_batch_hash:
                for k in sorted(batch):
                    crc = zlib.crc32(np.ascontiguousarray(batch[k].numpy()).tobytes())
                    tag = f" rank {rank()}" if group is not None else ""
                    print(f"[batchhash]{tag} {global_step} {k} {crc:08x}", flush=True)
            metrics = step_fn(batch)
            global_step += 1
            last = {k: float(v) for k, v in metrics.items()}  # fences the step
            loss_meter.update(last["loss"])
            sps = timer.tick()
            if global_step % args.log_every == 0:
                writer.add_scalars(global_step, {**last, "device/sps": sps}, "e2e/")
                master_print(f"Epoch {epoch} step {global_step}: {loss_meter}", flush=True)
            if args.runtime_save_iter and global_step % args.runtime_save_iter == 0:
                ckpt.save_runtime(training_state(epoch), global_step)
            if args.max_steps and global_step >= args.max_steps:
                stop = True
                break
        ckpt.save_epoch(training_state(epoch), epoch, {"loss": -loss_meter.avg})
    if is_master():
        atomic_save({k: v.detach().cpu().contiguous() for k, v in model.state_dict().items()},
                    os.path.join(exp_dir, "params_latest.pth"))
    barrier()
    writer.close()
    print(json.dumps({"final_step": global_step, **last}), flush=True)
    return last


if __name__ == "__main__":
    main()
