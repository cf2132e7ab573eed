"""Training CLI, Stage 1 and Stage 2 (counterpart of
temporalalignnet_tpu/train/cli.py; reference train/main.py):

  python -m temporalalignnet_torch.train --model init \\
      --feature_dir <dir> --captions sentencified_htm_370k.json --vocab s3d_dict.npy
  python -m temporalalignnet_torch.train --model cotrain --pretrain <stage1>/latest.pth.tar \\
      --feature_dir <dir> --captions sentencified_htm_370k.json --vocab s3d_dict.npy

``--model cotrain`` forces the agreement self-labelling and the alignability
head (train/main.py:361-363) and trains with the EMA twin
(``--momentum_m``).  ``--pretrain`` takes a ``.pth.tar`` in the reference
layout, plain or twin (its online half), merges it non-strictly into the
fresh model (keys it lacks keep their init, keys the model lacks are
dropped; each printed as a ``[pretrain]`` line) and, for cotrain, starts the
target as a copy.  It reads no orbax directory of the JAX trainer.

Runs on ``--device cuda`` (the default): f32 params, bf16 compute (``--f32``
for f32 compute), every attention and, with ``--fused_milnce`` (auto: on for
CUDA, off for the CPU), every MIL-NCE logsumexp in the Hopper kernels.
``--device cpu`` runs the plain PyTorch path in f32.  At each epoch end and at
the ``--max_steps`` stop it writes ``<prefix>/<experiment>/latest.pth.tar``
in the reference layout (with cotrain the twin's ``online.*`` / ``target.*``
keys), which ``python -m temporalalignnet_torch.eval`` loads.  Prints one
JSON line per ``--log_every`` steps and a final one.

Flags of the JAX trainer that later slices bring (BERT, resume and
checkpoint rotation, multi-GPU, rematerialization, grouped dispatch,
profiling, YC2) exit with a message naming that work.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
from typing import Optional

# flag -> (the value that means "not used", the work that brings it)
_LATER = {
    "resume": (None, "checkpoint resume and rotation (ROADMAP Queue A, next)"),
    "milnce_ckpt": (None, "the MIL-NCE S3D/word2vec converter (ROADMAP Queue A)"),
    "remat": (0, "activation rematerialization (a later slice)"),
    "steps_per_dispatch": (1, "grouped dispatch (a later slice; CUDA graphs)"),
    "profile_dir": (None, "the port's profiling tools (ROADMAP Queue A)"),
    "dp": (-1, "multi-GPU training (ROADMAP Queue A)"),
    "tp": (1, "multi-GPU training (ROADMAP Queue A)"),
    "multihost": (False, "multi-GPU training (ROADMAP Queue A)"),
    "yc2_anno": (None, "YC2 retrieval (ROADMAP Queue A)"),
    "yc2_features": (None, "YC2 retrieval (ROADMAP Queue A)"),
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("temporalalignnet_torch trainer")
    # model (train/config.py:7-20)
    p.add_argument("--model", default="init", choices=["init", "cotrain"])
    p.add_argument("--language_model", default="word2vec", choices=["word2vec", "bert"])
    p.add_argument("--num_encoder_layers", type=int, default=6)
    p.add_argument("--num_joint_layers", type=int, default=6)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--sim", default="cos", choices=["cos", "dot"])
    p.add_argument("--pos_enc", default="learned", choices=["learned", "sine"])
    p.add_argument("--use_text_pos_enc", type=int, default=0)
    p.add_argument("--use_alignability_head", type=int, default=0)
    p.add_argument("--video_embed_dim", type=int, default=1024)
    p.add_argument("--remat", type=int, default=0)
    # loss (train/config.py:21-30)
    p.add_argument("--fused_milnce", default="auto", choices=["auto", "0", "1"],
                   help="MIL-NCE logsumexps in the fused kernels (ops/milnce.py) from the "
                        "feature outputs; auto = on for CUDA, off for the CPU")
    p.add_argument("--loss_threshold", type=float, default=0.0)
    p.add_argument("--learn_agreement", type=int, default=0)
    p.add_argument("--temporal_agreement_type", default="keep",
                   choices=["i", "u", "keep", "keep-joint"])
    p.add_argument("--optim_policy", default="default", choices=["default", "bce"])
    p.add_argument("--momentum_m", type=float, default=0.999)
    # data (train/config.py:11-16)
    p.add_argument("--feature_dir", required=True)
    p.add_argument("--captions", required=True)
    p.add_argument("--holdout", default=None)
    p.add_argument("--vocab", required=True, help="word list .npy (s3d_dict format)")
    p.add_argument("--milnce_ckpt", default=None)
    p.add_argument("--seq_len", type=int, default=64)
    p.add_argument("--max_sentences", type=int, default=16)
    p.add_argument("--max_words", type=int, default=32)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--num_workers", type=int, default=8)
    # optim (train/config.py:31-40)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--wd", type=float, default=1e-5)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--warmup_iterations", type=int, default=1000)
    p.add_argument("--backprop_freq", type=int, default=1)
    p.add_argument("--clip_grad_norm", type=float, default=0.0)
    p.add_argument("--clip_mode", default="per_param", choices=["per_param", "global"])
    p.add_argument("--skip_nonfinite", type=int, default=0,
                   help="skip optimizer updates with non-finite grads")
    p.add_argument("--seed", type=int, default=0)
    # infra
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--f32", action="store_true",
                   help="float32 compute on the card (the CPU always runs f32)")
    p.add_argument("--prefix", default="exp", help="experiment dir root")
    p.add_argument("--name_prefix", default="")
    p.add_argument("--resume", default=None)
    p.add_argument("--pretrain", default=None,
                   help="a .pth.tar (reference layout, plain or twin) to start from")
    p.add_argument("--eval_every_epochs", type=int, default=1)
    p.add_argument("--log_every", type=int, default=5)
    p.add_argument("--max_steps", type=int, default=0, help="stop after N steps")
    p.add_argument("--align_anno", default=None, help="htm_align.json for downstream eval")
    p.add_argument("--align_features", default=None)
    p.add_argument("--yc2_anno", default=None)
    p.add_argument("--yc2_features", default=None)
    p.add_argument("--profile_dir", default=None)
    p.add_argument("--steps_per_dispatch", type=int, default=1)
    p.add_argument("--dp", type=int, default=-1)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--multihost", action="store_true")
    return p


def resolve_fused_milnce(flag: str, device_type: str) -> bool:
    """'auto' -> on for CUDA (the kernels take any shape), off for the CPU."""
    return device_type == "cuda" if flag == "auto" else flag == "1"


def experiment_name(args) -> str:
    """Hyperparams-in-dirname convention (reference train/config.py:69-74)."""
    return (f"{args.name_prefix}{args.model}_{args.language_model}_len{args.seq_len}"
            f"_e{args.num_encoder_layers}d{args.num_joint_layers}_bs{args.batch_size}"
            f"_lr{args.lr}")


def _refuse_later_flags(args) -> None:
    if args.language_model == "bert":
        raise SystemExit("--language_model bert: the BERT tower comes with ROADMAP Queue A "
                         "(towers) of the port")
    for flag, (unused, work) in _LATER.items():
        if getattr(args, flag) != unused:
            raise SystemExit(f"--{flag}: not in the port yet; it comes with {work}")
    if args.pretrain and (os.path.isdir(args.pretrain)
                          or not args.pretrain.endswith((".pth.tar", ".pth", ".tar"))):
        raise SystemExit(f"--pretrain {args.pretrain}: the port reads a .pth.tar in the "
                         "reference layout, not an orbax directory of the JAX trainer "
                         "(export one with python -m temporalalignnet_tpu.tools.export_torch)")


def load_pretrain(path: str, model) -> dict:
    """``--pretrain``: a reference-layout ``.pth.tar`` merged non-strictly into
    ``model``'s state_dict, the merge report printed."""
    import torch

    from temporalalignnet_torch.checkpoint import merge_state_dict

    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    merged, report = merge_state_dict(model.state_dict(), ckpt.get("state_dict", ckpt))
    for line in report:
        print(f"[pretrain] {line}", flush=True)
    return merged


def main(argv: Optional[list] = None) -> dict:
    args = build_parser().parse_args(argv)
    _refuse_later_flags(args)
    if args.model == "cotrain":  # the cotrain preset (train/main.py:361-363)
        args.learn_agreement = 1
        args.use_alignability_head = 1

    import torch

    from temporalalignnet_torch.checkpoint import save_reference_checkpoint
    from temporalalignnet_torch.core.config import (
        DataConfig, EvalConfig, LossConfig, ModelConfig, Precision, TrainConfig)
    from temporalalignnet_torch.data import HTMAlignDataset, HTMFeatureDataset, TrainLoader
    from temporalalignnet_torch.eval.align import AlignmentEvaluator
    from temporalalignnet_torch.models.net import TANWithText
    from temporalalignnet_torch.models.word2vec import Word2VecTokenizer
    from temporalalignnet_torch.train.optimizer import Optimizer, lr_at
    from temporalalignnet_torch.train.train_step import EMATwin, make_train_step

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device here (pass --device cpu for the CPU path)")
    compute = torch.float32 if args.f32 or device.type == "cpu" else Precision().compute
    fused = resolve_fused_milnce(args.fused_milnce, device.type)
    if args.fused_milnce == "auto":
        print(f"[fused_milnce] auto -> {int(fused)}", flush=True)

    mcfg = ModelConfig(
        width=args.width, heads=args.heads, num_encoder_layers=args.num_encoder_layers,
        num_joint_layers=args.num_joint_layers, video_embed_dim=args.video_embed_dim,
        language_model=args.language_model, pos_enc=args.pos_enc,
        use_text_pos_enc=bool(args.use_text_pos_enc),
        use_alignability_head=bool(args.use_alignability_head), fused_milnce=fused)
    loss_cfg = LossConfig(
        model=args.model, sim=args.sim, learn_agreement=bool(args.learn_agreement),
        temporal_agreement_type=args.temporal_agreement_type, loss_threshold=args.loss_threshold,
        use_alignability_head=bool(args.use_alignability_head),
        optim_policy=args.optim_policy, use_fused_milnce=fused)
    tokenizer = Word2VecTokenizer(args.vocab, max_words=args.max_words)
    dcfg = DataConfig(seq_len=args.seq_len, max_sentences=args.max_sentences,
                      max_words=args.max_words)
    dataset = HTMFeatureDataset(args.feature_dir, args.captions, dcfg, "train", tokenizer,
                                holdout=args.holdout)
    if len(dataset) == 0:
        raise SystemExit("no training videos after filtering")
    if len(dataset) < args.batch_size:
        print(f"WARNING: dataset ({len(dataset)} videos) smaller than --batch_size "
              f"{args.batch_size}; with drop_last every epoch would be empty — clamping")
        args.batch_size = len(dataset)
    steps_per_epoch = max(len(dataset) // args.batch_size, 1)
    tcfg = TrainConfig(
        lr=args.lr, wd=args.wd, warmup_iterations=args.warmup_iterations,
        total_iterations=steps_per_epoch * args.epochs, backprop_freq=args.backprop_freq,
        clip_grad_norm=args.clip_grad_norm, clip_mode=args.clip_mode,
        skip_nonfinite_updates=bool(args.skip_nonfinite), ema_momentum=args.momentum_m,
        seed=args.seed)

    exp_dir = os.path.join(args.prefix, experiment_name(args))
    os.makedirs(exp_dir, exist_ok=True)
    with open(os.path.join(exp_dir, "running_command.txt"), "a") as f:
        f.write(json.dumps(vars(args)) + "\n")
    ckpt_path = os.path.join(exp_dir, "latest.pth.tar")

    model = TANWithText(mcfg, vocab_size=tokenizer.vocab_size)
    model.init_weights(torch.Generator().manual_seed(args.seed))
    if args.pretrain:
        model.load_state_dict(load_pretrain(args.pretrain, model), strict=True)
    model.to(device)
    # the target starts as a copy of the online weights (train/main.py:463-484)
    twin = EMATwin(model, tcfg) if args.model == "cotrain" else None
    optimizer = Optimizer(model, tcfg, policy=args.optim_policy)
    step_fn = make_train_step(model, optimizer, tcfg, loss_cfg, compute_dtype=compute, twin=twin)
    loader = TrainLoader(dataset, args.batch_size, seed=args.seed,
                         num_workers=args.num_workers, pin_memory=device.type == "cuda")

    align_corpus = None

    def evaluate_downstream() -> dict:
        nonlocal align_corpus
        if not args.align_anno:
            return {}
        if align_corpus is None:
            align_corpus = list(HTMAlignDataset(args.align_features or args.feature_dir,
                                                args.align_anno, tokenizer, args.max_words))
        ev = AlignmentEvaluator(model, EvalConfig(seq_len=args.seq_len))
        with torch.no_grad(), torch.autocast(device.type, dtype=compute,
                                             enabled=compute != torch.float32):
            metrics = ev.evaluate(align_corpus)
        print(json.dumps({"eval_step": global_step, **metrics}), flush=True)
        return metrics

    global_step, last_loss, final_metrics = 0, float("nan"), {}
    t_log, steps_since = time.perf_counter(), 0
    stop = False
    for epoch in range(args.epochs):
        loader.set_epoch(epoch)
        for batch in loader:
            metrics = step_fn(batch)
            last_loss = float(metrics["loss"])  # fences the step
            global_step += 1
            steps_since += 1
            if global_step % args.log_every == 0:
                now = time.perf_counter()
                row = {"step": global_step, "epoch": epoch,
                       **{k: float(v) for k, v in metrics.items()},
                       "lr": lr_at(tcfg, max(optimizer.updates - 1, 0)),
                       "steps_per_s": steps_since / (now - t_log)}
                print(json.dumps(row), flush=True)
                t_log, steps_since = now, 0
            if args.max_steps and global_step >= args.max_steps:
                stop = True
                break
        if (epoch + 1) % args.eval_every_epochs == 0 or stop:
            final_metrics = evaluate_downstream()
        save_reference_checkpoint(ckpt_path, model, optimizer, epoch=epoch,
                                  iteration=global_step,
                                  target=twin.model if twin is not None else None)
        if stop:
            break
    out = {"final_step": global_step, "loss": last_loss,
           "loss_finite": math.isfinite(last_loss), "checkpoint": ckpt_path, **final_metrics}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
