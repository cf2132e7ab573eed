"""Training CLI, Stage 1 and Stage 2 (counterpart of
temporalalignnet_tpu/train/cli.py; reference train/main.py):

  python -m temporalalignnet_torch.train --model init \\
      --feature_dir <dir> --captions sentencified_htm_370k.json --vocab s3d_dict.npy
  python -m temporalalignnet_torch.train --model cotrain --pretrain <stage1>/latest.pth.tar \\
      --feature_dir <dir> --captions sentencified_htm_370k.json --vocab s3d_dict.npy
  ... --resume auto            # continue the newest checkpoint of this experiment
  ... --test <ckpt.pth.tar>    # only the downstream evals of a checkpoint

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
``--device cpu`` runs the plain PyTorch path in f32.  Prints one JSON line
per ``--log_every`` steps, one per downstream eval and a final one.

Checkpoints (``checkpoint/io.py``), under ``<prefix>/<experiment>/``:
- ``runtime/``: every ``--runtime_save_iter`` steps (only the newest kept),
  each followed by the downstream evals;
- ``epoch/``: at each epoch end and at the ``--max_steps`` stop, the 5 with
  the best HTM-Align ``Recall`` kept (0.0 for an epoch without an eval);
- ``latest.pth.tar``: the same weights in the reference layout
  ``{epoch, state_dict, best_acc, optimizer, iteration}`` (with cotrain the
  twin's ``online.*`` / ``target.*`` keys), which the eval CLI and
  ``--pretrain`` read.
The runtime and epoch files add the resume state under ``resume``: the step
counter, the pos-start generator's state and the twin's micro-step count,
beside the full optimizer state (AdamW's moments, the counters and the
``--backprop_freq`` accumulator).  ``--resume`` (``auto``: this experiment;
or a directory, or one such file) restores all of it and continues at
epoch = step // steps_per_epoch, batch = step % steps_per_epoch, so the
resumed run equals the uninterrupted one.  A ``.pth.tar`` without that
state, such as a reference checkpoint, is refused (use it with
``--pretrain``).

Downstream evals: HTM-Align (``--align_anno``) and, unless ``--optim_policy
bce``, YouCook2 retrieval (``--yc2_anno``; train/main.py:165-212).

``--language_model bert --bert_dir <dir>`` trains a BERT TAN (text dim
768 for bert-base-uncased): the directory's config.json and vocab.txt give
the tower and the tokenizer (``models/bert.py``), and its
``model.safetensors`` or ``pytorch_model.bin``, where there is one, the
tower's starting weights (``[bert]`` lines report the merge; without one
BERT trains from its own init).  BERT is trained whole, word embeddings
included.

``--milnce_ckpt s3d_howto100m.pth`` starts the word2vec tower from the
MIL-NCE weights, as the reference always does (word2vec_model.py:10-23),
before ``--pretrain``, the optimizer and the EMA twin's copy; its merge is
printed as ``[milnce]`` lines.  ``--remat 1`` recomputes every encoder block
in the backward (less activation memory, the same numbers).
``--cache_videos N`` keeps N videos' memmaps, captions and token ids on the
host (0: none).  ``--profile_dir`` writes a torch.profiler trace of the
training loop there.  Besides the JSON lines on stdout, the trainer writes
``train/*`` scalars (the step's metrics, ``device/sps``, the loop's
data / dispatch / fence shares and the card's memory) every ``--log_every``
steps and ``eval/*`` at each downstream eval to
``<experiment>/train.metrics.jsonl`` (and TensorBoard where tensorboardX is
installed), and a progress line to stderr.

``--steps_per_dispatch K`` runs K steps per dispatch (JAX's ``lax.scan``
over stacked batches): on the card one CUDA graph of the whole step,
replayed per batch (``train_step.make_multi_train_step``), on the CPU K
eager steps; the same numbers as K single steps.  The save, eval and stop
checks run once per group, so the last group may run past ``--max_steps``
(a ``[stop]`` line says by how much); an epoch's tail group is shorter.  On
the card it refuses ``--backprop_freq > 1`` and ``--skip_nonfinite``.

Data parallelism (JAX train/cli.py:113-130, 190-196, 340-351): one process
per card, started by torchrun (``torchrun --nproc_per_node N -m
temporalalignnet_torch.train --multihost ...``) or by hand with
``--multihost --coordinator host:port --num_processes N --process_id i``
in each; ``--dp`` is -1 or the number of processes.  ``--batch_size`` is
the global batch: each process builds its rows of it (a
``[multihost] process i/n builds batch rows [lo, hi)`` line) and the step
runs on the global batch (``train/train_step.py``).  Process i takes
``cuda:LOCAL_RANK`` (or the card ``--device`` names).  Only process 0
writes checkpoints, the metrics log and the log lines; the downstream evals
split their forward calls over the processes.

Tensor parallelism (JAX train/cli.py:130, 327, 340): ``--tp T`` shards the
encoder blocks' attention heads and MLPs over T processes
(``parallel/tensor.py``; JAX's ``_TP_RULES``), and ``--dp`` is then the
number of processes over T (-1: all of them).  Process r is dp index r // T
and tp index r % T; the T processes of one dp index build the same batch
rows.  ``--tp`` must divide ``--heads``, ``--width`` and 4 x ``--width``.
The checkpoints hold the gathered weights and optimizer state, the tp = 1
key space: the eval CLI and a run at any ``--tp`` read them.

``--steps_per_dispatch > 1`` on the card runs under an NCCL process group
too (the graph holds the collectives); it refuses a gloo group and
``--tp > 1``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
from typing import Optional


def build_parser() -> argparse.ArgumentParser:
    from temporalalignnet_torch.parallel.distributed import add_multihost_flags

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
    p.add_argument("--remat", type=int, default=0,
                   help="recompute each encoder block in the backward (activation memory)")
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
    p.add_argument("--vocab", default=None,
                   help="word list .npy (s3d_dict format), for --language_model word2vec")
    p.add_argument("--bert_dir", default=None,
                   help="HF BERT directory (config.json, vocab.txt, optionally "
                        "model.safetensors or pytorch_model.bin) for --language_model bert")
    p.add_argument("--milnce_ckpt", default=None,
                   help="s3d_howto100m.pth: start the word2vec tower from the MIL-NCE weights")
    p.add_argument("--seq_len", type=int, default=64)
    p.add_argument("--max_sentences", type=int, default=16)
    p.add_argument("--max_words", type=int, default=32)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--cache_videos", type=int, default=256,
                   help="per-video host cache (feature memmaps, captions, token ids; the "
                        "same samples); 0 disables")
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
    p.add_argument("--resume", default=None,
                   help="auto (this experiment's newest checkpoint), an experiment "
                        "directory, or a runtime/epoch checkpoint file of this trainer")
    p.add_argument("--pretrain", default=None,
                   help="a .pth.tar (reference layout, plain or twin) to start from")
    p.add_argument("--test", default=None,
                   help="a .pth.tar: run the downstream evals on it and exit")
    p.add_argument("--runtime_save_iter", type=int, default=1000,
                   help="runtime checkpoint + downstream evals every N steps (0: never)")
    p.add_argument("--eval_every_epochs", type=int, default=1)
    p.add_argument("--log_every", type=int, default=5)
    p.add_argument("--max_steps", type=int, default=0, help="stop after N steps")
    p.add_argument("--align_anno", default=None, help="htm_align.json for downstream eval")
    p.add_argument("--align_features", default=None)
    p.add_argument("--yc2_anno", default=None)
    p.add_argument("--yc2_features", default=None)
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler trace of the training loop here")
    p.add_argument("--steps_per_dispatch", type=int, default=1,
                   help="train steps per dispatch: a CUDA graph of the step replayed per "
                        "batch on the card; checkpoints, evals and the stop once per group")
    p.add_argument("--dp", type=int, default=-1,
                   help="data-parallel size: -1 or the number of processes")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel size: the encoder blocks sharded over this many "
                        "processes")
    add_multihost_flags(p)
    return p


def resolve_fused_milnce(flag: str, device_type: str) -> bool:
    """'auto' -> on for CUDA (the kernels take any shape), off for the CPU."""
    return device_type == "cuda" if flag == "auto" else flag == "1"


def experiment_name(args) -> str:
    """Hyperparams-in-dirname convention (reference train/config.py:69-74)."""
    return (f"{args.name_prefix}{args.model}_{args.language_model}_len{args.seq_len}"
            f"_e{args.num_encoder_layers}d{args.num_joint_layers}_bs{args.batch_size}"
            f"_lr{args.lr}")


def _refuse_pretrain_dirs(args) -> None:
    if args.pretrain and (os.path.isdir(args.pretrain)
                          or not args.pretrain.endswith((".pth.tar", ".pth", ".tar"))):
        raise SystemExit(f"--pretrain {args.pretrain}: the port reads a .pth.tar in the "
                         "reference layout, not an orbax directory of the JAX trainer "
                         "(export one with python -m temporalalignnet_tpu.tools.export_torch)")


def load_bert_weights(bert_dir, model) -> None:
    """``--bert_dir``'s weights, where it has a weight file, merged
    non-strictly into the BERT tower (``bert``), the merge printed as
    ``[bert]`` lines (JAX train/cli.py:426-458)."""
    from temporalalignnet_torch.checkpoint import merge_into

    if bert_dir.weights is None:
        print(f"[bert] no weight file in {bert_dir.path}; "
              "training from scratch", flush=True)
        return
    print(f"[bert] {bert_dir.weight_file}", flush=True)
    for line in bert_dir.report + merge_into(model.bert, bert_dir.weights, "bert"):
        print(f"[bert] {line}", flush=True)


def load_milnce_text(path: str, model) -> None:
    """``--milnce_ckpt``: the MIL-NCE word2vec tower of an s3d_howto100m.pth
    merged non-strictly into the language model (``bert``), the merge
    printed as ``[milnce]`` lines (JAX train/cli.py:469-490)."""
    from temporalalignnet_torch.checkpoint import load_milnce_checkpoint, merge_into

    text = load_milnce_checkpoint(path)["text"]
    if text:
        for line in merge_into(model.bert, text, "bert"):
            print(f"[milnce] {line}", flush=True)


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


def read_resume_state(spec: str, ckpt) -> dict:
    """``--resume``: ``auto`` (the experiment's Checkpointer ``ckpt``), another
    experiment directory (its newest runtime or epoch checkpoint, looked up
    without changing it) or one checkpoint file.  Refuses a file without this
    trainer's resume state."""
    import torch

    from temporalalignnet_torch.checkpoint import latest

    path = spec
    if spec == "auto" or os.path.isdir(spec):
        found = ckpt.latest() if spec == "auto" else latest(spec)
        if found is None:
            raise SystemExit(f"--resume {spec}: no checkpoint found")
        path = found[1]
    state = torch.load(path, map_location="cpu", weights_only=True)
    if "resume" not in state or "adamw" not in state.get("optimizer", {}):
        raise SystemExit(f"--resume {path}: the file holds no resume state of this trainer "
                         "(its step, optimizer state and generator); a reference "
                         "checkpoint can start a run with --pretrain, not continue one")
    print(f"[resume] {path}", flush=True)
    return state


def restore_training(state: dict, model, optimizer, step_fn, twin) -> int:
    """Weights, optimizer, pos-start generator and twin from a checkpoint the
    trainer wrote (a tensor-parallel model takes its shard); returns its
    step."""
    from temporalalignnet_torch.parallel.tensor import shard_for

    sd = shard_for(model, state["state_dict"])
    halves = {p: {k[len(p):]: v for k, v in sd.items() if k.startswith(p)}
              for p in ("online.", "target.")}
    if (twin is not None) != bool(halves["target."]):
        raise SystemExit("--resume: a cotrain checkpoint resumes --model cotrain, and only it")
    if twin is not None:
        model.load_state_dict(halves["online."], strict=True)
        twin.model.load_state_dict(halves["target."], strict=True)
        twin.load_state_dict(state["resume"]["twin"])
    else:
        model.load_state_dict(sd, strict=True)
    optimizer.load_state_dict(state["optimizer"])
    step_fn.generator.set_state(state["resume"]["generator"])
    return int(state["resume"]["step"])


def main(argv: Optional[list] = None) -> dict:
    args = build_parser().parse_args(argv)
    _refuse_pretrain_dirs(args)
    if args.model == "cotrain":  # the cotrain preset (train/main.py:361-363)
        args.learn_agreement = 1
        args.use_alignability_head = 1

    import torch

    from temporalalignnet_torch.parallel import distributed
    from temporalalignnet_torch.parallel.mesh import make_mesh

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device here (pass --device cpu for the CPU path)")
    started = distributed.start_multihost(args)
    try:
        try:
            mesh = make_mesh(args.dp, args.tp)
        except ValueError as e:
            raise SystemExit(str(e)) from None
        return _train(args, mesh)
    finally:
        if started:
            distributed.destroy()


def _train(args, mesh) -> dict:
    import torch

    from temporalalignnet_torch.checkpoint import (Checkpointer, atomic_save,
                                                   load_reference_checkpoint,
                                                   reference_checkpoint)
    from temporalalignnet_torch.core.config import (
        DataConfig, EvalConfig, LossConfig, ModelConfig, Precision, TrainConfig)
    from temporalalignnet_torch.data import (HTMAlignDataset, HTMFeatureDataset, TrainLoader,
                                             YC2RetrievalDataset)
    from temporalalignnet_torch.eval.align import AlignmentEvaluator
    from temporalalignnet_torch.eval.retrieval import RetrievalEvaluator
    from temporalalignnet_torch.models.bert import load_bert_dir
    from temporalalignnet_torch.models.net import TANWithText
    from temporalalignnet_torch.models.word2vec import Word2VecTokenizer
    from temporalalignnet_torch.train.optimizer import Optimizer, lr_at
    from temporalalignnet_torch.train.train_step import (EMATwin, make_multi_train_step,
                                                         make_train_step)
    from temporalalignnet_torch.parallel.distributed import (barrier, is_master, master_print,
                                                             process_device, rank, world_size)
    from temporalalignnet_torch.parallel.mesh import local_batch_rows
    from temporalalignnet_torch.parallel.tensor import shard_model_
    from temporalalignnet_torch.utils import (AverageMeter, MetricsWriter, ProgressMeter,
                                              StepBreakdown, StepTimer, device_memory_stats,
                                              trace)

    group = mesh.dp_group  # the loss's global batch and the gradient average
    device = process_device(args.device)
    compute = torch.float32 if args.f32 or device.type == "cpu" else Precision().compute
    fused = resolve_fused_milnce(args.fused_milnce, device.type)
    if args.fused_milnce == "auto":
        print(f"[fused_milnce] auto -> {int(fused)}", flush=True)

    mcfg = ModelConfig(
        width=args.width, heads=args.heads, num_encoder_layers=args.num_encoder_layers,
        num_joint_layers=args.num_joint_layers, video_embed_dim=args.video_embed_dim,
        language_model=args.language_model, pos_enc=args.pos_enc,
        use_text_pos_enc=bool(args.use_text_pos_enc),
        use_alignability_head=bool(args.use_alignability_head), fused_milnce=fused,
        remat=bool(args.remat))
    loss_cfg = LossConfig(
        model=args.model, sim=args.sim, learn_agreement=bool(args.learn_agreement),
        temporal_agreement_type=args.temporal_agreement_type, loss_threshold=args.loss_threshold,
        use_alignability_head=bool(args.use_alignability_head),
        optim_policy=args.optim_policy, use_fused_milnce=fused)
    bert_dir = None
    if args.language_model == "bert":  # tokenizer and config (train/main.py:291-292)
        if not args.bert_dir:
            raise SystemExit("--language_model bert requires --bert_dir")
        try:
            bert_dir = load_bert_dir(args.bert_dir)
        except ValueError as e:
            raise SystemExit(f"--bert_dir: {e}") from None
        tokenizer = bert_dir.tokenizer
    elif args.vocab:
        tokenizer = Word2VecTokenizer(args.vocab, max_words=args.max_words)
    else:
        raise SystemExit("--vocab is required (s3d_dict.npy word list)")
    dcfg = DataConfig(seq_len=args.seq_len, max_sentences=args.max_sentences,
                      max_words=args.max_words)
    dataset = HTMFeatureDataset(args.feature_dir, args.captions, dcfg, "train", tokenizer,
                                holdout=args.holdout, cache_videos=args.cache_videos)
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
    if is_master():  # side effects on process 0 only (main_nce.py:119, 406-407)
        os.makedirs(exp_dir, exist_ok=True)
        with open(os.path.join(exp_dir, "running_command.txt"), "a") as f:
            f.write(json.dumps(vars(args)) + "\n")
    ckpt_path = os.path.join(exp_dir, "latest.pth.tar")
    # every process derives the same epoch order and builds only its rows
    local_rows = None
    if group is not None:
        try:
            local_rows = local_batch_rows(args.batch_size, group)
        except ValueError as e:
            raise SystemExit(f"--batch_size: {e}") from None
        tp_index = f" (dp index {rank(group)}, tp index {rank(mesh.tp_group)})" \
            if mesh.tp_group is not None else ""
        print(f"[multihost] process {rank()}/{world_size()}{tp_index} "
              f"builds batch rows [{local_rows[0]}, {local_rows[1]})", flush=True)

    model = TANWithText(mcfg, vocab_size=tokenizer.vocab_size,
                        bert_config=bert_dir.config if bert_dir else None)
    model.init_weights(torch.Generator().manual_seed(args.seed))
    if bert_dir is not None:
        load_bert_weights(bert_dir, model)
    if args.milnce_ckpt:
        load_milnce_text(args.milnce_ckpt, model)
    if args.pretrain:
        model.load_state_dict(load_pretrain(args.pretrain, model), strict=True)
    if args.test:
        load_reference_checkpoint(args.test, model)
    model.to(device)
    if mesh.tp_group is not None:  # this process's shard of the encoder blocks
        try:
            shard_model_(model, mesh.tp_group)
        except ValueError as e:  # --tp does not divide the heads or the widths
            raise SystemExit(str(e)) from None

    eval_cache: dict = {}
    best_acc = 0.0  # the best HTM-Align Recall so far, the reference's best_acc
    writer = None  # the MetricsWriter of the training loop

    def evaluate_downstream(step: int) -> dict:
        """HTM-Align and, unless --optim_policy bce, YC2 retrieval
        (train/main.py:165-212), on the online model."""
        nonlocal best_acc
        sets = []
        if args.align_anno:
            sets.append(("align", lambda: list(HTMAlignDataset(
                args.align_features or args.feature_dir, args.align_anno, tokenizer,
                args.max_words)), AlignmentEvaluator))
        if args.yc2_anno and args.optim_policy != "bce":  # bce skips YC2 (main.py:196-197)
            sets.append(("yc2", lambda: list(YC2RetrievalDataset(
                args.yc2_features or args.feature_dir, args.yc2_anno, "val", tokenizer,
                args.max_words)), RetrievalEvaluator))
        metrics = {}
        for name, load, evaluator in sets:
            if name not in eval_cache:
                eval_cache[name] = load()
            ev = evaluator(model, EvalConfig(seq_len=args.seq_len), group)
            with torch.no_grad(), torch.autocast(device.type, dtype=compute,
                                                 enabled=compute != torch.float32):
                metrics.update(ev.evaluate(eval_cache[name]))
        if metrics:
            master_print(json.dumps({"eval_step": step, **metrics}), flush=True)
            if writer is not None:
                writer.add_scalars(step, metrics, prefix="eval/")
        best_acc = max(best_acc, metrics.get("Recall", 0.0))
        return metrics

    if args.test:
        return evaluate_downstream(0)

    # the target starts as a copy of the online weights (train/main.py:463-484)
    twin = EMATwin(model, tcfg) if args.model == "cotrain" else None
    optimizer = Optimizer(model, tcfg, policy=args.optim_policy)
    k_disp = args.steps_per_dispatch
    if k_disp < 1:
        raise SystemExit(f"--steps_per_dispatch {k_disp}: must be at least 1")
    try:
        step_fn = (make_multi_train_step if k_disp > 1 else make_train_step)(
            model, optimizer, tcfg, loss_cfg, compute_dtype=compute, twin=twin, group=group)
    except ValueError as e:
        raise SystemExit(f"--steps_per_dispatch {k_disp}: {e}") from None
    loader = TrainLoader(dataset, args.batch_size, seed=args.seed,
                         num_workers=args.num_workers, pin_memory=device.type == "cuda",
                         local_rows=local_rows)
    ckpt = Checkpointer(exp_dir)
    global_step = 0
    if args.resume:
        state = read_resume_state(args.resume, ckpt)
        global_step = restore_training(state, model, optimizer, step_fn, twin)
        best_acc = float(state["best_acc"])
    # a runtime checkpoint's step also gives the position within its epoch
    start_epoch, start_batch = divmod(global_step, steps_per_epoch)
    if args.resume:
        master_print(f"[resume] at step {global_step} (epoch {start_epoch}, batch "
                     f"{start_batch})", flush=True)

    def training_state(epoch: int) -> dict:
        """The reference layout, plus what an exact resume needs."""
        state = reference_checkpoint(model, optimizer, epoch=epoch, iteration=global_step,
                                     best_acc=best_acc,
                                     target=twin.model if twin is not None else None)
        state["resume"] = {"step": global_step, "generator": step_fn.generator.get_state(),
                           "twin": twin.state_dict() if twin is not None else None}
        return state

    last_loss, final_metrics = float("nan"), {}
    t_log, steps_since = time.perf_counter(), 0
    stop = global_step >= args.max_steps > 0
    last_check = global_step
    writer = MetricsWriter(exp_dir)
    timer, breakdown = StepTimer(), StepBreakdown()
    loss_meter, data_meter = AverageMeter("loss", ":.4f"), AverageMeter("data", ":.3f")
    with trace(args.profile_dir):
        for epoch in range(start_epoch, args.epochs):
            if stop:
                break
            loader.set_epoch(epoch, start_batch if epoch == start_epoch else 0)
            progress = ProgressMeter(len(loader), [loss_meter, data_meter],
                                     prefix=f"Epoch {epoch} ")
            # the batches this epoch yields: a resumed epoch starts at start_batch, so
            # its tail group is flushed by this count, not by len(loader)
            n_yield = len(loader) - (start_batch if epoch == start_epoch else 0)
            pending = []
            t_data = time.perf_counter()
            for it, batch in enumerate(loader):
                dt_data = time.perf_counter() - t_data
                breakdown.add("data", dt_data)
                data_meter.update(dt_data)
                if k_disp == 1:
                    with breakdown.measure("dispatch"):
                        metrics = step_fn(batch)
                    with breakdown.measure("fence"):
                        loss = float(metrics["loss"])  # fences the step
                    rows = [(metrics, loss, optimizer.updates)]
                else:
                    pending.append(batch)
                    if len(pending) < k_disp and it < n_yield - 1:
                        t_data = time.perf_counter()
                        continue
                    with breakdown.measure("dispatch"):
                        stacked = step_fn(pending)
                    pending = []
                    with breakdown.measure("fence"):  # one fetch fences the group
                        host = torch.stack(list(stacked.values())).cpu()
                    rows = [({k: host[j, i] for j, k in enumerate(stacked)},
                             float(host[list(stacked).index("loss"), i]), u)
                            for i, u in enumerate(step_fn.updates_after)]
                for metrics, last_loss, updates in rows:
                    global_step += 1
                    steps_since += 1
                    if math.isfinite(last_loss):  # NaN kept out of the meter (main.py:108-109)
                        loss_meter.update(last_loss)
                    sps = timer.tick()
                    if global_step % args.log_every == 0:
                        now = time.perf_counter()
                        scalars = {k: float(v) for k, v in metrics.items()}
                        row = {"step": global_step, "epoch": epoch, **scalars,
                               "lr": lr_at(tcfg, max(updates - 1, 0)),
                               "steps_per_s": steps_since / (now - t_log)}
                        master_print(json.dumps(row), flush=True)
                        t_log, steps_since = now, 0
                        scalars["device/sps"] = sps
                        scalars.update({f"device/{k}": v
                                        for k, v in breakdown.snapshot().items()})
                        scalars.update({f"device/{k}": v
                                        for k, v in device_memory_stats().items()})
                        writer.add_scalars(global_step, scalars, prefix="train/")
                        if is_master():
                            progress.display(it)
                # checkpoints, evals and the stop once per group: a boundary that a
                # group crossed fires here (the state exists per group only)
                rsi = args.runtime_save_iter
                if rsi and global_step // rsi > last_check // rsi:
                    t_save = time.perf_counter()
                    path = ckpt.save_runtime(training_state(epoch), global_step)
                    master_print(json.dumps({"runtime_checkpoint": path, "at_step": global_step,
                                             "seconds": time.perf_counter() - t_save}),
                                 flush=True)
                    evaluate_downstream(global_step)
                last_check = global_step
                if args.max_steps and global_step >= args.max_steps:
                    if global_step > args.max_steps:
                        print(f"[stop] --steps_per_dispatch group overshot --max_steps "
                              f"{args.max_steps} by {global_step - args.max_steps} steps "
                              f"(stopped at {global_step})", flush=True)
                    stop = True
                    break
                t_data = time.perf_counter()
            epoch_metrics = (evaluate_downstream(global_step)
                             if (epoch + 1) % args.eval_every_epochs == 0 or stop else {})
            final_metrics = epoch_metrics or final_metrics
            state = training_state(epoch)
            ckpt.save_epoch(state, epoch, epoch_metrics)
            del state["resume"]
            if is_master():
                atomic_save(state, ckpt_path)
            barrier()
    writer.close()
    out = {"final_step": global_step, "loss": last_loss,
           "loss_finite": math.isfinite(last_loss), "checkpoint": ckpt_path, **final_metrics}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
