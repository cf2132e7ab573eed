#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100): builds every
kernel, holds each against its plain PyTorch version, drives the zero-shot
HTM-Align evaluation, the Stage-1 training, the YouCook2 retrieval, the
Stage-2 co-training, a stopped-and-resumed training run, rematerialized
training and training from a MIL-NCE text tower of the full-width E6D6 TAN
through the kernels, the raw-feature MIL-NCE baseline, the HTM-AA product
path (S3D features, HTM-AA generation, the end-to-end S3D fine-tune, a
linear probe), the BERT TAN at bert-base-uncased's widths (training, both
CLIs), the CLIP baseline and the CLIP and TimeSformer feature extractors,
data-parallel training and sharded evaluation (two ranks on the card by
gloo, a world of one by NCCL, also as a CUDA graph), tensor parallelism
(two ranks by gloo), the offline text pipeline's BERT punctuator and the
cross-attention decoder stack, and times them.

    python3 chip_smoke.py

Phases, each printing JSON lines:
  1. build   nvcc builds temporalalignnet_torch/csrc/*.cu into build/torch_kernels/.
  2. kernel  mha_fwd against attention_reference on the card at the shapes the
             eval, train and tower paths give it (TOWER_SHAPES: BERT's
             [1024, 12, 32, 64] with every fourth row fully padded, CLIP's
             [256, 12, 50, 64], TimeSformer's [784, 12, 8, 64] and
             [32, 12, 197, 64]), ragged key masks, on each route:
             bf16 "short" (S = 64, 72, 80, 37), bf16 "long" (S = 200 and the
             global method's [1, 8, 1088, 64], with key splits), "f32" at all
             of them; then at the retrieval buckets S = 32, 96, 128 (short),
             160 and 256 (long) with the retrieval's key padding (S - 31
             valid keys, one row with 1), [250, 8, S, 64] and one-clip calls
             [10, 8, S, 64] on the long route; the route each call took is
             checked, and a planted fault (padded keys left unmasked) must
             exceed the bf16 limit; in f32 at the training shapes the plain
             version in single-pass TF32 (allow_tf32) must exceed F32_TOL.
     kernel_bwd  mha_bwd (dq, dk, dv) against mha_bwd_reference, the plain
             version with the kernel's bf16 roundings, per element
             (GRAD_TOL); planted faults must exceed the limit.  Each route:
             bf16 "fused" at the training shapes, BERT's and an odd S, bf16 "long"
             at S = 200 and 144 (two calls bit-equal), "f32" at all of them
             (at the training shapes also the plain version in single-pass
             TF32 as a planted fault); the route each call took is checked.
     kernel_milnce  milnce_fwd against milnce_reference (the loss's
             elements) and its four logsumexps against milnce_lse_reference,
             milnce_dv and milnce_dt against milnce_grad_reference, at the
             B = 64 training shape (shared and per-layer text), at the shapes
             where the JAX package takes its column-tiled kernels (B = 128;
             K = 5120) and at a small one whose video gradient splits its
             column stream, f32 and bf16; planted faults as above (for the
             forward: padded columns left unmasked, the last row block left
             out of the column logsumexps; for the f32 kernels their
             products in single-pass TF32); in f32 the four logsumexps
             also per element in logit units (lse_err) against
             MILNCE_LSE_F32_TOL, which the single-pass fault must exceed;
             the routes of the three (bf16 "wgmma", f32 "f32") are
             checked, and two forward and two gradient calls must be
             bit-equal.
  3. eval    AlignmentEvaluator (overlap-seq and global) on a synthetic corpus,
             random E6D6 weights from a seed, bf16; every overlap-seq
             forward call must launch the kernel 12 times on the "short"
             route, every global one 6 times on the "long" one (the joint
             encoder alone), and the global canvases must equal, to the bit,
             those of the path that also ran the dual encoder (ms of one
             call both ways).  Then the same evaluation in f32 on the card
             and on the CPU must agree.
     decoder  slice 13 (after the eval forward's times, before any child
             runs): models/transformer.py::TemporalDecoder at the TAN's
             width (DECODER: 512, 8 heads, 6 blocks) over B = 64 windows of
             T = 64 video tokens (the last quarter of each padded) and a
             ragged memory of M = 16 tokens: f32 taps and gradients (every
             parameter, x, the memory) on the card against the CPU
             (F32_STEP_TOL), bf16 (autocast) against the plain attention on
             the card (TRAIN_GRAD_TOL, norm-relative), the padded memory
             rows set to 999 leaving the taps as they were; each forward
             launching mha_fwd 6 times (short; f32), each backward mha_bwd 6
             (fused; f32), no MIL-NCE kernel; the cross-attention plain
             (counted).  Its bf16 forward's and forward+backward's device
             ms come from the ``decoder`` step-time child.
     cli     python -m temporalalignnet_torch.eval on a .pth.tar of that model
             and a corpus written to build/chip_smoke_cli/, against the
             in-process evaluator.
     train   Stage-1 training of the E6D6 TAN at B = 64, bf16, fused MIL-NCE,
             on synthetic HowTo100M-format features and captions written to
             build/chip_smoke_train/: finite losses, and every step launches
             mha_fwd and mha_bwd 12 times (on the short and fused routes) and
             each MIL-NCE kernel twice (on the wgmma route).  The
             fused path against the plain-logits path on the card (bf16), and
             an f32 step on the card against the CPU's.
     train_t128  the same model at T = 128 (joint S = 144): T128_STEPS bf16
             steps launching mha_bwd 6 times on the fused route (the dual
             encoder) and 6 on the long one (the joint encoder), two kernel
             steps against two plain ones (attention_reference and the plain
             logits) at the train phase's limits; then two f32 steps, every
             kernel on its f32 route.
     train_cli  python -m temporalalignnet_torch.train --max_steps on those
             files, then python -m temporalalignnet_torch.eval on the
             .pth.tar it wrote: --task align, and at the same time --task
             retrieval on the YC2 corpus below (checked in retrieval_cli).
             Beside them since slice 13 the train CLI at --seq_len 128 (2
             steps on build/chip_smoke_train_t128/, videos of 128 s or
             more) in a child that counts the wrappers' launches: per step
             12 mha_fwd (6 short, 6 long) and 12 mha_bwd (6 fused for the
             dual encoder, 6 long for the joint encoder's S = 144).
     retrieval  RetrievalEvaluator (10 windows per clip, bf16) on the
             checkpoint train_cli wrote and a synthetic YouCook2-format corpus
             written to build/chip_smoke_yc2/ (64 videos, every window bucket
             Lb = 32 ... 256, both window plans): every forward call must
             launch mha_fwd 6 times on its bucket's route; 12 finite metrics
             with R1 <= R5 <= R10; clips/s and windows/s (the device ms
             of a forward call come with the times).  Then f32 on the card
             against the CPU on 40
             clips: pooled features within RETRIEVAL_F32_TOL, equal metrics.
     retrieval_cli  python -m temporalalignnet_torch.eval --task retrieval on
             the same files (run in train_cli) must print the in-process
             metrics.
     cotrain Stage-2 co-training (EMA twin, agreement targets, head on) of
             the E6D6 TAN at B = 64, bf16, fused, from the train phase's
             Stage-1 state: finite losses, confidence-ratio in [0, 1], every
             step launches mha_fwd 24 times (12 of them the twin's forward),
             mha_bwd 12 times and each MIL-NCE kernel twice, on the short,
             fused and wgmma routes; the target after a step against
             t0·m + online·(1 - m); with backprop_freq = 2 one micro-step
             leaves it bit-equal.  An f32 cotrain step on the card against
             the CPU's (E2D2), and the fused against the plain-logits
             cotrain step at full width in f32 (the kernels' f32 routes),
             each after counting the agreement targets that differ.
     cotrain_cli  python -m temporalalignnet_torch.train --model cotrain
             --pretrain on train_cli's checkpoint, then the eval CLI on the
             twin checkpoint it wrote.
     resume  the train CLI run uninterrupted for 2k steps twice, and stopped
             at step k (a runtime checkpoint there, and the YC2 eval after
             it), each in a process of its own, both cases' at once; then
             continued with --resume auto in a new process, both cases' at
             once: Stage 1
             at E6D6, B = 64, bf16, fused, and cotrain at E2D2 with
             backprop_freq 2 (stopped mid-accumulation); per-step losses and
             final params (with the twin's) must stay within the two
             uninterrupted runs' spread.  Data: build/chip_smoke_resume/.
     cache_videos  10 steps through the data pipeline with the per-video
             host cache off and at 256: seconds_with_data, the same losses.
     remat   E6D6 Stage-1 steps (B = 64, bf16, fused) with every encoder
             block under torch.utils.checkpoint against plain ones from one
             state on one batch: losses, gradients and params bit-equal (or
             within the fused-vs-plain limits); every step launches mha_fwd
             24 times (the backward recomputes each block), mha_bwd 12, each
             MIL-NCE kernel 2; a cotrain step 36 mha_fwd; the peak memory of
             a step at B = 64 and 256, remat on and off, which it must lower.
     milnce_ckpt  the train CLI (3 steps, B = 32) from a synthetic
             s3d_howto100m.pth, Stage 1 and cotrain: when the train step is
             built the language model (and the twin's) holds the file's
             tensors; finite losses; launches per run.
     baseline  the eval CLI without --ckpt (the MIL-NCE baseline, that
             file): --task align by both methods and --task retrieval, f32
             on the card and on the CPU with equal metrics, and bf16.
     profile_dir  the train CLI with --profile_dir and --remat in a child
             (run beside remat, milnce_ckpt and baseline): its trace must
             name the bf16 kernels of mha_fwd, mha_bwd and the MIL-NCE
             forward and gradients; its train.metrics.jsonl must hold a
             line per step.
     s3d     S3D-G (random weights from the seed, random BN statistics) on
             one 16 x 224² clip: f32 on the card against the CPU, the folded
             conv1 against space_to_depth + conv1, bf16 against f32
             (S3D_F32_REL, S3D_BF16_REL on the embedding's relative norm),
             and every block's and BN's output bf16 under autocast.
     e2e_step  the end-to-end train step at full width (32 clips of 16 x
             224², bf16): frozen BN (no port kernel launched), with
             train_bn_stats (the running statistics move) and freeze_early
             (conv1 ... mixed_3c move by the decay alone); two f32 steps of 4
             clips of 8 x 64² on the card against the CPU from one state
             (E2E_* bars), which must move the params.
     htm_aa_pipeline  tools/extract_features.py writes bf16 S3D features of
             16 synthetic videos (build/chip_smoke_htm_aa/);
             tools/generate_htm_aa.py aligns their captions with a random
             E6D6 TAN: bf16 (12 mha_fwd launches per video, short route),
             and f32 on the card against the CPU (the same rows); its csv
             feeds python -m temporalalignnet_torch.train.end2end_cli at its
             default widths (--decoder synthetic, 6 steps, runtime and
             epoch checkpoints, params_latest.pth), which a second 2-step
             run loads with --pretrain; linear_probe on the features, card
             against CPU (the same top-1 and top-5).
     bert    slice 7: build/chip_smoke_bert/ gets an HF BERT directory at
             bert-base-uncased's widths (config.json, a synthetic 30,522-line
             vocab.txt, random pytorch_model.bin weights in HF's key space);
             the E6D6 BERT TAN's f32 forward on the card against the CPU
             (B = 2, N = 4); BERT_STEPS Stage-1 and then cotrain steps at
             B = 64, N = 16, W = 32, bf16, fused, BERT from that file, each
             step launching mha_fwd 24 times (48 in cotrain) and mha_bwd 24
             times (short and fused routes) and each MIL-NCE kernel twice.
     bert_cli  the train CLI with --language_model bert --bert_dir (3 steps
             at B = 16), --model cotrain --pretrain on its checkpoint, then
             the eval CLI's two tasks on the twin checkpoint at once (since
             slice 11 in a thread beside the ranks, its lines printed
             here).
     clip_baseline  the eval CLI's CLIP baseline (--clip_text_ckpt of random
             HF-key-space ViT-B/32 text weights, byte-BPE files, cos) on a
             corpus of 512-d features: f32 card and CPU agree, bf16 runs; the
             causal attention is plain (no launches, counted).
     tower_extract  make_clip_encoder (ViT-B/32, 256 frames a call) and
             make_timesformer_encoder (base, 4 clips of 8 x 224²) from
             random HF-key-space weights: clips/s in bf16 with their
             launches (12 short; 12 short + 12 long), bf16 against f32, f32
             card against CPU (TOWER_BF16_REL, TOWER_F32_REL).
     serving_export  slice 8 (after cotrain_cli): tools/export_eval.py on
             the E6D6 TAN (random weights from the seed) at the bench.py
             workload, bf16 fixed and --poly_batch, f32 fixed: saved,
             loaded and called; SERVE_NODES temporalalignnet::mha_fwd nodes
             in the graph and as many launches per call of the loaded
             program ("short", "f32"), outputs equal to the live model's to
             the bit at B = 192 and 7; the export CLI in a child (started
             beside cotrain_cli); tools/export_torch.py on train_cli's experiment
             directory, its file loaded strict with a forward equal to the
             trained checkpoint's.
     grouped_dispatch  Stage 1 and cotrain (from the train phase's state)
             at B = 64, bf16, and since slice 12 Stage 1 at --backprop_freq
             3, cotrain at --backprop_freq 2 and Stage 1 at --skip_nonfinite
             1 with a non-finite batch (GROUPED_CASES): two groups of
             GROUP_K steps (the first's eager warm-up steps, a capture a
             kind of step, replays of the CUDA graphs) against as many
             eager steps from the same state, equal losses, params, twin,
             update and non-finite counts to the bit; the launches the
             wrappers counted at capture (STEP_LAUNCHES,
             COTRAIN_STEP_LAUNCHES per step), GROUP_K times that on the
             device in a profiled group of replays, one host sync a group;
             in children the train CLI with --steps_per_dispatch GROUP_K
             --max_steps 10 (overshooting to 12, with its [stop] line)
             against --max_steps 12 per step, and with --backprop_freq 2
             grouped against per step.
     dp_two_ranks  slice 9 (started after serving_export, running beside
             the phases up to make_bert_dir, read after it): two children on
             the card joined
             by gloo (initialize_multihost(backend="gloo"); NCCL refuses two
             ranks on one device), the global B = 64 split 32 + 32: Stage-1
             and cotrain steps in f32 and bf16 against the 1-process step
             on the same global batches (loss, per-tensor gradients, params
             and twin; bf16 cotrain with the ranks' agreement targets),
             launches and routes per rank and step, the ranks' results
             equal to the bit; a planted fault (the column logsumexps not
             merged) over GRAD_TOL; the eval CLI's align and retrieval with
             --shard_eval on train_cli's checkpoint against its 1-process
             metrics; one e2e step, frozen BN and train_bn_stats, at E2E in
             bf16 (8 videos a rank; train_bn_stats within DP_SPREAD_FACTOR
             times the 1-process step's spread under a reversed video
             order) and at E2E_DP_SMALL in f64.  Each rank runs the
             1-process steps of half the cases itself.
     dp_world1  the train CLI (E6D6, B = 64, bf16, fused, 4 steps) with
             --multihost in a world of one over NCCL, beside the same run
             without a group (both started after resume, on its files): losses and
             params against each other, the [multihost] line, and in its
             --profile_dir trace NCCL's kernel and the port's per step;
             since slice 10 beside them the same world-of-one run with
             --steps_per_dispatch GROUP_K (the step and its collectives in
             one CUDA graph): losses and params equal to the eager run's to
             the bit, NCCL's kernel once per step, once per replay among the
             kernels the graph launches issued.
     tp_two_ranks  slice 10 (started after profile_dir, running beside
             the phases up to e2e_step): tensor parallelism over
             TP = 2 children on the card joined by gloo, E6D6 width 512, 8
             heads (4 a rank: mha_fwd and mha_bwd on [64, 4, S, 64]), B = 64
             on both ranks: Stage-1 and cotrain steps in f32 and bf16 against
             the 1-process step (loss, norm-relative gradients, the gathered
             params and twin), launches and routes per rank and step
             (12/12/2/2/2, 24 mha_fwd in cotrain), the ranks' gathered
             results and replicated params equal; a planted fault (the
             row-parallel biases added on both ranks) over the bf16 limit.
     punctuate  slice 10 (after tower_extract): python -m
             temporalalignnet_torch.tools.process_htm's main with a
             bert-base punctuator directory (random weights, 15 labels, a
             synthetic vocab) over PUNCT's 16 synthetic videos: every video
             written, 12 mha_fwd launches per predict call on the f32 route,
             tokens/s and the pipeline's seconds; the first videos' logits on
             the card against the CPU (TOWER_F32_REL), their labels (a flip
             only at a near-tie, its margin printed) and sentences.
  4. times   per shape mha_fwd's, the plain version's and PyTorch's SDPA
             time beside the card's bound (K and V counted at the valid keys
             only, ``attention_work``), and the same four times for each
             training kernel at its training shapes (MIL-NCE also at the
             tiled-kernel ones), with the earlier bf16 kernel timed beside
             each redesigned one (mha_fwd and milnce_fwd v1; mha_bwd,
             milnce_dv and milnce_dt v2): these kernel rows run right after
             the kernel phase, before any larger profile, and eval-forward
             windows/s of the bench.py workload right after the eval phase,
             beside the same forward as a loaded torch.export program.
             Last, in child processes (STEP_TIME_CHILDREN), train steps/s
             at B = 64 (Stage 1 and cotrain), each with its device time,
             peak memory and top kernels; e2e steps/s and clips/s at
             E2E with the device time, idle share, peak memory and the bound
             from S3D's multiply-adds; since slice 13 the decoder phase's
             bf16 forward and forward + backward (device ms, ms, idle share); ``--step-times`` adds the rest
             (STEP_TIME_MORE): the device ms of a retrieval forward call at
             Lb = 96 and 256, Stage 1 with --remat, Stage 1 and cotrain as a
             CUDA graph per step (--steps_per_dispatch GROUP_K), Stage 1 at
             --backprop_freq 2 and at --skip_nonfinite 1, eager and graphed
             (with the masked restore's device ms beside its bound), the BERT
             TAN's Stage 1 and cotrain, the bf16 Stage-1 step at T = 128 and
             the f32 one (``step_view``: device ms and steps/s).  In the
             Stage-1 child, after its plain step, the
             same step in a world of one over NCCL (device ms, idle share,
             NCCL's kernel ms per step), and since slice 10 that step and
             the plain one as CUDA graphs (a group of GROUP_K replays:
             steps/s, device ms, idle share, the device launches of the
             port's kernels and NCCL's in a group, profiled).  The kernel
             rows add the f32 routes (F32_TIMED_SHAPES for mha_fwd, the
             punctuator's [4, 12, 258, 64] among them; the training shapes
             for mha_bwd, with SDPA's f32 backward; milnce_fwd, milnce_dv
             and milnce_dt at the training shape), each bound by split TF32
             (SPLIT_PASSES x FLOPs at the TF32 peak) with the bound of f32
             outside the tensor cores beside it; mha_bwd's v2 route at
             [64, 8, 200, 64]; mha_fwd and mha_bwd at the tensor-parallel
             shapes; and, after the eval phase, the device ms of the
             bench.py eval forward in f32 (as eval --f32 runs it, 12 f32
             launches a call).
             Device times come from torch.profiler (a kernel row's only
             when two sessions recorded the same launches); a time without
             such a session is taken with CUDA events and marked
             "timing": "cuda_events".
  5. bench_tools  slice 11, after the step-time children (started with
             them, released one after another): python -m
             temporalalignnet_torch.tools.bench_train_step (B = 64, 3
             warm-up steps and 2 rounds of 10) with --stage 1
             --fused 1, --stage 2 --fused 1 and --stage 1 --fused 0: the
             wrappers' launches over the run must be the step's (BENCH_LAUNCHES)
             times 23, on the step's routes, and the steps/s at most
             BENCH_RATE_MAX x 1000 / the init (cotrain) child's device ms a
             step (a higher rate means the fence is missing);
             tools.bench_e2e_step --batch_size 16 (the e2e child's step, 2
             rounds of 10, then a trace of 10 steps under build/): its
             steps/s within BENCH_E2E_RATE of 1000 / that child's device ms,
             and the trace must exist (its device events printed); since
             slice 13 tools.bench_e2e_step --batch_size 32 with
             --train_bn_stats 1, --freeze_early 1 and --f32 (a round of 5
             steps and a trace of 10 each): the bf16 runs' steps/s within
             BENCH_E2E_RATE of 1000 / the device ms a step of their own
             trace, the f32 run's finite; no e2e run launches a port kernel;
             tools.bench_loader
             at its defaults, --metadata 20000 and --vlen_files 2000, each
             line parsed.  A bench_tool line per run.
A ``phase_seconds`` line gives each phase's wall seconds.  The child
processes (the CLIs, the step-time runs) share one bytecode cache under
build/pycache, and runs that time nothing go at once: the eval CLI's two
methods, its two tasks on the trained checkpoint, the resume phase's runs,
the BERT CLIs beside the ranks.  Three phases of child processes that time
nothing and launch no kernel in this process run in threads beside the
others (``in_background``): train_cli (from after the train phase to
retrieval), resume with dp_world1 after it, and cotrain_cli (from after
retrieval to the step times); the step-time and bench children make ready
beside htm_aa_pipeline and the phases after it.  Since slice 11 each python -m child runs
in a spare process made ready ahead (make_spares: Python started, torch and
the port imported), so that the CLIs pay no process start.
The card's name and power limit (nvidia-smi) and a ``kernels`` line come
before the last line, which is {"ok": true, "device": {...}}.  Any failed
phase raises and the script exits non-zero without that line.  Without CUDA
it exits 2 and prints no result; without the port beside it (the script
alone in a directory) it exits 1 before any output.

    python3 chip_smoke.py --kernels-only

runs the build, the kernel checks, the kernel rows and the f32 eval forward
alone (a few minutes), and prints no result line.

    python3 chip_smoke.py --step-times [<child> ...]

runs the build and the step-time children (STEP_TIME_CHILDREN and
STEP_TIME_MORE, or those named) alone, and prints no result line.

    python3 chip_smoke.py --step-view bf16_t128|f32 [<tree>]

prints one end-to-end step line (STEP_VIEWS) with the port of another
checkout (<tree>, e.g. the parent commit's unpacked under build/), so that
two trees are timed in turns by the same code.
"""

from __future__ import annotations

import itertools
import json
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

SEED = 0
# f32: the kernels' f32 routes run split TF32 on the tensor cores (every
# product big·small + small·big + big·big of TF32 halves into f32
# accumulators, csrc/tf32x3.cuh): f32-accurate products, so the kernel and the
# reference (TF32 off for its matmuls) differ by the order of the f32 sums,
# the dropped small·small term and small's truncation (each ~2^-21 of a
# product or less).  Single-pass TF32 misses this limit by 40x or more
# (tests/test_torch_f32_split.py; the planted fault tf32_single_pass in the
# kernel checks).
F32_TOL = 1e-5
# bf16: the kernel rounds P and the output to bf16; the reference runs in f32
# from the same bf16 inputs.
BF16_TOL = 2e-2
# Gradient kernels (mha_bwd, milnce_dv, milnce_dt) against the plain version
# that rounds where the kernel rounds (mha_bwd_reference: P and dS to bf16;
# milnce_grad_reference: dsim to bf16), per element:
#   elem_err = max |a - b| / (rms(b) + |b|),
# so every entry is held to its own size, and an entry near zero to the
# tensor's typical magnitude rms(b).  What is left is the order of the f32
# sums, the last bf16 rounding of the output, and the rare P or dsim entry
# that the two sides round to neighbouring bf16 values.  Each limit must also
# be exceeded by the planted faults the phase computes from the plain
# version (a dropped rowsum(dP P), padded keys left unmasked, a dropped
# column term, padded columns left unmasked; for mha_bwd in f32 at the
# training shapes also its products in single-pass TF32).  On an H100 80GB HBM3 the
# kernels read at most 1.2e-5 (f32) and 7.1e-3 (bf16); the faults 0.24 and up.
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# MIL-NCE values v_el, t_el (f32 from the exact products of the features),
# the same per-element measure: the order of the f32 sums only
MILNCE_VALUE_TOL = 1e-4
# the f32 forward's four logsumexps (split TF32) against the plain version,
# per element in logit units up to |b| = 1 and relative above (lse_err).
# elem_err's rms term is set by the mask-valued entries (a row without a
# positive, a padded column: |b| ~ 6e4), which hides a logit-unit error in
# the others.  tests/test_torch_f32_split.py emulates the kernel's schedule:
# at most 4.3e-7 from the plain version and from the JAX kernels, and
# 1.4e-4 and up with single-pass TF32 products (the planted fault
# tf32_single_pass here), at tiny shapes where elem_err would read that
# fault as low as 6.6e-6.
MILNCE_LSE_F32_TOL = 1e-5
# f32 eval, card against CPU: canvases are logits / 0.07, summed over windows
CANVAS_TOL = 1e-3
AUC_TOL = 1e-3
# [B, H, S, D]: eval dual encoder; eval joint at N = 8; a long sentence bucket;
# global method (key splits)
KERNEL_SHAPES = [(192, 8, 64, 64), (192, 8, 72, 64), (64, 8, 200, 64), (1, 8, 1088, 64)]
# + train dual and joint, odd S
MHA_FWD_CHECK_SHAPES = KERNEL_SHAPES + [(64, 8, 64, 64), (64, 8, 80, 64), (8, 8, 37, 64)]
# the YC2 retrieval path's buckets S = Lb: a full forward call (25 clips of
# 10 windows) at each route's edges, and one-clip calls on the long route
YC2_SHAPES = [(250, 8, S, 64) for S in (32, 96, 128, 160, 256)] + [
    (10, 8, 160, 64), (10, 8, 256, 64)]
YC2_TIMED_SHAPES = [(250, 8, 96, 64), (250, 8, 256, 64)]  # one per route
BENCH = dict(B=192, T=64, C=1024, N=8, W=32)
TRAIN = dict(B=64, T=64, N=16, W=32)  # the train CLI's defaults
MHA_BWD_SHAPES = [(64, 8, 64, 64), (64, 8, 80, 64), (8, 8, 37, 64)]  # dual, joint, odd S
# bf16 past S = 128 takes the long route: a sentence bucket, the joint encoder at T = 128
MHA_BWD_LONG_SHAPES = [(8, 8, 200, 64), (8, 8, 144, 64)]
# (S, B, T, N, C, shared text): R = B T rows, K = B N columns
MILNCE_SHAPES = [(6, 64, 64, 16, 512, True), (6, 64, 64, 16, 512, False),
                 (6, 128, 64, 16, 512, False), (2, 64, 64, 80, 512, False)]
MILNCE_SPLIT_SHAPE = (2, 8, 64, 16, 512, False)  # milnce_dv in two column splits
TRAIN_STEPS = 10
# the bf16 Stage-1 step at T = 128 (--seq_len 128): the dual encoder's S = 128 on
# mha_fwd's short and mha_bwd's fused route, the joint encoder's S = 128 + N = 144 on
# their long routes; T128_STEPS counted steps
T128_STEPS = 3
# expected launches per train step: 6 + 6 encoder blocks; the dual and joint MIL-NCE
STEP_LAUNCHES = {"mha_fwd": 12, "mha_bwd": 12, "milnce_fwd": 2, "milnce_dv": 2,
                 "milnce_dt": 2}
# ... and the routes they take (bf16, S = 64 and 80)
STEP_ROUTES = {"mha_fwd": {"short": 12, "long": 0, "f32": 0},
               "mha_bwd": {"fused": 12, "long": 0, "f32": 0}, "milnce_fwd": {"wgmma": 2, "f32": 0},
               "milnce_dv": {"wgmma": 2, "f32": 0}, "milnce_dt": {"wgmma": 2, "f32": 0}}
T128_ROUTES = dict(STEP_ROUTES, mha_fwd={"short": 6, "long": 6, "f32": 0},
                   mha_bwd={"fused": 6, "long": 6, "f32": 0})
# the f32 Stage-1 step (T = 64, f32 compute): every kernel on its f32 route
F32_STEP_ROUTES = {k: {r: (STEP_LAUNCHES[k] if r == "f32" else 0) for r in v}
                   for k, v in STEP_ROUTES.items()}
# fused against plain logits on the card, bf16, two steps on two batches
# (the first update has lr 0, so both steps see the initial params): the
# loss differs by the order of f32 sums over the same bf16 features; the
# gradients also by the bf16 rounding of dsim, carried back through the bf16
# encoders.  Gradients per tensor, norm-relative: |a - b| / |b|, the worst
# tensor reported.  The params are not compared: Adam moves each by about
# +-lr whatever the size of its gradient, so they hold nothing the
# gradients do not.
TRAIN_LOSS_TOL = 1e-3
TRAIN_GRAD_TOL = 5e-2
TRAIN_LR = 1e-4
# f32 train step on the card against the CPU, two steps on two batches:
# loss, and every gradient tensor norm-relative; for cotrain also every
# target (EMA) tensor, and the same limit for the f32 fused-vs-plain
# cotrain steps at full width
F32_STEP_TOL = 1e-4
COTRAIN_STEPS = 10
# a cotrain step adds the EMA twin's forward: 12 more mha_fwd launches, no
# backward; the agreement targets change only the MIL-NCE kernels' pos mask
COTRAIN_STEP_LAUNCHES = dict(STEP_LAUNCHES, mha_fwd=24)
COTRAIN_STEP_ROUTES = dict(STEP_ROUTES, mha_fwd={"short": 24, "long": 0, "f32": 0})
# --remat: the backward runs each block's forward again, so every block
# launches mha_fwd twice; the EMA twin's no-grad forward runs plain
REMAT_STEP_LAUNCHES = dict(STEP_LAUNCHES, mha_fwd=24)
REMAT_STEP_ROUTES = dict(STEP_ROUTES, mha_fwd={"short": 24, "long": 0, "f32": 0})
REMAT_COTRAIN_LAUNCHES = dict(STEP_LAUNCHES, mha_fwd=36)
REMAT_MEMORY_BATCHES = (64, 256)  # peak memory of a step, remat on and off
# the f32 cotrain steps (fused and plain): every kernel on its f32 route
F32_COTRAIN_ROUTES = {"mha_fwd": "f32", "mha_bwd": "f32", "milnce_fwd": "f32",
                      "milnce_dv": "f32", "milnce_dt": "f32"}
# the target after a step with lr > 0 against t·m + online·(1 - m) from the
# params just before and after it, computed here in f64, per tensor
# norm-relative: only f32 rounding differs.  A wrong update moves the target
# by about (1 - m)·lr = 1e-7 per element, above this bar on tensors of norm
# below 0.1 per element (every bias); planted wrong updates must exceed it.
EMA_TOL = 1e-6
# two cotrain runs' targets after two steps, per element:
#   |a - b| <= F32_STEP_TOL·|b| + TARGET_ATOL.
# Adam moves a param by up to about lr whatever the size of its gradient, so
# where the gradient is rounding noise (the key third of every in_proj_bias:
# a key bias leaves the softmax unchanged) the two runs' online params may
# step opposite ways, and the EMA passes (1 - m) of that to the target.  Of
# the two steps only the second updates with lr > 0 (warm-up); 4 covers
# Adam's bias-corrected step at its second update.
TARGET_ATOL = 4 * (1 - 0.999) * TRAIN_LR
# the retrieval phase's synthetic YC2 corpus (a cut of YouCook2's validation
# split, 457 videos): segment lengths in s, [lo, hi + 1) in turn, one range
# per window bucket Lb = round_up(clip(2 d, 32, 256), 32) (64 twice: below
# seq_len and at it, where the pos-enc is resized), and past 256 s the lag
# branch of plan_clip_windows
YC2 = dict(videos=64)
YC2_SEGMENTS = [(5, 16), (17, 31), (32, 32), (33, 48), (49, 64), (65, 80), (81, 96),
                (97, 112), (113, 256), (257, 300)]
# f32 pooled clip and text features (unit vectors of width 512), card
# against the CPU: the order of f32 sums through the 6-block dual encoder
RETRIEVAL_F32_TOL = 1e-4
# resume: 6 steps per epoch at B = 64; each case stops at k (mid-epoch; for
# cotrain with backprop_freq 2 also mid-accumulation) and runs to 2k
RESUME = dict(videos=384, cases=[
    ("stage1_e6d6", 4, []),
    ("cotrain_e2d2_backprop_freq2", 3, ["--model", "cotrain", "--num_encoder_layers", "2",
                                        "--num_joint_layers", "2", "--backprop_freq", "2"]),
])
# Slice 6, the end-to-end S3D path at the JAX CLI's defaults: 16 videos x 2
# clips of 16 x 224² per step (W words), joint dim 512, vocab 66,251.
E2E = dict(B=16, n=2, T=16, S=224, W=32)
# S3D, ‖a − b‖ / ‖b‖ of the embedding (and logits) of one clip: f32 on the
# card against the CPU and the folded against the explicit conv1 differ only
# in the order of f32 sums; bf16 against f32 rounds every layer's inputs.
S3D_F32_REL = 1e-4
S3D_BF16_REL = 5e-2
# two f32 e2e steps, card against CPU: the CPU tests' bars against JAX
# (tests/test_torch_end2end.py), at their lr and wd (lr · wd = 1e-3).  As an
# Adam step moves an element by about lr, the params after two steps cannot
# see the backward pass or the update; these are held apart on the same two
# steps in f64 (in f32 a ReLU output just above 0 may round to 0 on the card
# and not on the CPU, and then a max-pool window sends its gradient to
# another element, which moves a whole branch's gradients: the f32 first
# step's per-leaf errors are printed, not checked): each leaf's gradient,
# ‖Δg‖ ≤ E2E_GRAD_RTOL · ‖g‖ + E2E_GRAD_ATOL · the whole gradient's norm (the
# InfoNCE head runs in f32, as in JAX, and its rounding reaches the text
# tower's biases, whose gradients nearly cancel: a third of this bar on an
# H100);
# then both optimizers are fed the CPU's gradients, and the update with the
# decay taken out, u = (Δw + lr·wd·w)/lr (about ±1 where Adam moves an
# element, and 0 for the decay alone), agrees within E2E_UPDATE_ATOL.
E2E_LOSS_TOL, E2E_PARAM_ATOL, E2E_PARAM_RTOL = 2e-4, 2e-4, 1e-3
E2E_GRAD_NORM_RTOL, E2E_GRAD_RTOL, E2E_GRAD_ATOL = 1e-3, 1e-4, 1e-6
E2E_UPDATE_ATOL = 1e-6
E2E_LR, E2E_WD = 2.5e-5, 40.0
# the HTM-AA pipeline: synthetic videos of `seconds` s (> the 32 s an
# overlap-seq window needs), `sentences` ASR sentences each, features of 16
# frames at 16 fps and `size`², `batch` clips per encoder call
HTM_AA = dict(videos=16, seconds=34, sentences=8, size=224, batch=8)
HTM_AA_SCORE_TOL = 1e-4  # alignability scores, f32 card against CPU
# Slice 7: the BERT TAN at bert-base-uncased's published widths (its config.json) and the
# trainer's default batch (B = 64, N = 16, W = 32: 1,024 sentences a step)
BERT_CFG = dict(vocab_size=30522, hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
                intermediate_size=3072, max_position_embeddings=512, type_vocab_size=2,
                layer_norm_eps=1e-12, hidden_act="gelu")
BERT_STEPS = 6
# a BERT TAN step runs BERT's 12 layers forward and backward besides the aligner's 12
# blocks; the cotrain step's twin adds 24 forward launches (its BERT and its aligner)
BERT_STEP_LAUNCHES = dict(STEP_LAUNCHES, mha_fwd=24, mha_bwd=24)
BERT_STEP_ROUTES = dict(STEP_ROUTES, mha_fwd={"short": 24, "long": 0, "f32": 0},
                        mha_bwd={"fused": 24, "long": 0, "f32": 0})
BERT_COTRAIN_LAUNCHES = dict(BERT_STEP_LAUNCHES, mha_fwd=48)
BERT_COTRAIN_ROUTES = dict(BERT_STEP_ROUTES, mha_fwd={"short": 48, "long": 0, "f32": 0})
# openai/clip-vit-base-patch32's config: text 512 wide, 12 layers of 8 heads, 77 tokens,
# vocab 49408; vision 768 wide, 12 layers of 12 heads, patch 32 of 224²; projections 512.
# facebook/timesformer-base-finetuned-k400's: 768 wide, 12 layers of 12 heads, MLP 3072,
# patch 16, 8 frames of 224² (196 patches)
CLIP_TEXT = dict(vocab_size=49408, context_length=77, width=512, layers=12, heads=8,
                 embed_dim=512)
CLIP_VISION = dict(width=768, layers=12, heads=12, patch_size=32, image_size=224, embed_dim=512)
TIMESFORMER = dict(width=768, layers=12, heads=12, patch_size=16, frames=8, image_size=224,
                   mlp_width=3072)
CLIP_FRAMES, TIMESFORMER_CLIPS = 256, 4  # per encoder call
# mha_fwd at the towers' shapes: BERT's [B N, 12, W, 64] (padded sentence slots fully
# masked), ViT-B/32 over 256 frames (S = 50), TimeSformer's temporal [4 · 196, 12, 8, 64]
# and spatial [4 · 8, 12, 197, 64] attention, the last three unmasked; mha_bwd at BERT's
BERT_SHAPE = (TRAIN["B"] * TRAIN["N"], 12, TRAIN["W"], 64)
TOWER_SHAPES = [BERT_SHAPE, (CLIP_FRAMES, 12, 50, 64), (TIMESFORMER_CLIPS * 196, 12, 8, 64),
                (TIMESFORMER_CLIPS * 8, 12, 197, 64)]
# the towers' outputs, ‖a − b‖ / ‖b‖: f32 on the card against the CPU differs by the order
# of f32 sums through 12 layers; bf16 against f32 rounds every layer's inputs (as S3D's)
TOWER_F32_REL = 1e-4
TOWER_BF16_REL = 5e-2
# Slice 8: the serving export of the bench.py workload (BENCH, E6D6): 6 dual + 6 joint
# attention calls, one temporalalignnet::mha_fwd node each; the poly artifact serves
# SERVE_BATCHES.  Grouped dispatch: GROUP_K steps a group (a CUDA graph replayed per batch);
# the train CLI over the train phase's videos at the batch that makes GROUP_CLI_STEPS steps
# an epoch (groups of 4, 4, 4), --max_steps 10 grouped against 12 per step
SERVE_NODES = 12
SERVE_BATCHES = (BENCH["B"], 7)
GROUP_K = 4
GROUP_CLI_STEPS = 12
# published dense peaks (NVIDIA data sheets): bytes/s, bf16 FLOP/s
CARD_PEAKS = {"H100 PCIe": (2.0e12, 756e12), "H100 NVL": (3.9e12, 835e12),
              "H100": (3.35e12, 989e12)}
# float32 outside the tensor cores (NVIDIA data sheets): the f32 routes' bound
# before they moved to the tensor cores, printed beside the restated one
CARD_F32_PEAKS = {"H100 PCIe": 51e12, "H100 NVL": 60e12, "H100": 67e12}
# TF32 dense on the tensor cores (NVIDIA data sheets).  An f32-accurate product in
# split TF32 costs SPLIT_PASSES TF32 products (big·small, small·big, big·big), so an
# f32 row is bound at max(bytes / bw, SPLIT_PASSES · FLOPs / this peak)
CARD_TF32_PEAKS = {"H100 PCIe": 378e12, "H100 NVL": 417e12, "H100": 495e12}
SPLIT_PASSES = 3
# Slice 10.  The punctuator: a BERT-base token classifier (BERT_CFG, 15 labels, random
# weights from the seed) through tools/process_htm.py over PUNCT["videos"] synthetic
# videos of about PUNCT["captions"] unpunctuated captions; f32 on the card (mha_fwd's f32
# route, 12 launches per predict call, one call per video) against the CPU on the first
# PUNCT["cpu_videos"] videos' calls.  Its attention shape: [chunks, 12, 258, 64], the
# chunks near-equal (np.array_split), so each row has 258 or 257 valid keys.
PUNCT = dict(videos=16, captions=60, labels=15, cpu_videos=4)
PUNCT_SHAPE = (4, 12, 258, 64)
# mha_fwd's f32 route, timed at the eval's dual and joint shapes, the training's,
# the global method's and the punctuator's; mha_bwd's at the training's
F32_TIMED_SHAPES = KERNEL_SHAPES[:2] + MHA_BWD_SHAPES[:2] + [KERNEL_SHAPES[3], PUNCT_SHAPE]
# bf16 past S = 128, timed: the joint encoder at --seq_len 128 (S = 128 + 16) and a long
# sentence bucket
MHA_BWD_LONG_TIMED_SHAPES = [(64, 8, 144, 64), (64, 8, 200, 64)]
PUNCT_STOPWORDS = ("so", "we", "the", "and", "to", "it", "now", "you", "is", "this", "of",
                   "in", "a", "that", "then", "just")
# a label the card and the CPU disagree on must be a near-tie: the two labels' biased
# probabilities (Sentencify's) within PUNCT_MARGIN_TOL on the CPU
PUNCT_MARGIN_TOL = 1e-4
# tensor parallelism: E6D6 width 512, 8 heads over TP ranks (two children on the card
# joined by gloo): each rank's mha_fwd and mha_bwd on [B, 8 / TP, S, 64] at the dual and
# joint lengths
TP = 2
TP_SHAPES = [(TRAIN["B"], 8 // TP, 64, 64), (TRAIN["B"], 8 // TP, 80, 64)]
TP_CASES = (("stage1_f32", False, "float32"), ("stage1_bf16", False, "bfloat16"),
            ("cotrain_f32", True, "float32"), ("cotrain_bf16", True, "bfloat16"))
# the bf16 yardstick's relative noise on the input features (tp_bars)
TP_SPREAD_NOISE = 1e-3


# every child process started (stopped at the end), and the children made
# ready ahead (make_spares), each waiting to run one python -m
STARTED = []
SPARES = []
SPARE_IDS = itertools.count()
SPARE_LOCK = threading.Lock()  # the BERT CLIs' thread takes spares too


def start(args):
    """A child process running ``args`` from the repo root, output captured.
    ``python -m <module> ...`` goes to a spare child when one is left: it
    has started Python and imported torch and the port already."""
    with SPARE_LOCK:
        spare = SPARES.pop(0) if args[1:2] == ["-m"] and SPARES else None
    if spare is not None:
        proc, go = spare
        with open(go + ".tmp", "w") as f:
            json.dump(args[2:], f)
        os.replace(go + ".tmp", go)
        return proc
    STARTED.append(subprocess.Popen(args, cwd=REPO, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
    return STARTED[-1]


def make_spares(n):
    """``n`` more spare children (``start``): each starts Python and imports
    torch and the port now, before the runs that will use it (a process
    start costs several seconds on the card's host)."""
    for _ in range(n):
        SPARES.append(start_gated("--spare", str(next(SPARE_IDS))))


def spare_child(go) -> int:
    """A spare child: the imports, then ``python -m`` of the module and
    arguments its go file holds."""
    import importlib
    import runpy

    # torch._dynamo: the first optimizer's constructor imports it (seconds)
    for module in ("torch", "torch._dynamo", "temporalalignnet_torch.train.cli",
                   "temporalalignnet_torch.eval.cli", "temporalalignnet_torch.train.end2end_cli"):
        importlib.import_module(module)
    wait_for_release(go)
    with open(go) as f:
        module, *argv = json.load(f)
    sys.argv = [module, *argv]
    runpy.run_module(module, run_name="__main__", alter_sys=True)
    return 0


def finish(proc, what, timeout):
    """The stdout of a ``start``ed child, which must exit 0 within ``timeout``
    seconds; killed if it does not."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    check(proc.returncode == 0, f"{what} failed:\n{err[-4000:]}")
    return out


def stop(procs):
    """Kill the ``start``ed children still running (after a failed check)."""
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


EMIT_LOCK = threading.Lock()  # phases in the background (in_background) emit too


def emit(obj) -> None:
    line = json.dumps(obj) + "\n"
    with EMIT_LOCK:
        sys.stdout.write(line)
        sys.stdout.flush()


def in_background(fn, *args):
    """``fn(*args)`` in a thread: a phase whose runs are child processes, that
    times nothing and launches no kernel in this process (the wrappers'
    counts stay the main thread's).  Joined by ``joined``."""
    result = {}

    def run():
        try:
            result["value"] = fn(*args)
        except BaseException as e:  # raised again by joined
            result["error"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    return thread, result


def joined(started, what, timeout=1800):
    """The result of an ``in_background`` phase once its thread has ended;
    its failure raised."""
    thread, result = started
    thread.join(timeout)
    check(not thread.is_alive(), f"{what} did not end")
    if "error" in result:
        raise result["error"]
    return result["value"]


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def peaks(name: str):
    for key, val in CARD_PEAKS.items():  # most specific first
        if key in name:
            return val
    return CARD_PEAKS["H100"]


def f32_peak(name: str) -> float:
    for key, val in CARD_F32_PEAKS.items():  # most specific first
        if key in name:
            return val
    return CARD_F32_PEAKS["H100"]


def tf32_peak(name: str) -> float:
    for key, val in CARD_TF32_PEAKS.items():  # most specific first
        if key in name:
            return val
    return CARD_TF32_PEAKS["H100"]


def f32_bounds(card, nbytes, flops):
    """An f32 row's bounds: the restated one (split TF32 on the tensor cores)
    as ``bound_ms``, and the earlier one (f32 FMAs outside them) beside it."""
    bw = peaks(card)[0]
    t_bytes = nbytes / bw
    t_split, t_cores = SPLIT_PASSES * flops / tf32_peak(card), flops / f32_peak(card)
    return dict(bound_ms=max(t_bytes, t_split) * 1e3,
                bound_by="bytes" if t_bytes >= t_split else "operations",
                peak_flops_per_s=tf32_peak(card) / SPLIT_PASSES,
                bound_ms_f32_cores=max(t_bytes, t_cores) * 1e3,
                bound_by_f32_cores="bytes" if t_bytes >= t_cores else "operations")


def ragged_mask(torch, B, S, gen, device):
    """Key padding [B, S]: random valid lengths; with B > 1 the last row is
    fully padded (the kernel must keep it finite)."""
    lengths = torch.randint(1, S + 1, (B,), generator=gen)
    mask = torch.arange(S)[None] >= lengths[:, None]
    if B > 1:
        mask[-1] = True
    return mask.to(device)


def bert_mask(torch, B, S, gen, device):
    """Key padding of BERT's sentences [B, S]: random lengths of 3 or more
    tokens ([CLS] w [SEP]), and every fourth row fully padded (a padded
    sentence slot)."""
    lengths = torch.randint(3, S + 1, (B,), generator=gen)
    mask = torch.arange(S)[None] >= lengths[:, None]
    mask[::4] = True
    return mask.to(device)


def punct_mask(torch, B, S, device):
    """Key padding of the punctuator's chunks [B, S]: np.array_split's
    near-equal chunks of B (S - 2) - B // 2 tokens, each with [CLS] and
    [SEP]: the first rows S valid keys, the last B // 2 rows S - 1."""
    lengths = torch.tensor([len(c) + 2 for c in np.array_split(np.arange(B * (S - 2) - B // 2),
                                                                B)])
    return (torch.arange(S)[None] >= lengths[:, None]).to(device)


def tower_mask(torch, shape, gen, device):
    """The key padding a check of ``shape`` uses: BERT's at its shape, the
    punctuator's at its, else ragged."""
    if tuple(shape) == BERT_SHAPE:
        return bert_mask(torch, shape[0], shape[2], gen, device)
    if tuple(shape) == PUNCT_SHAPE:
        return punct_mask(torch, shape[0], shape[2], device)
    return ragged_mask(torch, shape[0], shape[2], gen, device)


def yc2_mask(torch, B, S, device):
    """Key padding of a retrieval forward call at bucket S = Lb: L = S - 31
    valid keys (the most padding a bucket holds), and a last row with L = 1."""
    mask = (torch.arange(S) >= S - 31)[None].repeat(B, 1)
    mask[-1, 1:] = True
    return mask.to(device)


def attention_work(q, pad, full, passes):
    """(bytes, operations) an attention function of q, k, v [B, H, S, D] under
    key padding ``pad`` [B, S] needs: ``full`` tensors of q's size read or
    written whole (q, the output, gradients), K and V read at the valid keys
    only, the mask once; ``passes`` multiply-adds of length D per head for
    each (query, valid key) pair, 2 operations each."""
    _, H, S, D = q.shape
    valid = int((~pad).sum().item())  # valid keys, summed over the rows
    nbytes = (full * q.numel() + 2 * valid * H * D) * q.element_size() + pad.numel()
    return nbytes, 2 * passes * H * S * D * valid


def cuda_ms(torch, fn, reps=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


PROFILER_TRIES = 3


def device_profile(torch, fn, reps=20, warmup=3, confirm=False):
    """Run ``fn`` ``reps`` times under torch.profiler.  Returns (device ms per
    call summed over every kernel it launched, {kernel name: ms per call},
    {host op: self CPU ms per call}, timing).  Host issue time is not in the
    first; ``cuda_ms`` measures with that included.

    A profiler session now and then loses device activity (seen on an H100:
    a session of 20 calls that recorded no kernel at all, sessions that
    recorded some of a kernel's 20 launches, and sessions whose every count
    was a multiple of 20 but whose device time was under half that of other
    runs' sessions of the same calls: all launches of a kernel lost).
    ``fn`` launches the same kernels on every call, so a session counts only
    if every kernel's count is a multiple of ``reps`` and (with ``confirm``)
    an earlier session of the same calls recorded the same kernels the same
    number of times.  Up to PROFILER_TRIES sessions are run, one more to
    confirm; if none counts, the first value is the CUDA-event time of the
    same calls, the dicts are empty, and timing says "cuda_events" instead
    of "profiler".  The kernel rows confirm; a whole forward or step does
    not: on an H100 a session after one of thousands of kernels lost
    activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    seen = []  # {kernel: launches} of the earlier whole sessions
    for _ in range(PROFILER_TRIES + confirm):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        # a record_function range (e.g. Optimizer.step) shows on the device
        # too, spanning kernels already counted: keep only names the host
        # never ran
        host = {e.key for e in events if e.device_type == DeviceType.CPU}
        kernels = [e for e in events if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0 and e.key not in host]
        per_kernel = {e.key: e.self_device_time_total / 1e3 / reps for e in kernels}
        total = sum(per_kernel.values())
        counts = {e.key: e.count for e in kernels}
        if total == 0 or any(c % reps for c in counts.values()):
            continue
        if counts in seen or not confirm:
            host_ms = {e.key: e.self_cpu_time_total / 1e3 / reps for e in events
                       if e.device_type == DeviceType.CPU and e.self_cpu_time_total > 0}
            return total, per_kernel, host_ms, "profiler"
        seen.append(counts)
    return cuda_ms(torch, fn, reps, warmup=0), {}, {}, "cuda_events"


def phase_build():
    from temporalalignnet_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    ptxas = {n: [l for l in _build.build_log(n).splitlines() if "ptxas info" in l]
             for n in libs}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libs": {n: os.path.relpath(p, REPO) for n, p in libs.items()}, "ptxas": ptxas})


def phase_kernel_check(torch):
    """mha_fwd on each route against attention_reference from the same
    inputs, masked (ragged, one fully padded row) and not; the route each call
    took; the earlier bf16 kernel (v1) beside it; and a planted fault (padded
    keys left unmasked), which the bf16 limit must catch."""
    from temporalalignnet_torch.ops import _build
    from temporalalignnet_torch.ops.attention import attention_reference
    from temporalalignnet_torch.ops.mha_fwd import (
        KEY_TILE, LONG_QUERIES, key_splits, mha_fwd, mha_fwd_v1, route)

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}

    def check_one(shape, dtype, tol, masked, make_mask):
        B, H, S, _ = shape
        q, k, v = (torch.randn(shape, generator=gen).to(dev, dtype) for _ in range(3))
        mask = make_mask() if masked else None
        before = dict(mha_fwd.launches_by_route)
        out = mha_fwd(q, k, v, mask)
        taken = route_taken(mha_fwd, before)
        torch.cuda.synchronize()
        ref = attention_reference(q.float(), k.float(), v.float(), mask)
        info = {}
        if dtype == torch.float32 and shape in MHA_BWD_SHAPES[:2]:  # the training shapes
            info["planted_fault_max_abs_err"] = {"tf32_single_pass": abs_err(
                tf32_plain(torch, attention_reference, q, k, v, mask), ref)}
        if dtype == torch.bfloat16:
            info["v1_max_abs_err"] = abs_err(mha_fwd_v1(q, k, v, mask), ref)
            if taken == "long":
                info["key_splits"] = key_splits(B * H * -(-S // LONG_QUERIES),
                                                -(-S // KEY_TILE), _build.sm_count(dev))
            if masked:
                info["planted_fault_max_abs_err"] = {"padded_keys_unmasked": abs_err(
                    attention_reference(q.float(), k.float(), v.float(), None), ref)}
        torch.cuda.synchronize()
        err = abs_err(out, ref)
        worst[dtype] = max(worst[dtype], err)
        emit({"phase": "kernel", "name": "mha_fwd", "route": taken, "shape": list(shape),
              "dtype": str(dtype).split(".")[-1], "masked": masked,
              "max_abs_err": err, "tol": tol, **info})
        check(taken == route(dtype, S), f"mha_fwd {dtype} {shape} took route {taken}")
        if shape == KERNEL_SHAPES[3] and dtype == torch.bfloat16:  # the global method
            check(info["key_splits"] > 1, f"mha_fwd took no key split at {shape}")
        check(bool(torch.isfinite(out).all()), f"mha_fwd non-finite at {shape}")
        check(out.dtype == dtype, "mha_fwd output dtype")
        check(err <= tol, f"mha_fwd {dtype} {shape} masked={masked}: {err} > {tol}")
        for f, ferr in info.get("planted_fault_max_abs_err", {}).items():
            check(ferr > tol, f"limit {tol} misses the planted fault {f}: {ferr}")

    dtypes = ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL))
    for shape in MHA_FWD_CHECK_SHAPES + TOWER_SHAPES + [PUNCT_SHAPE] + TP_SHAPES:
        for dtype, tol in dtypes:
            for masked in (False, True):
                check_one(shape, dtype, tol, masked, lambda: tower_mask(torch, shape, gen, dev))
    # the retrieval path's buckets, with its key padding
    for shape in YC2_SHAPES:
        for dtype, tol in dtypes:
            check_one(shape, dtype, tol, "yc2", lambda: yc2_mask(torch, shape[0], shape[2], dev))
    q = torch.randn(2, 8, 64, 64, device=dev)
    try:
        mha_fwd(q.transpose(2, 3), q, q)
    except ValueError:
        pass
    else:
        raise RuntimeError("mha_fwd accepted a non-contiguous input")
    return worst[torch.float32], worst[torch.bfloat16]


def abs_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def rms(b) -> float:
    return b.float().square().mean().sqrt().item()


def elem_err(a, b) -> float:
    """max |a - b| / (rms(b) + |b|), over the elements (GRAD_TOL)."""
    a, b = a.float(), b.float()
    return ((a - b).abs() / (b.abs() + max(rms(b), 1e-30))).max().item()


def lse_err(a, b) -> float:
    """max |a - b| / (1 + |b|), over the elements (MILNCE_LSE_F32_TOL)."""
    a, b = a.double(), b.double()
    return ((a - b).abs() / (1.0 + b.abs())).max().item()


def lse_err_max(ours, ref) -> float:
    """lse_err over paired tensors (the four logsumexps), the worst."""
    return max(lse_err(a, b) for a, b in zip(ours, ref))


def norm_err(a, b) -> float:
    """|a - b| / |b| (Frobenius)."""
    a, b = a.float(), b.float()
    return (a - b).norm().item() / max(b.norm().item(), 1e-30)


def kernel_fns():
    from temporalalignnet_torch.ops import kernels

    return kernels()


def reset_counts():
    for fn in kernel_fns().values():
        fn.launches = 0
        if hasattr(fn, "launches_by_route"):
            fn.launches_by_route = dict.fromkeys(fn.launches_by_route, 0)


def read_counts():
    return {name: fn.launches for name, fn in kernel_fns().items()}


def read_routes():
    return {name: dict(fn.launches_by_route) for name, fn in kernel_fns().items()
            if hasattr(fn, "launches_by_route")}


def route_taken(fn, before):
    """The one route whose count moved since ``before`` (a launches_by_route copy)."""
    moved = [r for r, n in fn.launches_by_route.items() if n != before[r]]
    check(len(moved) == 1, f"expected one launch on one route, got {moved}")
    return moved[0]


def tf32_plain(torch, fn, *args):
    """A planted fault of the f32 routes: the plain version ``fn`` with its
    matrix products in single-pass TF32 (allow_tf32), which the f32 limits
    must catch."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return fn(*args)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def mha_bwd_dropped_rowsum(torch, q, k, v, mask, dout):
    """A planted fault: mha_bwd_reference with dS = P dP, the rowsum(dP P)
    term dropped (dv is unchanged by it)."""
    from temporalalignnet_torch.ops.attention import NEG_INF
    from temporalalignnet_torch.ops.mha_bwd import mha_bwd_reference

    qf, kf, vf, df = (t.float() for t in (q, k, v, dout))
    scale = q.shape[-1] ** -0.5
    scores = qf @ kf.transpose(-1, -2) * scale
    if mask is not None:
        scores = scores.masked_fill(mask[:, None, None, :], NEG_INF)
    ds = (torch.softmax(scores, -1) * (df @ vf.transpose(-1, -2))).to(q.dtype).float()
    dv = mha_bwd_reference(q, k, v, mask, dout)[2]
    return ((ds @ kf * scale).to(q.dtype), (ds.transpose(-1, -2) @ qf * scale).to(q.dtype), dv)


def phase_mha_bwd_check(torch):
    """mha_bwd's dq, dk, dv (through the autograd of multihead_attention)
    against mha_bwd_reference from the same inputs, masked (ragged, one fully
    padded row) and not; and the planted faults against the same plain
    version, each of which the limit must catch."""
    from temporalalignnet_torch.ops.attention import multihead_attention
    from temporalalignnet_torch.ops.mha_bwd import mha_bwd, mha_bwd_reference

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 4)
    worst = {}
    for shape in MHA_BWD_SHAPES + MHA_BWD_LONG_SHAPES + [BERT_SHAPE] + TP_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            tol = GRAD_TOL[name]
            expected = "f32" if dtype == torch.float32 else "fused" if shape[2] <= 128 else "long"
            for masked in (False, True):
                q, k, v, g = (torch.randn(shape, generator=gen).to(dev, dtype) for _ in range(4))
                mask = tower_mask(torch, shape, gen, dev) if masked else None
                leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
                before = dict(mha_bwd.launches_by_route)
                multihead_attention(*leaves, mask).backward(g)
                taken = route_taken(mha_bwd, before)
                ours = [t.grad for t in leaves]
                plain = mha_bwd_reference(q, k, v, mask, g)
                faults = {"rowsum_dropped": mha_bwd_dropped_rowsum(torch, q, k, v, mask, g)}
                if dtype == torch.float32 and shape in MHA_BWD_SHAPES[:2]:  # training shapes
                    faults["tf32_single_pass"] = tf32_plain(torch, mha_bwd_reference, q, k, v,
                                                            mask, g)
                if masked:
                    faults["padded_keys_unmasked"] = mha_bwd_reference(q, k, v, None, g)
                # the long route sums in a fixed order: its calls are bit-equal
                again = [mha_bwd(q, k, v, mask, g) for _ in range(2)] if taken == "long" else []
                torch.cuda.synchronize()
                bit_equal = all(torch.equal(a, b) for run in again for a, b in zip(run, ours))
                errs = [elem_err(a, b) for a, b in zip(ours, plain)]
                abs_errs = [abs_err(a, b) for a, b in zip(ours, plain)]
                fault_errs = {f: max(elem_err(a, b) for a, b in zip(fg, plain))
                              for f, fg in faults.items()}
                worst[name] = max(worst.get(name, 0.0), *abs_errs)
                worst[taken] = max(worst.get(taken, 0.0), *abs_errs)
                emit({"phase": "kernel_bwd", "name": "mha_bwd", "route": taken,
                      "shape": list(shape), "dtype": name, "masked": masked,
                      "elem_err_dq_dk_dv": errs,
                      "norm_err_dq_dk_dv": [norm_err(a, b) for a, b in zip(ours, plain)],
                      "abs_err_dq_dk_dv": abs_errs, "rms_dq_dk_dv": [rms(b) for b in plain],
                      "tol": tol, "planted_fault_elem_err": fault_errs,
                      **({"calls_bit_equal": bit_equal} if again else {})})
                check(all(bool(torch.isfinite(t).all()) and t.dtype == dtype for t in ours),
                      f"mha_bwd output at {shape} {name}")
                check(bit_equal, f"mha_bwd {name} {shape}: two calls differ")
                check(taken == expected, f"mha_bwd {name} {shape} took route {taken}")
                check(max(errs) <= tol, f"mha_bwd {name} {shape} masked={masked}: {errs}")
                for f, err in fault_errs.items():
                    check(err > tol, f"limit {tol} misses the planted fault {f}: {err}")
    return worst


def milnce_problem(torch, S, B, T, N, C, shared, gen, dev):
    """Unit-norm features and the loss's own masks from a synthetic target
    (same-video positives, padded sentences)."""
    from temporalalignnet_torch.data.synthetic import synthetic_batch
    from temporalalignnet_torch.losses.tan_loss import positive_mask

    n_real = min(N, 40)  # a 64 s window holds at most ~56 spans; the rest are padding
    spans = synthetic_batch(np.random.RandomState(SEED + B + N), batch_size=B, seq_len=T,
                            max_sentences=n_real, feature_dim=4, vocab_size=50, max_words=4)
    pad = lambda x, fill: torch.from_numpy(np.pad(x, ((0, 0), (0, N - n_real)),
                                                  constant_values=fill))
    pm, cv = positive_mask(pad(spans["start"], 0.0), pad(spans["end"], 0.0), T,
                           pad(spans["text_padding_mask"], True))
    R, K = B * T, B * N
    unit = lambda *shape: torch.nn.functional.normalize(torch.randn(*shape, generator=gen), dim=-1)
    v, t = unit(S, R, C), (unit(K, C) if shared else unit(S, K, C))
    gv, gt = torch.randn(S, R, generator=gen), torch.randn(S, K, generator=gen)
    return [x.to(dev) for x in (v, t, pm, cv, gv, gt)]


def milnce_fwd_faults(torch, v, t, pm, cv, lse, mv, inv_temp):
    """Planted faults of the forward's four logsumexps, from the plain
    version: the column logsumexps without the last 64-row block, and (with
    padded columns) every column left unmasked."""
    from temporalalignnet_torch.ops.milnce import TILE, milnce_lse_reference

    r_last = (v.shape[1] - 1) // TILE * TILE
    faults = {"last_row_block_dropped": tuple(lse[:2]) + milnce_lse_reference(
        v[:, :r_last], t, pm[:r_last], cv, mv, inv_temp)[2:]}
    if not bool(cv.all()):
        faults["padded_columns_unmasked"] = milnce_lse_reference(
            v, t, pm, torch.ones_like(cv), mv, inv_temp)
    return faults


def phase_milnce_check(torch):
    """The three MIL-NCE kernels through MilNCEFunction against the plain
    versions from the same inputs: the values against milnce_reference, the
    forward's four logsumexps against milnce_lse_reference, the gradients
    against milnce_grad_reference from the plain logsumexps; and the planted
    faults against the same plain versions, each of which the limit must
    catch."""
    from temporalalignnet_torch.ops import _build
    from temporalalignnet_torch.ops.milnce import (
        F32_TILE, TILE, _wave_splits, fused_milnce_elements, milnce_dt, milnce_dt_v2, milnce_dv,
        milnce_dv_v2, milnce_fwd, milnce_fwd_v1, milnce_grad_reference, milnce_lse_reference,
        milnce_reference)

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 5)
    inv_temp, mv = 1.0 / 0.07, -6.0e4
    worst = {}
    for S, B, T, N, C, shared in MILNCE_SHAPES + [MILNCE_SPLIT_SHAPE]:
        v32, t32, pm, cv, gv, gt = milnce_problem(torch, S, B, T, N, C, shared, gen, dev)
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            ins = [x.detach().to(dtype).clone().requires_grad_() for x in (v32, t32)]
            before = {f: dict(f.launches_by_route) for f in (milnce_fwd, milnce_dv, milnce_dt)}
            out = fused_milnce_elements(*ins, pm, cv, mv, inv_temp)
            ((out[0] * gv).sum() + (out[1] * gt).sum()).backward()
            taken = {f.__name__: route_taken(f, b) for f, b in before.items()}
            expected = "wgmma" if dtype == torch.bfloat16 else "f32"
            check(taken == dict.fromkeys(("milnce_fwd", "milnce_dv", "milnce_dt"), expected),
                  f"MIL-NCE kernels {name} took routes {taken}")
            v, t = (x.detach() for x in ins)
            ref = milnce_reference(v, t, pm, cv, mv, inv_temp)
            lse = milnce_lse_reference(v, t, pm, cv, mv, inv_temp)
            klse = milnce_fwd(v, t, pm, cv, mv, inv_temp)  # the four logsumexps, directly
            plain = milnce_grad_reference(v, t, pm, cv, lse, gv, gt, inv_temp)
            faults = {"column_term_dropped": milnce_grad_reference(
                v, t, pm, cv, lse, gv, torch.zeros_like(gt), inv_temp)}
            if dtype == torch.float32:  # the products in single-pass TF32
                faults["tf32_single_pass"] = tf32_plain(torch, milnce_grad_reference, v, t, pm, cv,
                                                        lse, gv, gt, inv_temp)
            fwd_faults = milnce_fwd_faults(torch, v, t, pm, cv, lse, mv, inv_temp)
            f32_lse_faults = {}  # the f32 logsumexps in logit units (lse_err)
            if dtype == torch.float32:
                f32_lse_faults = {"tf32_single_pass": lse_err_max(tf32_plain(
                    torch, milnce_lse_reference, v, t, pm, cv, mv, inv_temp), lse)}
                f32_lse_faults.update({f: lse_err_max(fl, lse) for f, fl in fwd_faults.items()})
            if "padded_columns_unmasked" in fwd_faults:  # in the forward and the backward
                faults["padded_columns_unmasked"] = milnce_grad_reference(
                    v, t, pm, torch.ones_like(cv), fwd_faults["padded_columns_unmasked"], gv, gt,
                    inv_temp)
            # dv and dt against the plain version from the kernel's own
            # logsumexps (the ones the backward kernels got), the new and the
            # earlier kernels: without the ~1e-6 logsumexp difference, which
            # moves some dsim entries to the neighbouring bf16 value
            same_lse, v1_lse_err = {}, None
            kargs = (v, t, pm, cv, klse, gv, gt, inv_temp)
            if dtype == torch.bfloat16:
                v1_lse_err = max(elem_err(a, b) for a, b in zip(
                    milnce_fwd_v1(v, t, pm, cv, mv, inv_temp), lse))
                kdv, kdt = milnce_grad_reference(v, t, pm, cv, klse, gv, gt, inv_temp)
                same_lse = {"dv": {"milnce_dv": elem_err(ins[0].grad, kdv),
                                   "milnce_dv_v2": elem_err(milnce_dv_v2(*kargs), kdv)},
                            "dt": {"milnce_dt": elem_err(ins[1].grad, kdt),
                                   "milnce_dt_v2": elem_err(milnce_dt_v2(*kargs), kdt)}}
            # every sum is taken in a fixed order: two calls are bit-equal
            bit_equal = all(torch.equal(f(*kargs), f(*kargs)) for f in (milnce_dv, milnce_dt))
            fwd_bit_equal = all(torch.equal(a, b) for a, b in zip(
                klse, milnce_fwd(v, t, pm, cv, mv, inv_temp)))
            torch.cuda.synchronize()
            f32_lse = lse_err_max(klse, lse) if dtype == torch.float32 else None
            pairs = {"milnce_fwd": list(zip(out, ref)), "milnce_fwd_lse": list(zip(klse, lse)),
                     "milnce_dv": [(ins[0].grad, plain[0])],
                     "milnce_dt": [(ins[1].grad, plain[1])]}
            errs = {k: max(elem_err(a, b) for a, b in ps) for k, ps in pairs.items()}
            abs_errs = {k: max(abs_err(a, b) for a, b in ps) for k, ps in pairs.items()}
            fault_errs = {f: max(elem_err(a, b) for a, b in zip(fg, plain))
                          for f, fg in faults.items()}
            fwd_fault_errs = {f: max(elem_err(a, b) for a, b in zip(fl, lse))
                              for f, fl in fwd_faults.items()}
            tols = {"milnce_fwd": MILNCE_VALUE_TOL, "milnce_fwd_lse": MILNCE_VALUE_TOL,
                    "milnce_dv": GRAD_TOL[name], "milnce_dt": GRAD_TOL[name]}
            tile = TILE if dtype == torch.bfloat16 else F32_TILE
            dv_splits = _wave_splits(-(-B * T // tile) * S, -(-B * N // tile), _build.sm_count(dev))
            emit({"phase": "kernel_milnce", "S": S, "R": B * T, "K": B * N, "C": C,
                  "text": "shared" if shared else "per-layer", "dtype": name,
                  "milnce_fwd_route": taken["milnce_fwd"],
                  "milnce_dv_route": taken["milnce_dv"], "milnce_dt_route": taken["milnce_dt"],
                  "milnce_dv_splits": dv_splits,
                  "padded_columns": int((~cv).sum()), "elem_err": errs, "abs_err": abs_errs,
                  "norm_err_dv_dt": [norm_err(x.grad, b) for x, b in zip(ins, plain)],
                  "rms_dv_dt": [rms(b) for b in plain], "tol": tols,
                  "planted_fault_elem_err": fault_errs,
                  "planted_fault_elem_err_fwd_lse": fwd_fault_errs,
                  **({"lse_err_fwd": f32_lse, "tol_lse_f32": MILNCE_LSE_F32_TOL,
                      "planted_fault_lse_err_fwd": f32_lse_faults}
                     if dtype == torch.float32 else {}),
                  "elem_err_fwd_lse_v1": v1_lse_err,
                  "elem_err_dv_vs_plain_from_kernel_lse": same_lse.get("dv", {}),
                  "elem_err_dt_vs_plain_from_kernel_lse": same_lse.get("dt", {}),
                  "fwd_calls_bit_equal": fwd_bit_equal, "grad_calls_bit_equal": bit_equal})
            check(bit_equal, f"MIL-NCE gradients {name}: two calls differ")
            check(fwd_bit_equal, f"milnce_fwd {name}: two calls differ")
            if dtype == torch.float32:
                worst[("milnce_fwd_lse_err", name)] = max(
                    worst.get(("milnce_fwd_lse_err", name), 0.0), f32_lse)
                check(f32_lse <= MILNCE_LSE_F32_TOL,
                      f"milnce_fwd f32 logsumexps (S, R, K) = {(S, B * T, B * N)}: {f32_lse}")
                for f, ferr in f32_lse_faults.items():
                    check(ferr > MILNCE_LSE_F32_TOL, f"limit {MILNCE_LSE_F32_TOL} misses the "
                                                     f"planted fault {f}: {ferr}")
            for kname, err in errs.items():
                worst[(kname, name)] = max(worst.get((kname, name), 0.0), abs_errs[kname])
                check(err <= tols[kname], f"{kname} {name} (S, R, K) = {(S, B * T, B * N)}: {err}")
            for f, err in fault_errs.items():
                check(err > GRAD_TOL[name], f"limit {GRAD_TOL[name]} misses the planted fault "
                                            f"{f}: {err}")
            for f, err in fwd_fault_errs.items():
                check(err > MILNCE_VALUE_TOL, f"limit {MILNCE_VALUE_TOL} misses the planted "
                                              f"fault {f}: {err}")
            if (S, B, T, N, C, shared) == MILNCE_SPLIT_SHAPE:
                check(dv_splits > 1, "milnce_dv took one split")
            for grad in ("dv", "dt"):
                err = same_lse.get(grad, {}).get(f"milnce_{grad}", 0.0)
                check(err <= GRAD_TOL[name],
                      f"milnce_{grad} against the plain version from its own logsumexps: {err}")
            check(all(bool(torch.isfinite(x).all())
                      for x in (*out, *klse, ins[0].grad, ins[1].grad)),
                  "MIL-NCE kernels non-finite")
            check(ins[1].grad.shape == t32.shape and ins[1].grad.dtype == dtype, "dt shape")
    v, t, pm, cv, _, _ = milnce_problem(torch, 2, 2, 64, 16, 512, False, gen, dev)
    for bad, what in (((v[..., :32].contiguous(), t[..., :32].contiguous(), pm, cv), "C"),
                      ((v, t, pm.float(), cv), "pos_mask")):
        try:
            fused_milnce_elements(*bad, mv, inv_temp)
        except ValueError:
            continue
        raise RuntimeError(f"MIL-NCE kernels accepted a bad {what}")
    return worst


def make_train_files(root, num_videos, seed, min_len=80):
    """A HowTo100M-format feature dir ({vid}.mp4.npy, 1 fps S3D-width
    features, min_len to 200 s), sentencified captions over the vocab
    'w0'..'w66249', and that vocab as an s3d_dict-style .npy."""
    rng = np.random.RandomState(seed)
    feats = os.path.join(root, "features")
    os.makedirs(feats, exist_ok=True)
    vocab = os.path.join(root, "vocab.npy")
    np.save(vocab, np.array([f"w{i}" for i in range(66250)]))
    captions = {}
    for i in range(num_videos):
        vlen = int(rng.randint(min_len, 201))
        np.save(os.path.join(feats, f"vid{i:03d}.mp4.npy"),
                rng.randn(vlen, 1024).astype(np.float32))
        t, rec = float(rng.rand() * 3), {"text": [], "start": [], "end": []}
        while t < vlen:
            d = float(rng.randint(2, 9))
            rec["text"].append(" ".join(f"w{w}" for w in rng.randint(0, 66250, rng.randint(3, 12))))
            rec["start"].append(t)
            rec["end"].append(t + d)
            t += d + float(rng.rand())
        captions[f"vid{i:03d}"] = rec
    cap_path = os.path.join(root, "captions.json")
    with open(cap_path, "w") as f:
        json.dump(captions, f)
    return feats, cap_path, vocab


def make_corpus(num_videos, min_len, max_len, seed, dim=1024):
    from temporalalignnet_torch.data.synthetic import synthetic_video_corpus

    corpus = synthetic_video_corpus(np.random.RandomState(seed), num_videos=num_videos,
                                    min_len=min_len, max_len=max_len, feature_dim=dim,
                                    vocab_size=5000)
    for item in corpus:
        for s in item["sentences"]:
            tok = s.pop("tokens")[:32]
            s["input_ids"] = np.pad(tok.astype(np.int32), (0, 32 - len(tok)))
    return corpus


def make_model(torch, device, dtype):
    from temporalalignnet_torch.core.config import ModelConfig
    from temporalalignnet_torch.models.net import TANWithText

    cfg = ModelConfig(use_alignability_head=True, random_pos_start=False)  # E6D6, width 512
    model = TANWithText(cfg, vocab_size=66251)
    model.init_weights(torch.Generator().manual_seed(SEED))
    return model.to(device=device, dtype=dtype).eval()


def count_forward_calls(model):
    """Wraps model.text_visual_sims: counts its calls in calls[0] and keeps
    the first call's arguments of each method (by ``dual``) in calls[1]."""
    calls = [0, {}]
    inner = model.text_visual_sims

    def counted(*a, **kw):
        calls[0] += 1
        calls[1].setdefault(kw.get("dual", True), (a, kw))
        return inner(*a, **kw)

    model.text_visual_sims = counted
    model.text_visual_sims.inner = inner
    return calls


def global_dual_check(torch, model, ev, corpus, per_video, calls):
    """The global method as it ran before it dropped the dual encoder (every
    call forced to dual=True): the same canvases and alignability to the
    bit, and its mha_fwd launches per call; then the ms of one global call
    both ways (CUDA events around back-to-back calls on the card)."""
    from temporalalignnet_torch.ops.mha_fwd import mha_fwd

    inner = model.text_visual_sims.inner
    counted = model.text_visual_sims
    model.text_visual_sims = lambda *a, **kw: counted(*a, **dict(kw, dual=True))
    try:
        torch.cuda.synchronize()
        mha_fwd.launches, calls[0] = 0, 0
        old = ev.evaluate_corpus(corpus)
        torch.cuda.synchronize()
        old_launches, old_calls = mha_fwd.launches, calls[0]
    finally:
        model.text_visual_sims = counted
    same = all(np.array_equal(a["sim"], b["sim"]) and np.array_equal(a["align_score"],
                                                                      b["align_score"])
               for a, b in zip(per_video, old))
    a, kw = calls[1][False]
    with torch.inference_mode():
        ms = {d: cuda_ms(torch, lambda: inner(*a, **dict(kw, dual=d)), reps=10)
              for d in (False, True)}
    return {"canvases_equal_to_dual_path": same, "dual_path_mha_fwd_per_call":
            old_launches / max(old_calls, 1), "call_shape": list(a[0].shape),
            "ms_per_call": ms[False], "dual_path_ms_per_call": ms[True],
            "timing": "cuda_events"}


def phase_eval(torch):
    from temporalalignnet_torch.core.config import EvalConfig
    from temporalalignnet_torch.eval.align import AlignmentEvaluator, alignment_metrics
    from temporalalignnet_torch.ops.mha_fwd import mha_fwd

    dev = torch.device("cuda")
    model = make_model(torch, dev, torch.bfloat16)
    corpus = make_corpus(8, 150, 600, SEED)
    calls = count_forward_calls(model)
    evaluators = {m: AlignmentEvaluator(model, EvalConfig(method=m))
                  for m in ("overlap-seq", "global")}

    results, routes, launches, forward_calls = {}, {}, {}, {}
    for method, ev in evaluators.items():
        torch.cuda.synchronize()
        mha_fwd.launches, calls[0] = 0, 0
        mha_fwd.launches_by_route = dict.fromkeys(mha_fwd.launches_by_route, 0)
        t0 = time.perf_counter()
        per_video = ev.evaluate_corpus(corpus)
        metrics = alignment_metrics(corpus, per_video)
        torch.cuda.synchronize()
        results[method] = (per_video, metrics, time.perf_counter() - t0)
        routes[method] = dict(mha_fwd.launches_by_route)
        launches[method], forward_calls[method] = mha_fwd.launches, calls[0]

    for method, (per_video, metrics, secs) in results.items():
        for item, res in zip(corpus, per_video):
            shape = (len(item["sentences"]), item["video"].shape[0])
            check(res["sim"].shape == shape, f"{method} canvas shape {res['sim'].shape} != {shape}")
            check(bool(np.isfinite(res["sim"]).all() and np.isfinite(res["align_score"]).all()),
                  f"{method} non-finite canvas")
        check(0.0 <= metrics["Recall"] <= 1.0 and 0.0 <= metrics["AUC"] <= 1.0,
              f"{method} metrics out of range: {metrics}")
        emit({"phase": "eval", "method": method, "dtype": "bfloat16", "videos": len(corpus),
              "vlens": [int(i["video"].shape[0]) for i in corpus], **metrics,
              "seconds": secs})
    glob = global_dual_check(torch, model, evaluators["global"], corpus,
                             results["global"][0], calls)
    emit({"phase": "eval", "forward_calls": forward_calls, "mha_fwd_launches": launches,
          "mha_fwd_routes": routes, "global": glob})
    # overlap-seq runs both encoders (12 blocks), global the joint one alone (6)
    for method, per_call in (("overlap-seq", 12), ("global", 6)):
        n, c = launches[method], forward_calls[method]
        check(c > 0 and n == per_call * c,
              f"{method}: {n} kernel launches for {c} forward calls, expected {per_call} each")
    check(glob["canvases_equal_to_dual_path"] and glob["dual_path_mha_fwd_per_call"] == 12,
          f"global method against its dual-encoder path: {glob}")
    # windows of 64 s (S = 64, 72) and whole videos of 150 s and more (S > 128)
    for method, only in (("overlap-seq", "short"), ("global", "long")):
        n = routes[method]
        check(n[only] > 0 and n[only] == sum(n.values()), f"{method} mha_fwd routes {n}")

    # f32: the whole slice on the card against its CPU path, same weights
    small = make_corpus(2, 100, 160, SEED + 1)
    models = {d: make_model(torch, torch.device(d), torch.float32) for d in ("cuda", "cpu")}
    for method in ("overlap-seq", "global"):
        out = {}
        for d, m in models.items():
            ev = AlignmentEvaluator(m, EvalConfig(method=method))
            per_video = ev.evaluate_corpus(small)
            out[d] = (per_video, alignment_metrics(small, per_video))
        (gpu_pv, gpu_m), (cpu_pv, cpu_m) = out["cuda"], out["cpu"]
        canvas_err = max(float(np.abs(g["sim"] - c["sim"]).max()) for g, c in zip(gpu_pv, cpu_pv))
        n_aligned = sum(s["aligned"] for item in small for s in item["sentences"])
        emit({"phase": "eval_f32_card_vs_cpu", "method": method, "canvas_max_abs_err": canvas_err,
              "card": gpu_m, "cpu": cpu_m, "tol": CANVAS_TOL})
        check(canvas_err <= CANVAS_TOL, f"{method} f32 canvas card vs cpu {canvas_err}")
        check(abs(gpu_m["Recall"] - cpu_m["Recall"]) * n_aligned <= 1 + 1e-9,
              f"{method} Recall card {gpu_m['Recall']} vs cpu {cpu_m['Recall']}")
        check(abs(gpu_m["AUC"] - cpu_m["AUC"]) <= AUC_TOL,
              f"{method} AUC card {gpu_m['AUC']} vs cpu {cpu_m['AUC']}")
    model.text_visual_sims = model.text_visual_sims.inner
    return model, launches


def phase_cli(torch, model):
    """The user's entry point, ``python -m temporalalignnet_torch.eval`` on
    the card (defaults: E6D6, bf16, head on), on a reference-format
    .pth.tar of the smoke model and an HTM-Align-format corpus on disk; its
    metrics must match the in-process evaluator's on the same files."""
    from temporalalignnet_torch.core.config import EvalConfig
    from temporalalignnet_torch.data.htm_align import HTMAlignDataset
    from temporalalignnet_torch.eval.align import AlignmentEvaluator
    from temporalalignnet_torch.models.word2vec import Word2VecTokenizer

    root = os.path.join(REPO, "build", "chip_smoke_cli")
    feats = os.path.join(root, "features")
    os.makedirs(feats, exist_ok=True)
    ckpt = os.path.join(root, "tan.pth.tar")
    torch.save({"epoch": 0, "state_dict": model.state_dict(), "iteration": 0}, ckpt)
    vocab = os.path.join(root, "vocab.npy")
    np.save(vocab, np.array([f"w{i}" for i in range(66250)]))  # token = index + 1
    anno = {}
    for i, item in enumerate(make_corpus(3, 100, 300, SEED + 3)):
        np.save(os.path.join(feats, f"vid{i}.npy"), item["video"])
        anno[f"vid{i}"] = [
            [s["aligned"], s["start"], s["end"],
             " ".join(f"w{t - 1}" for t in s["input_ids"] if t)]
            for s in item["sentences"]
        ]
    anno_path = os.path.join(root, "htm_align.json")
    with open(anno_path, "w") as f:
        json.dump(anno, f)
    corpus = list(HTMAlignDataset(feats, anno_path, Word2VecTokenizer(vocab), 32))
    n_aligned = sum(s["aligned"] for item in corpus for s in item["sentences"])
    # both methods' CLI runs at once (nothing here is timed but their wall)
    t0 = time.perf_counter()
    runs = {method: start([sys.executable, "-m", "temporalalignnet_torch.eval", "--task",
                           "align", "--ckpt", ckpt, "--features", feats, "--anno", anno_path,
                           "--vocab", vocab, "--method", method])
            for method in ("overlap-seq", "global")}
    try:
        for method, proc in runs.items():
            out = finish(proc, f"eval CLI {method}", timeout=600)
            cli = json.loads(out.strip().splitlines()[-1])
            direct = AlignmentEvaluator(model, EvalConfig(method=method)).evaluate(corpus)
            emit({"phase": "cli", "method": method, "cli": cli, "in_process": direct,
                  "seconds_both": time.perf_counter() - t0})
            # same bf16 model and files; only the order of index_add_'s atomic sums differs
            check(abs(cli["Recall"] - direct["Recall"]) * n_aligned <= 1 + 1e-9,
                  f"CLI {method} Recall {cli['Recall']} vs {direct['Recall']}")
            check(abs(cli["AUC"] - direct["AUC"]) <= AUC_TOL,
                  f"CLI {method} AUC {cli['AUC']} vs {direct['AUC']}")
    finally:
        stop(runs.values())
    return feats, anno_path, vocab


def train_setup(torch, device, fused, cfg_kw=None, state=None, compute=None, cotrain=False,
                train_kw=None, bert=False, multi=False, group=None, tp_group=None):
    """A TANWithText with its optimizer, train step and, for ``cotrain`` (head
    on, agreement targets), its EMA twin; params f32 from the seed (or
    ``state``; for cotrain merged as ``--pretrain`` does, so a Stage-1 state
    without the head loads), compute bf16 on the card unless ``compute``
    says; with ``bert`` the text tower is BERT at BERT_CFG's widths; with
    ``multi`` the step is ``make_multi_train_step``'s (a group of steps, on
    the card a CUDA graph replayed per batch); ``group``, a process
    group, makes the step the data-parallel one; ``tp_group`` shards the
    encoder blocks over its ranks (tensor parallelism).
    Returns (model, optimizer, step, twin or None)."""
    from temporalalignnet_torch.checkpoint import merge_state_dict
    from temporalalignnet_torch.core.config import LossConfig, ModelConfig, TrainConfig
    from temporalalignnet_torch.models.bert import BertConfig
    from temporalalignnet_torch.models.net import TANWithText
    from temporalalignnet_torch.train import (EMATwin, Optimizer, make_multi_train_step,
                                              make_train_step)

    cfg_kw = dict(cfg_kw or {}, language_model="bert") if bert else cfg_kw
    cfg = ModelConfig(fused_milnce=fused, use_alignability_head=cotrain, **(cfg_kw or {}))
    model = TANWithText(cfg, vocab_size=66251,
                        bert_config=BertConfig(**BERT_CFG) if bert else None)
    model.init_weights(torch.Generator().manual_seed(SEED))
    if state is not None and cotrain:
        model.load_state_dict(merge_state_dict(model.state_dict(), state)[0])
    elif state is not None:
        model.load_state_dict(state)
    model.to(device)
    if tp_group is not None:
        from temporalalignnet_torch.parallel.tensor import shard_model_

        shard_model_(model, tp_group)
    tcfg = TrainConfig(lr=TRAIN_LR, warmup_iterations=1, total_iterations=1000,
                       **(train_kw or {}))
    opt = Optimizer(model, tcfg)
    twin = EMATwin(model, tcfg) if cotrain else None
    if compute is None:
        compute = torch.bfloat16 if device.type == "cuda" else torch.float32
    loss_kw = dict(model="cotrain", learn_agreement=True, use_alignability_head=True) \
        if cotrain else {}
    step = (make_multi_train_step if multi else make_train_step)(
        model, opt, tcfg, LossConfig(use_fused_milnce=fused, **loss_kw), compute_dtype=compute,
        twin=twin, group=group)
    return model, opt, step, twin


def run_steps(torch, loader, step, n, wrap=None, wrap_at=0):
    """``n`` train steps over ``loader``'s epochs, each with the launch counts
    set to 0 just before it and read just after.  ``wrap(run)`` runs step
    ``wrap_at`` (from 0) itself.  Returns (the first two batches, each step's
    metrics as floats, launches per step, routes per step, seconds)."""
    batches, metrics, per_step, routes = [], [], [], []
    t0 = time.perf_counter()
    epoch = 0
    while len(metrics) < n:
        loader.set_epoch(epoch)
        epoch += 1
        for batch in loader:
            if len(batches) < 2:
                batches.append(batch)
            torch.cuda.synchronize()
            reset_counts()
            run = lambda: step(batch)
            out = wrap(run) if wrap and len(metrics) == wrap_at else run()
            torch.cuda.synchronize()
            per_step.append(read_counts())
            routes.append(read_routes())
            metrics.append({k: v.item() for k, v in out.items()})
            if len(metrics) == n:
                break
    return batches, metrics, per_step, routes, time.perf_counter() - t0


def check_launches(per_step, routes, launches, by_route, what):
    """Every step launched ``launches`` on the routes ``by_route``; returns
    the totals, with the routes' under "routes"."""
    for i, (counts, r) in enumerate(zip(per_step, routes)):
        check(counts == launches, f"{what} step {i} launched {counts}, expected {launches}")
        check(r == by_route, f"{what} step {i} routes {r}, expected {by_route}")
    totals = {k: sum(c[k] for c in per_step) for k in launches}
    totals["routes"] = {k: {r: sum(x[k][r] for x in routes) for r in v}
                        for k, v in by_route.items()}
    return totals


def phase_train(torch, files):
    """Stage-1 training through the kernels at B = 64 (slice 2's path), with
    its launches counted per step."""
    from temporalalignnet_torch.core.config import DataConfig
    from temporalalignnet_torch.data import HTMFeatureDataset, TrainLoader
    from temporalalignnet_torch.data.synthetic import synthetic_batch
    from temporalalignnet_torch.models.word2vec import Word2VecTokenizer

    dev = torch.device("cuda")
    feats, captions, vocab = files
    B, T, N, W = (TRAIN[k] for k in "BTNW")
    ds = HTMFeatureDataset(feats, captions, DataConfig(seq_len=T, max_sentences=N, max_words=W),
                           "train", Word2VecTokenizer(vocab, max_words=W))
    loader = TrainLoader(ds, B, seed=SEED, num_workers=8, pin_memory=True)
    model, opt, step, _ = train_setup(torch, dev, fused=True)
    init_state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    batches, metrics, per_step, routes, secs = run_steps(torch, loader, step, TRAIN_STEPS)
    losses = [m["loss"] for m in metrics]
    emit({"phase": "train", "model": "E6D6 width 512, word2vec, fused MIL-NCE, bf16",
          "batch": TRAIN, "videos": len(ds), "steps": len(metrics), "losses": losses,
          "launches_per_step": per_step[0], "routes_per_step": routes[0],
          "seconds_with_data": secs})
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    totals = check_launches(per_step, routes, STEP_LAUNCHES, STEP_ROUTES, "train")
    stage1_state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    del model, opt, step

    # the fused kernels against the plain logits path, on the card, bf16
    runs = {}
    for fused in (True, False):
        m, _, st, _ = train_setup(torch, dev, fused=fused, state=init_state)
        runs[fused] = two_steps(m, st, batches)
    loss_err, grad_err, worst_grad = compare_steps(runs[True], runs[False])
    emit({"phase": "train_fused_vs_plain", "dtype": "bfloat16", "losses_fused": runs[True][0],
          "losses_plain": runs[False][0], "loss_max_abs_err": loss_err,
          "grad_max_norm_err": grad_err, "worst_grad": worst_grad,
          "loss_tol": TRAIN_LOSS_TOL, "grad_tol": TRAIN_GRAD_TOL})
    check(loss_err <= TRAIN_LOSS_TOL, f"fused vs plain loss {loss_err}")
    check(grad_err <= TRAIN_GRAD_TOL, f"fused vs plain grads {grad_err} ({worst_grad})")

    # f32 on the card (the f32 kernels) against the CPU, reduced depth and batch
    small = [{k: torch.from_numpy(v) for k, v in synthetic_batch(
        np.random.RandomState(SEED + i), batch_size=8, seq_len=T, max_sentences=N,
        feature_dim=1024, vocab_size=66250, max_words=W).items()} for i in range(2)]
    state, res = None, {}
    for d in ("cuda", "cpu"):
        m, _, st, _ = train_setup(torch, torch.device(d), fused=True, state=state,
                                  cfg_kw=dict(num_encoder_layers=2, num_joint_layers=2),
                                  compute=torch.float32)
        state = state or {k: v.detach().cpu().clone() for k, v in m.state_dict().items()}
        res[d] = two_steps(m, st, small)
    loss_err, grad_err, worst_grad = compare_steps(res["cuda"], res["cpu"])
    emit({"phase": "train_f32_card_vs_cpu", "model": "E2D2 width 512, fused, f32", "batch": 8,
          "losses_card": res["cuda"][0], "losses_cpu": res["cpu"][0],
          "loss_max_abs_err": loss_err, "grad_max_norm_err": grad_err,
          "worst_grad": worst_grad, "tol": F32_STEP_TOL})
    check(loss_err <= F32_STEP_TOL, f"f32 step card vs cpu loss {loss_err}")
    check(grad_err <= F32_STEP_TOL, f"f32 step card vs cpu grads {grad_err} ({worst_grad})")
    return totals, stage1_state


class PlainAttention:
    """Within ``with``, attention on the card runs attention_reference
    (autograd through plain PyTorch) in place of the kernels."""

    def __enter__(self):
        from temporalalignnet_torch.ops import attention

        self.cls = attention.KernelAttention
        self.cls.apply = lambda q, k, v, mask: attention.attention_reference(q, k, v, mask)
        return self

    def __exit__(self, *exc):
        del self.cls.apply  # autograd.Function's own again


def phase_train_t128(torch):
    """The bf16 Stage-1 step at T = 128 (E6D6 width 512, B = 64, N = 16, fused
    MIL-NCE; joint S = 144, past the fused mha_bwd's 128): T128_STEPS counted
    steps on synthetic batches, each launching mha_bwd 6 times on the fused
    route (the dual encoder) and 6 on the long one (the joint encoder); two
    kernel steps against two plain ones (attention_reference and the plain
    logits) at phase_train's limits.  Then two counted f32 Stage-1 steps at
    T = 64, every kernel on its f32 route.  Returns the launches of both."""
    import contextlib

    from temporalalignnet_torch.data.synthetic import synthetic_batch

    dev = torch.device("cuda")
    B, N, W = (TRAIN[k] for k in "BNW")

    def batch_of(T, seed):
        return {k: torch.from_numpy(v).to(dev) for k, v in synthetic_batch(
            np.random.RandomState(seed), batch_size=B, seq_len=T, max_sentences=N,
            feature_dim=1024, vocab_size=66250, max_words=W).items()}

    def counted(step, batches, steps, routes, what):
        per_step, by_route, losses = [], [], []
        for i in range(steps):
            out, launches, r = counted_step(torch, step, batches[i % len(batches)])
            per_step.append(launches)
            by_route.append(r)
            losses.append(out["loss"].item())
        check(all(np.isfinite(losses)), f"{what}: non-finite loss {losses}")
        return losses, per_step[0], check_launches(per_step, by_route, STEP_LAUNCHES, routes, what)

    batches = [batch_of(128, SEED + 20 + i) for i in range(2)]
    model, _, step, _ = train_setup(torch, dev, fused=True)
    init_state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    losses, per_step, totals = counted(step, batches, T128_STEPS, T128_ROUTES, "train_t128")
    del model, step
    runs = {}
    for kernels in (True, False):
        m, _, st, _ = train_setup(torch, dev, fused=kernels, state=init_state)
        with contextlib.nullcontext() if kernels else PlainAttention():
            runs[kernels] = two_steps(m, st, batches)
        del m, st
    loss_err, grad_err, worst_grad = compare_steps(runs[True], runs[False])
    emit({"phase": "train_t128", "model": "E6D6 width 512, word2vec, fused MIL-NCE, bf16",
          "batch": dict(TRAIN, T=128), "losses": losses, "launches_per_step": per_step,
          "routes_per_step": T128_ROUTES, "losses_kernels": runs[True][0],
          "losses_plain": runs[False][0], "loss_max_abs_err": loss_err,
          "grad_max_norm_err": grad_err, "worst_grad": worst_grad,
          "loss_tol": TRAIN_LOSS_TOL, "grad_tol": TRAIN_GRAD_TOL})
    check(loss_err <= TRAIN_LOSS_TOL, f"T = 128 kernels vs plain loss {loss_err}")
    check(grad_err <= TRAIN_GRAD_TOL, f"T = 128 kernels vs plain grads {grad_err} ({worst_grad})")
    del runs
    m, _, st, _ = train_setup(torch, dev, fused=True, compute=torch.float32)
    f32_losses, f32_per_step, f32_totals = counted(st, [batch_of(TRAIN["T"], SEED + 22)], 2,
                                                   F32_STEP_ROUTES, "train_f32")
    emit({"phase": "train_f32_steps", "model": "E6D6 width 512, word2vec, fused MIL-NCE, f32",
          "batch": TRAIN, "losses": f32_losses, "launches_per_step": f32_per_step,
          "routes_per_step": F32_STEP_ROUTES})
    del m, st
    torch.cuda.empty_cache()
    return totals, f32_totals


def two_steps(model, step, batches, twin=None):
    """Losses, per-step {param: grad} and, with a twin, the target's
    {param: value} after the two steps (on the CPU) of two train steps."""
    losses, grads = [], []
    for batch in batches[:2]:
        losses.append(step(batch)["loss"].item())
        grads.append({n: p.grad.detach().float().cpu()
                      for n, p in model.named_parameters() if p.grad is not None})
    target = None if twin is None else {n: p.detach().float().cpu()
                                        for n, p in twin.model.named_parameters()}
    return losses, grads, target


def compare_steps(ours, theirs):
    """(max loss difference, worst per-tensor norm_err of the gradients, and
    the three worst tensors with |grad|) of two ``two_steps`` results."""
    check(all(set(a) == set(b) for a, b in zip(ours[1], theirs[1])),
          "grads of different params on the two paths")
    loss_err = max(abs(a - b) for a, b in zip(ours[0], theirs[0]))
    errs = sorted(((norm_err(a[n], b[n]), f"step {i} {n} |g| {b[n].norm().item():.3g}")
                   for i, (a, b) in enumerate(zip(ours[1], theirs[1])) for n in b), reverse=True)
    return loss_err, errs[0][0], errs[:3]


def target_err(ours, theirs):
    """The targets of two ``two_steps`` runs with a twin: (the worst
    |a - b| / (F32_STEP_TOL·|b| + TARGET_ATOL) over the elements, which
    must not exceed 1, its tensor, and the worst per-tensor norm_err)."""
    ratio, name = max(
        (((a - b).abs() / (F32_STEP_TOL * b.abs() + TARGET_ATOL)).max().item(), n)
        for n, b in theirs[2].items() for a in [ours[2][n]])
    return ratio, name, max(norm_err(ours[2][n], theirs[2][n]) for n in theirs[2])


def ema_check(twin, model, run, out):
    """Runs one train step (``run``) and fills ``out``: "err", the worst per
    tensor norm-relative error of the target after it against t·m + online·(1 - m) from
    the params just before and after it (in f64, m and 1 - m rounded to f32
    as the step rounds them), with its "tensor"; "planted", the same worst
    error of two wrong updates, the target left as it was and the EMA taken
    from the online params before the step, which must exceed EMA_TOL;
    "moved", whether the step changed the online params at all."""
    t_b = [p.detach().double() for p in twin.model.parameters()]
    o_b = [p.detach().double() for p in model.parameters()]
    res = run()
    m = np.float32(twin.momentum)
    m, w = float(m), float(np.float32(1) - m)
    o_a = [p.detach().double() for p in model.parameters()]
    want = [t * m + o * w for t, o in zip(t_b, o_a)]
    names = [n for n, _ in twin.model.named_parameters()]

    def worst(got):  # norm_err in f64
        return max(((g - x).norm().item() / max(x.norm().item(), 1e-30), n)
                   for g, x, n in zip(got, want, names))

    out["err"], out["tensor"] = worst([p.detach().double() for p in twin.model.parameters()])
    out["planted"] = {"target_unchanged": worst(t_b)[0],
                      "online_before_step": worst([t * m + o * w for t, o in zip(t_b, o_b)])[0]}
    out["moved"] = any(not a.equal(b) for a, b in zip(o_a, o_b))
    return res


class TargetRecorder:
    """Within ``with``, records every agreement_self_labelling call of
    get_loss: its inputs and its target, on the CPU."""

    def __enter__(self):
        from temporalalignnet_torch.losses import tan_loss

        self.module, self.inner, self.calls = tan_loss, tan_loss.agreement_self_labelling, []

        def recorded(*args, **kw):
            tgt, metrics = self.inner(*args, **kw)
            self.calls.append(([a.detach().cpu() if hasattr(a, "detach") else a for a in args],
                               tgt.cpu()))
            return tgt, metrics

        tan_loss.agreement_self_labelling = recorded
        return self

    def __exit__(self, *exc):
        self.module.agreement_self_labelling = self.inner


class ForcedTargets:
    """Within ``with``, get_loss's agreement self-labelling returns
    ``targets[i]`` (on its device) at its i-th call, with the metrics of the
    call it replaces: the same positives on two runs."""

    def __init__(self, targets):
        self.targets = targets

    def __enter__(self):
        from temporalalignnet_torch.losses import tan_loss

        self.module, self.inner, self.n = tan_loss, tan_loss.agreement_self_labelling, 0

        def forced(*args, **kw):
            tgt, metrics = self.inner(*args, **kw)
            self.n += 1
            return self.targets[self.n - 1].to(tgt.device, tgt.dtype), metrics

        tan_loss.agreement_self_labelling = forced
        return self

    def __exit__(self, *exc):
        self.module.agreement_self_labelling = self.inner


def window_margins(torch, args, b, n):
    """(joint, dual): the relative gap between the two best windows' scores of
    sentence n of video b for one recorded agreement call."""
    from temporalalignnet_torch.losses import agreement as ag

    joint, dual, vpm, tpm, raw, cfg = args
    C = ag._window_kernel_bank(raw, tpm.bool())
    gaps = []
    for x in (joint, dual):
        x = ag.pad_fill(x, vpm, tpm, cfg.mask_value)
        top = ag.window_scores(x, C, cfg.temperature)[b, n].topk(2).values
        gaps.append(((top[0] - top[1]) / top[0]).item())
    return gaps


def compare_targets(torch, ours, theirs):
    """The entries where two runs' agreement targets differ (step by step),
    and for each differing sentence the two best windows' margins of both
    runs' inputs: a difference is legitimate only at a near-tie."""
    check(len(ours) == len(theirs), f"{len(ours)} vs {len(theirs)} agreement calls")
    n_diff, where = 0, []
    for i, ((args_a, a), (args_b, b)) in enumerate(zip(ours, theirs)):
        differ = a != b
        n_diff += int(differ.sum())
        for bb, nn in sorted({(int(x), int(z)) for x, _, z in differ.nonzero().tolist()}):
            where.append({"step": i, "video": bb, "sentence": nn,
                          "margins_joint_dual": window_margins(torch, args_a, bb, nn),
                          "margins_joint_dual_other": window_margins(torch, args_b, bb, nn)})
    return n_diff, where


def phase_cotrain(torch, files, stage1_state):
    """Stage-2 co-training through the kernels at B = 64 from the Stage-1
    state of phase_train: the main path of this slice, its launches counted
    per step; the EMA rule; an f32 cotrain step on the card against the
    CPU's; the fused against the plain-logits cotrain step at full width."""
    from temporalalignnet_torch.core.config import DataConfig
    from temporalalignnet_torch.data import HTMFeatureDataset, TrainLoader
    from temporalalignnet_torch.data.synthetic import synthetic_batch
    from temporalalignnet_torch.models.word2vec import Word2VecTokenizer

    dev = torch.device("cuda")
    feats, captions, vocab = files
    B, T, N, W = (TRAIN[k] for k in "BTNW")
    ds = HTMFeatureDataset(feats, captions, DataConfig(seq_len=T, max_sentences=N, max_words=W),
                           "train", Word2VecTokenizer(vocab, max_words=W))
    loader = TrainLoader(ds, B, seed=SEED + 1, num_workers=8, pin_memory=True)
    model, _, step, twin = train_setup(torch, dev, fused=True, cotrain=True, state=stage1_state)
    init_state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    ema = {}
    # the EMA rule on the second step: the first updates with lr 0 (warm-up),
    # so after it online = t0 and any update of the target would read as right
    batches, metrics, per_step, routes, secs = run_steps(
        torch, loader, step, COTRAIN_STEPS, wrap=lambda run: ema_check(twin, model, run, ema),
        wrap_at=1)
    losses = [m["loss"] for m in metrics]
    ratios = [m["confidence-ratio"] for m in metrics]
    emit({"phase": "cotrain", "model": "E6D6 width 512, word2vec, fused MIL-NCE, bf16, "
          "agreement keep, head on, m 0.999", "batch": TRAIN, "steps": len(metrics),
          "losses": losses, "confidence_ratio": ratios,
          "launches_per_step": per_step[0], "routes_per_step": routes[0],
          "ema_step": 1, "ema_lr_moved_online": ema["moved"], "ema_max_norm_err": ema["err"],
          "ema_worst_tensor": ema["tensor"], "ema_planted_min_norm_err": ema["planted"],
          "ema_tol": EMA_TOL, "seconds_with_data": secs})
    check(all(np.isfinite(losses)), f"cotrain non-finite loss: {losses}")
    check(all(0.0 <= r <= 1.0 for r in ratios), f"confidence-ratio out of [0, 1]: {ratios}")
    check(ema["moved"], f"the EMA check's step left the online params as they were: {ema}")
    check(ema["err"] <= EMA_TOL, f"EMA update off t·m + online·(1 - m): {ema}")
    check(all(v > EMA_TOL for v in ema["planted"].values()),
          f"the EMA check passes a planted wrong update: {ema}")
    totals = check_launches(per_step, routes, COTRAIN_STEP_LAUNCHES, COTRAIN_STEP_ROUTES,
                            "cotrain")
    del model, step, twin

    # backprop_freq = 2: one micro-step accumulates and leaves the target bit-equal
    _, _, step, twin = train_setup(torch, dev, fused=True, cotrain=True, state=stage1_state,
                                   train_kw=dict(backprop_freq=2))
    before = [p.detach().clone() for p in twin.model.parameters()]
    step(batches[0])
    held = all(torch.equal(a, b) for a, b in zip(before, twin.model.parameters()))
    emit({"phase": "cotrain_micro_step", "backprop_freq": 2, "target_bit_equal": held})
    check(held, "the target moved on an accumulation-only micro-step")
    del step, twin, before

    # f32 on the card (the f32 kernels) against the CPU, reduced depth and batch
    small = [{k: torch.from_numpy(v) for k, v in synthetic_batch(
        np.random.RandomState(SEED + 10 + i), batch_size=8, seq_len=T, max_sentences=N,
        feature_dim=1024, vocab_size=66250, max_words=W).items()} for i in range(2)]
    state, res, rec = None, {}, {}
    for d in ("cuda", "cpu"):
        m, _, st, tw = train_setup(torch, torch.device(d), fused=True, state=state, cotrain=True,
                                   cfg_kw=dict(num_encoder_layers=2, num_joint_layers=2),
                                   compute=torch.float32)
        state = state or {k: v.detach().cpu().clone() for k, v in m.state_dict().items()}
        with TargetRecorder() as r:
            res[d] = two_steps(m, st, small, tw)
        rec[d] = r.calls
    n_diff, where = compare_targets(torch, rec["cuda"], rec["cpu"])
    loss_err, grad_err, worst_grad = compare_steps(res["cuda"], res["cpu"])
    t_err, t_worst, t_norm = target_err(res["cuda"], res["cpu"])
    emit({"phase": "cotrain_f32_card_vs_cpu", "model": "E2D2 width 512, fused, f32", "batch": 8,
          "target_entries_differing": n_diff, "differing_sentences": where,
          "losses_card": res["cuda"][0], "losses_cpu": res["cpu"][0],
          "loss_max_abs_err": loss_err, "grad_max_norm_err": grad_err, "worst_grad": worst_grad,
          "target_err_over_limit": t_err, "worst_target": t_worst,
          "target_max_norm_err": t_norm, "tol": F32_STEP_TOL, "target_atol": TARGET_ATOL})
    check(loss_err <= F32_STEP_TOL, f"f32 cotrain card vs cpu loss {loss_err}")
    check(grad_err <= F32_STEP_TOL, f"f32 cotrain card vs cpu grads {grad_err} ({worst_grad})")
    check(t_err <= 1.0, f"f32 cotrain card vs cpu target {t_err} of its limit ({t_worst})")

    # the fused kernels (their f32 routes) against the plain logits at full
    # width, f32 compute: in bf16 the two paths round the same-video diagonals
    # differently, and the discrete agreement targets may then legitimately
    # differ; the bf16 run above covers the wgmma and short routes
    runs, rec = {}, {}
    for fused in (True, False):
        m, _, st, tw = train_setup(torch, dev, fused=fused, state=init_state, cotrain=True,
                                   compute=torch.float32)
        torch.cuda.synchronize()
        reset_counts()
        with TargetRecorder() as r:
            runs[fused] = two_steps(m, st, batches, tw)
        rec[fused] = r.calls
        if fused:
            f32_routes = read_routes()
        del m, st, tw
    n_diff, where = compare_targets(torch, rec[True], rec[False])
    loss_err, grad_err, worst_grad = compare_steps(runs[True], runs[False])
    t_err, t_worst, t_norm = target_err(runs[True], runs[False])
    emit({"phase": "cotrain_fused_vs_plain", "model": "E6D6 width 512, f32", "batch": TRAIN,
          "fused_routes": f32_routes, "target_entries_differing": n_diff,
          "differing_sentences": where, "losses_fused": runs[True][0],
          "losses_plain": runs[False][0], "loss_max_abs_err": loss_err,
          "grad_max_norm_err": grad_err, "worst_grad": worst_grad,
          "target_err_over_limit": t_err, "worst_target": t_worst,
          "target_max_norm_err": t_norm, "tol": F32_STEP_TOL, "target_atol": TARGET_ATOL})
    for name, only in F32_COTRAIN_ROUTES.items():
        n = f32_routes[name]
        check(n[only] > 0 and n[only] == sum(n.values()), f"f32 cotrain {name} routes {n}")
    check(loss_err <= F32_STEP_TOL, f"f32 cotrain fused vs plain loss {loss_err}")
    check(grad_err <= F32_STEP_TOL, f"f32 cotrain fused vs plain grads {grad_err} ({worst_grad})")
    check(t_err <= 1.0, f"f32 cotrain fused vs plain target {t_err} of its limit ({t_worst})")
    return totals


def phase_cotrain_cli(torch, files, stage1_ckpt, eval_files):
    """The user's entry point for Stage 2, ``python -m
    temporalalignnet_torch.train --model cotrain --pretrain`` on the
    checkpoint phase_train_cli wrote, then the eval CLI on the twin
    checkpoint it writes."""
    feats, captions, vocab = files
    prefix = os.path.join(REPO, "build", "chip_smoke_train", "exp")
    t0 = time.perf_counter()
    out = finish(start(
        [sys.executable, "-m", "temporalalignnet_torch.train", "--model", "cotrain",
         "--pretrain", stage1_ckpt, "--feature_dir", feats, "--captions", captions,
         "--vocab", vocab, "--max_steps", "4", "--epochs", "4", "--log_every", "2",
         "--prefix", prefix]), "cotrain CLI", timeout=900)
    lines = [json.loads(l) for l in out.splitlines() if l.startswith("{")]
    report = [l for l in out.splitlines() if l.startswith("[pretrain]")]
    final = lines[-1]
    sd = torch.load(final["checkpoint"], map_location="cpu", weights_only=True)["state_dict"]
    halves = {p: sum(k.startswith(p) for k in sd) for p in ("online.", "target.")}
    emit({"phase": "cotrain_cli", "log": lines[:-1], "final": final, "pretrain_report": report,
          "state_dict_keys": halves, "seconds": time.perf_counter() - t0})
    check(final["final_step"] == 4 and final["loss_finite"], f"cotrain CLI final line {final}")
    check(all(np.isfinite(l["loss"]) and 0.0 <= l["confidence-ratio"] <= 1.0
              for l in lines[:-1]), "cotrain CLI logged a non-finite loss or a ratio out of range")
    check(halves["online."] > 0 and halves["online."] == halves["target."],
          f"cotrain checkpoint halves {halves}")

    e_feats, anno, e_vocab = eval_files
    t0 = time.perf_counter()
    out = finish(start(
        [sys.executable, "-m", "temporalalignnet_torch.eval", "--task", "align",
         "--ckpt", final["checkpoint"], "--features", e_feats, "--anno", anno,
         "--vocab", e_vocab]), "eval CLI on the twin checkpoint", timeout=600)
    metrics = json.loads(out.strip().splitlines()[-1])
    emit({"phase": "cotrain_cli_eval", "metrics": metrics, "seconds": time.perf_counter() - t0})
    check(0.0 <= metrics["Recall"] <= 1.0 and 0.0 <= metrics["AUC"] <= 1.0,
          f"eval of the twin checkpoint: {metrics}")


def phase_train_cli(torch, files, eval_files, yc2_files, cli_t128):
    """The user's entry point, ``python -m temporalalignnet_torch.train`` on the
    card (defaults: E6D6, B = 64, bf16, fused MIL-NCE), then at once the eval
    CLI's two tasks on the .pth.tar it wrote: HTM-Align, checked here, and YC2
    retrieval, whose metrics phase_retrieval_cli holds against the
    in-process evaluator.  Beside them the ``start_cli_t128`` child, released
    here and read last."""
    feats, captions, vocab = files
    prefix = os.path.join(REPO, "build", "chip_smoke_train", "exp")
    t0 = time.perf_counter()
    open(cli_t128[1], "w").close()  # its release
    out = finish(start(
        [sys.executable, "-m", "temporalalignnet_torch.train", "--feature_dir", feats,
         "--captions", captions, "--vocab", vocab, "--max_steps", "4", "--epochs", "4",
         "--log_every", "2", "--use_alignability_head", "1", "--prefix", prefix]),
        "train CLI", timeout=900)
    lines = [json.loads(l) for l in out.splitlines() if l.startswith("{")]
    final = lines[-1]
    emit({"phase": "train_cli", "log": lines[:-1], "final": final,
          "seconds": time.perf_counter() - t0})
    check(final["final_step"] == 4 and final["loss_finite"], f"train CLI final line {final}")
    check(all(np.isfinite(l["loss"]) for l in lines[:-1]), "train CLI logged a non-finite loss")

    e_feats, anno, e_vocab = eval_files
    y_feats, y_anno, y_vocab = yc2_files
    eval_cli = [sys.executable, "-m", "temporalalignnet_torch.eval", "--ckpt", final["checkpoint"]]
    t0 = time.perf_counter()
    procs = {"align": start(eval_cli + ["--task", "align", "--features", e_feats,
                                        "--anno", anno, "--vocab", e_vocab]),
             "retrieval": start(eval_cli + ["--task", "retrieval", "--features", y_feats,
                                            "--anno", y_anno, "--vocab", y_vocab])}
    try:
        outs = {task: json.loads(finish(proc, f"eval CLI {task} on the trained checkpoint",
                                        timeout=600).strip().splitlines()[-1])
                for task, proc in procs.items()}
    finally:
        stop(procs.values())
    secs = time.perf_counter() - t0
    metrics = outs["align"]
    emit({"phase": "train_cli_eval", "metrics": metrics, "seconds_both_tasks": secs})
    check(0.0 <= metrics["Recall"] <= 1.0 and 0.0 <= metrics["AUC"] <= 1.0,
          f"eval of the trained checkpoint: {metrics}")
    t128_per_step = finish_cli_t128(cli_t128, t0)
    return final["checkpoint"], {"metrics": outs["retrieval"], "align": metrics,
                                 "seconds_both_tasks": secs}, t128_per_step


def make_yc2_files(root, seed):
    """A YouCook2-format validation corpus: YC2["videos"] videos of 200-600 s
    of 1 fps S3D-width features ({vid}.npy) with about 7 clip annotations
    each, their segments drawn in turn from YC2_SEGMENTS so that every bucket
    Lb = 32 ... 256 of the retrieval windows and both branches of
    plan_clip_windows (lead: segment <= 256 s; lag: longer) are filled; the
    vocab as in make_train_files."""
    rng = np.random.RandomState(seed)
    feats = os.path.join(root, "features")
    os.makedirs(feats, exist_ok=True)
    vocab = os.path.join(root, "vocab.npy")
    np.save(vocab, np.array([f"w{i}" for i in range(66250)]))
    db, turn = {}, 0
    for i in range(YC2["videos"]):
        vlen = int(rng.randint(200, 601))
        np.save(os.path.join(feats, f"yc2vid{i:03d}.npy"), rng.randn(vlen, 1024).astype(np.float32))
        annos = []
        for _ in range(int(rng.randint(6, 9))):
            lo, hi = YC2_SEGMENTS[turn % len(YC2_SEGMENTS)]
            turn += 1
            d = min(float(rng.randint(lo, hi + 1)) + float(rng.rand()), vlen - 1.0)
            s = float(rng.rand() * (vlen - d))
            words = " ".join(f"w{w}" for w in rng.randint(0, 66250, rng.randint(3, 12)))
            annos.append({"segment": [s, s + d], "sentence": words})
        db[f"yc2vid{i:03d}"] = {"subset": "validation", "duration": float(vlen),
                                "annotations": annos}
    anno = os.path.join(root, "youcookii_annotations_trainval.json")
    with open(anno, "w") as f:
        json.dump({"database": db}, f)
    return feats, anno, vocab


def load_eval_model(torch, ckpt, device, dtype):
    """A reference-format .pth.tar as the eval CLI loads it (E6D6, head on)."""
    from temporalalignnet_torch.checkpoint import load_reference_checkpoint
    from temporalalignnet_torch.core.config import ModelConfig
    from temporalalignnet_torch.models.net import TANWithText

    model = TANWithText(ModelConfig(use_alignability_head=True, random_pos_start=False),
                        vocab_size=66251)
    load_reference_checkpoint(ckpt, model, verbose=False)
    return model.to(device=device, dtype=dtype).eval()


def count_visual_calls(torch, model):
    """Wraps model.visual_feature: per call its window bucket Lb and the
    mha_fwd launches by route it made (counted with the launches it adds)."""
    from temporalalignnet_torch.ops.mha_fwd import mha_fwd

    calls, inner = [], model.visual_feature

    def counted(video, *a, **kw):
        before = dict(mha_fwd.launches_by_route)
        out = inner(video, *a, **kw)
        calls.append((int(video.shape[0]), int(video.shape[1]),
                      {r: n - before[r] for r, n in mha_fwd.launches_by_route.items()}))
        return out

    model.visual_feature = counted
    return calls


def retrieval_ordered(metrics):
    return all(metrics[f"{p}R1"] <= metrics[f"{p}R5"] <= metrics[f"{p}R10"]
               for p in ("", "C-", "S-"))


def phase_retrieval(torch, stage1_ckpt, yc2_files):
    """This slice's eval path: RetrievalEvaluator (num_clips 10, bf16, E6D6)
    on the Stage-1 checkpoint phase_train_cli wrote and the synthetic YC2
    corpus; every forward call must launch mha_fwd 6 times on the route of
    its bucket.  Then the same evaluation in f32 on the card and on the CPU
    for 40 clips (four of each segment kind): pooled features within
    RETRIEVAL_F32_TOL, metrics equal."""
    from temporalalignnet_torch.core.config import EvalConfig
    from temporalalignnet_torch.data import YC2RetrievalDataset
    from temporalalignnet_torch.eval.retrieval import RetrievalEvaluator, retrieval_scores
    from temporalalignnet_torch.models.word2vec import Word2VecTokenizer
    from temporalalignnet_torch.ops.mha_fwd import mha_fwd, route

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    feats, anno, vocab = yc2_files
    items = list(YC2RetrievalDataset(feats, anno, "val", Word2VecTokenizer(vocab), 32))
    model = load_eval_model(torch, stage1_ckpt, dev, torch.bfloat16)
    calls = count_visual_calls(torch, model)
    ev = RetrievalEvaluator(model, EvalConfig())
    buckets = sorted({ev._prepare_item(it)[2] for it in items})
    lags = sum(it["end"] - it["start"] >= 257 for it in items)

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    metrics = ev.evaluate(items)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches, by_route = mha_fwd.launches, dict(mha_fwd.launches_by_route)
    calls = list(calls)
    windows = sum(b for b, _, _ in calls)
    routes_ok = all(r == {**dict.fromkeys(by_route, 0), route(torch.bfloat16, Lb): 6}
                    for _, Lb, r in calls)

    # (the device ms of a forward call: retrieval_forward_times, in a child)
    emit({"phase": "retrieval", "model": "E6D6 width 512, bf16, Stage-1 checkpoint",
          "clips": len(items), "videos": YC2["videos"], "num_clips": 10,
          "buckets": buckets, "lag_clips": lags, "forward_calls": len(calls),
          "windows": windows, "mha_fwd_launches": launches, "mha_fwd_routes": by_route,
          "metrics": metrics, "seconds": secs, "clips_per_s": len(items) / secs,
          "windows_per_s": windows / secs})
    check(buckets == list(range(32, 257, 32)), f"retrieval buckets {buckets}")
    check(lags > 0, "no clip took the lag branch")
    check(launches == 6 * len(calls) and routes_ok,
          f"{launches} mha_fwd launches for {len(calls)} forward calls, routes {by_route}")
    check(len(metrics) == 12 and all(np.isfinite(v) for v in metrics.values()),
          f"retrieval metrics {metrics}")
    check(retrieval_ordered(metrics), f"retrieval R@1 <= R@5 <= R@10 fails: {metrics}")
    retrieval_launches = {"launches": launches, "by_route": by_route, "forward_calls": len(calls)}
    del model, ev, calls

    # f32, card against the CPU, same weights, on 40 clips
    kinds = [[] for _ in YC2_SEGMENTS]
    for it in items:
        d = it["end"] - it["start"]
        kind = next(j for j, (lo, hi) in enumerate(YC2_SEGMENTS) if lo <= d < hi + 1)
        kinds[kind].append(it)
    small = [it for group in kinds for it in group[:4]]
    out = {}
    for d in ("cuda", "cpu"):
        m = load_eval_model(torch, stage1_ckpt, torch.device(d), torch.float32)
        e = RetrievalEvaluator(m, EvalConfig())
        V, X = e.clip_features(small), e.text_features(np.stack([it["input_ids"] for it in small]))
        out[d] = (V, X, retrieval_scores(V, X))
    (vc, xc, mc), (vh, xh, mh) = out["cuda"], out["cpu"]
    clip_err, text_err = float(np.abs(vc - vh).max()), float(np.abs(xc - xh).max())
    emit({"phase": "retrieval_f32_card_vs_cpu", "clips": len(small),
          "clip_feature_max_abs_err": clip_err, "text_feature_max_abs_err": text_err,
          "tol": RETRIEVAL_F32_TOL, "card": mc, "cpu": mh,
          "seconds": time.perf_counter() - t_phase})
    check(clip_err <= RETRIEVAL_F32_TOL and text_err <= RETRIEVAL_F32_TOL,
          f"f32 retrieval features card vs cpu: clip {clip_err}, text {text_err}")
    check(mc == mh, f"f32 retrieval metrics card {mc} vs cpu {mh}")
    return metrics, retrieval_launches


def phase_retrieval_cli(cli, in_process):
    """``python -m temporalalignnet_torch.eval --task retrieval`` (defaults:
    E6D6, bf16, num_clips 10; run by phase_train_cli) on the same checkpoint
    and corpus must print the in-process evaluator's metrics."""
    emit({"phase": "retrieval_cli", "cli": cli["metrics"], "in_process": in_process,
          "seconds_both_tasks": cli["seconds_both_tasks"]})
    check(cli["metrics"] == in_process,
          f"eval CLI retrieval {cli['metrics']} vs in process {in_process}")


def train_cli_in_process(argv):
    """The train CLI's main() in this process, its printing captured:
    (final line, per-step losses)."""
    import contextlib
    import io

    from temporalalignnet_torch.train.cli import main as train_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = train_main(argv)
    return out, buf.getvalue()


def logged_losses(text):
    return [json.loads(l)["loss"] for l in text.splitlines() if l.startswith('{"step"')]


def state_err(torch, a_path, b_path):
    """Max |a - b| over every tensor of two checkpoints' state_dicts (with a
    twin, both halves)."""
    a, b = (torch.load(p, map_location="cpu", weights_only=True, mmap=True)["state_dict"]
            for p in (a_path, b_path))
    check(a.keys() == b.keys(), "checkpoints of different key sets")
    return max((a[k].float() - b[k].float()).abs().max().item() for k in a)


def phase_resume(torch, yc2_files):
    """Kill-free rehearsal of a crash: a run stopped at step k (a runtime
    checkpoint at k, and with it the downstream YC2 eval) and continued by
    ``--resume auto`` in a new process, against the uninterrupted 2k-step
    run done twice, whose difference is the card's own spread: per-step
    losses and final params (and the twin's) must stay within it.  Stage 1
    at E6D6, B = 64, bf16, fused; cotrain at E2D2 with backprop_freq 2,
    stopped mid-accumulation.  The runs of both cases (two whole, one
    stopped each) go at once, each a train CLI process; then both resumed
    runs at once.  Returns the training files (RESUME["videos"] videos, kept
    for the data-parallel phase)."""
    t_phase = time.perf_counter()
    make_spares(3 * len(RESUME["cases"]))  # in place of the ones these runs take
    feats, captions, vocab = make_train_files(os.path.join(REPO, "build", "chip_smoke_resume"),
                                              RESUME["videos"], SEED + 20)
    y_feats, y_anno, _ = yc2_files
    cli = [sys.executable, "-m", "temporalalignnet_torch.train"]
    first, runs = {}, {}
    t0 = time.perf_counter()
    for case, k, extra in RESUME["cases"]:
        root = os.path.join(REPO, "build", "chip_smoke_resume", case)
        base = ["--feature_dir", feats, "--captions", captions, "--vocab", vocab,
                "--log_every", "1", "--epochs", "4", "--warmup_iterations", "2", *extra]
        first[case] = (k, root, base, [start(cli + base + [
            "--prefix", os.path.join(root, f"whole{i}"), "--max_steps", str(2 * k),
            "--runtime_save_iter", "0"]) for i in range(2)] + [start(cli + base + [
                "--prefix", os.path.join(root, "stopped"), "--max_steps", str(k),
                "--runtime_save_iter", str(k), "--yc2_anno", y_anno, "--yc2_features", y_feats])])
    try:
        for case, (k, root, base, procs) in first.items():
            outs = [finish(proc, f"{case} {what} run", timeout=900)
                    for proc, what in zip(procs, ("whole", "whole", "stopped"))]
            whole = [(json.loads(out.strip().splitlines()[-1]), out) for out in outs[:2]]
            runs[case] = (k, root, base, whole, outs[2],
                          {"whole_two_and_stopped_all_at_once": time.perf_counter() - t0})
    finally:
        stop([proc for *_, procs in first.values() for proc in procs])
    t0 = time.perf_counter()
    procs = {case: start([*cli, *base,
                          "--prefix", os.path.join(root, "stopped"), "--max_steps", str(2 * k),
                          "--runtime_save_iter", "0", "--resume", "auto"])
             for case, (k, root, base, *_) in runs.items()}
    try:
        for case, (k, root, _, whole, stopped_log, run_seconds) in runs.items():
            out = finish(procs[case], f"resumed {case} run", timeout=900)
            run_seconds["resumed_both_at_once"] = time.perf_counter() - t0
            resumed_out = json.loads(out.strip().splitlines()[-1])
            evals = [json.loads(l) for l in stopped_log.splitlines()
                     if l.startswith('{"eval_step"')]
            saves = [json.loads(l) for l in stopped_log.splitlines()
                     if l.startswith('{"runtime_checkpoint"')]
            losses = [logged_losses(log) for _, log in whole]
            joined = logged_losses(stopped_log) + logged_losses(out)
            spread_loss = max(abs(a - b) for a, b in zip(*losses))
            loss_err = max(abs(a - b) for a, b in zip(joined, losses[0]))
            spread_param = state_err(torch, whole[0][0]["checkpoint"], whole[1][0]["checkpoint"])
            param_err = state_err(torch, whole[0][0]["checkpoint"], resumed_out["checkpoint"])
            row = {"phase": "resume", "case": case, "stop_at": k, "steps": 2 * k,
                   "losses_uninterrupted": losses[0], "losses_stopped_then_resumed": joined,
                   "spread_loss": spread_loss, "loss_max_abs_err": loss_err,
                   "spread_param": spread_param, "param_max_abs_err": param_err,
                   "resumed_line": [l for l in out.splitlines() if l.startswith("[resume]")],
                   "runtime_save_seconds": [x["seconds"] for x in saves],
                   "runtime_save_evals": evals, "run_seconds": run_seconds}
            emit(row)
            check(len(joined) == len(losses[0]) == 2 * k and all(np.isfinite(joined)),
                  f"{case}: losses {joined}")
            check(loss_err <= spread_loss and param_err <= spread_param,
                  f"{case}: resumed run off the uninterrupted one beyond their spread: {row}")
            check(evals and evals[0]["eval_step"] == k and retrieval_ordered(evals[0]),
                  f"{case}: no retrieval metrics at the runtime save: {evals}")
            subprocess.run(["rm", "-rf", root], check=True)  # several GB of checkpoints
    finally:
        stop(procs.values())
    emit({"phase": "resume_seconds", "seconds": time.perf_counter() - t_phase})
    return feats, captions, vocab


def timed_row(torch, fns, nbytes, flops, bw, peak, reps=20, **info):
    """Device ms (profiler) and CUDA-event ms of each of ``fns`` {prefix: fn}
    over ``reps`` calls, beside the bound max(bytes / bw, flops / peak); for
    the kernel's own call (prefix "") also the device ms of each kernel it
    launched."""
    row = dict(info)
    for prefix, fn in fns.items():
        row[prefix + "ms"], per_kernel, _, row[prefix + "timing"] = device_profile(
            torch, fn, reps=reps, confirm=True)
        if not prefix:
            row["kernels_ms"] = {k[:60]: v for k, v in per_kernel.items()}
        row[prefix + "wall_ms"] = cuda_ms(torch, fn, reps=reps)
    t_bytes, t_ops = nbytes / bw, flops / peak
    row.update(bound_ms=max(t_bytes, t_ops) * 1e3,
               bound_by="bytes" if t_bytes >= t_ops else "operations", bytes=nbytes, flops=flops)
    return row


def phase_train_times(torch, card):
    import torch.nn.functional as F

    from temporalalignnet_torch.ops import milnce
    from temporalalignnet_torch.ops.attention import attention_reference
    from temporalalignnet_torch.ops.mha_bwd import mha_bwd, route

    dev = torch.device("cuda")
    bw, peak = peaks(card)
    gen = torch.Generator().manual_seed(SEED + 7)
    rows = {}
    bf16, f32 = torch.bfloat16, torch.float32
    # bf16 at the training shapes, BERT's and the tensor-parallel ones, and past
    # S = 128 (the long route); f32 at the training shapes
    specs = ([(sh, bf16) for sh in MHA_BWD_SHAPES[:2] + [BERT_SHAPE] + TP_SHAPES]
             + [(sh, bf16) for sh in MHA_BWD_LONG_TIMED_SHAPES]
             + [(sh, f32) for sh in MHA_BWD_SHAPES[:2]])
    for shape, dtype in specs:
        Bq, H, S, D = shape
        q, k, v, g = (torch.randn(shape, generator=gen).to(dev, dtype) for _ in range(4))
        pad = tower_mask(torch, shape, gen, dev)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        plain_out = attention_reference(*leaves, pad)
        lib = [t.clone().requires_grad_() for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*lib, attn_mask=~pad[:, None, None, :])
        fns = {"": lambda: mha_bwd(q, k, v, pad, g),
               "plain_": lambda: torch.autograd.grad(plain_out, leaves, g, retain_graph=True),
               "library_": lambda: torch.autograd.grad(lib_out, lib, g, retain_graph=True)}
        which = route(dtype, S)
        # q, dout, dq, dk, dv; QK^T, dout V^T, P^T dout, dS K, dS^T Q
        nbytes, flops = attention_work(q, pad, full=5, passes=5)
        row = timed_row(torch, fns, nbytes, flops, bw, peak, shape=list(shape),
                        dtype=str(dtype).split(".")[-1], route=which)
        if dtype == f32:
            row.update(f32_bounds(card, nbytes, flops))
        emit({"phase": "times", "kernel": "mha_bwd", "card": card, **row})
        key = (("mha_bwd", "tp", S) if shape in TP_SHAPES else ("mha_bwd", "f32", S)
               if dtype == f32 else ("mha_bwd", S))
        rows[key] = row

    inv_temp, mv = 1.0 / 0.07, -6.0e4
    # bf16 at every MIL-NCE shape; f32 at the training shape (shared and per-layer text)
    for (S_, Bm, Tm, Nm, C, shared), dtype in ([(sh, bf16) for sh in MILNCE_SHAPES]
                                               + [(sh, f32) for sh in MILNCE_SHAPES[:2]]):
        v, t, pm, cv, gv, gt = milnce_problem(torch, S_, Bm, Tm, Nm, C, shared, gen, dev)
        v, t = v.to(dtype), t.to(dtype)
        lse = milnce.milnce_fwd(v, t, pm, cv, mv, inv_temp)
        vr, tr = v.clone().requires_grad_(), t.clone().requires_grad_()
        a, b = milnce.milnce_reference(vr, tr, pm, cv, mv, inv_temp)
        plain_loss = (a * gv).sum() + (b * gt).sum()
        R, K = Bm * Tm, Bm * Nm
        size = v.element_size()
        feat_bytes = (v.numel() + t.numel()) * size + pm.numel() + cv.numel()
        lse_bytes = (2 * S_ * R + 2 * S_ * K) * 4
        cases = {
            "milnce_fwd": ({"": lambda: milnce.milnce_fwd(v, t, pm, cv, mv, inv_temp),
                            "v1_": lambda: milnce.milnce_fwd_v1(v, t, pm, cv, mv, inv_temp),
                            "plain_": lambda: milnce.milnce_reference(
                                v.detach(), t.detach(), pm, cv, mv, inv_temp)},
                           feat_bytes + lse_bytes, 2 * S_ * R * K * C),
            "milnce_dv": ({"": lambda: milnce.milnce_dv(v, t, pm, cv, lse, gv, gt, inv_temp),
                           "v2_": lambda: milnce.milnce_dv_v2(v, t, pm, cv, lse, gv, gt,
                                                              inv_temp),
                           "plain_": lambda: torch.autograd.grad(plain_loss, [vr],
                                                                 retain_graph=True)},
                          feat_bytes + 2 * lse_bytes + v.numel() * size, 4 * S_ * R * K * C),
            "milnce_dt": ({"": lambda: milnce.milnce_dt(v, t, pm, cv, lse, gv, gt, inv_temp),
                           "v2_": lambda: milnce.milnce_dt_v2(v, t, pm, cv, lse, gv, gt,
                                                              inv_temp),
                           "plain_": lambda: torch.autograd.grad(plain_loss, [tr],
                                                                 retain_graph=True)},
                          feat_bytes + 2 * lse_bytes + t.numel() * size, 4 * S_ * R * K * C),
        }
        for name, (fns, nbytes, flops) in cases.items():
            if dtype == f32:  # the earlier kernels are bf16
                fns = {p_: f for p_, f in fns.items() if p_ in ("", "plain_")}
            with torch.no_grad() if name == "milnce_fwd" else torch.enable_grad():
                # the f32 kernels take milliseconds a call: 5 calls a session
                row = timed_row(torch, fns, nbytes, flops, bw, peak,
                                reps=5 if dtype == f32 else 20, S=S_, R=R, K=K, C=C,
                                text="shared" if shared else "per-layer",
                                dtype=str(dtype).split(".")[-1], library_ms=None)
            if dtype == f32:
                row.update(f32_bounds(card, nbytes, flops))
            emit({"phase": "times", "kernel": name, "card": card, **row})
            rows[(name, S_, R, K, shared) if dtype == bf16 else
                 (name, "f32", S_, R, K, shared)] = row
    return rows


def phase_eval_forward_times(torch, model, card):
    """Eval-forward windows/s with the forward's device time: the last
    profile of this process, right after the kernel rows and the eval
    phase (on an H100 its session lost device activity when it came after
    the training phases); beside it the same forward as a loaded
    ``torch.export`` program (tools/export_eval.py)."""
    from temporalalignnet_torch.tools import export_eval as ee

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 2)
    B, T, C, N, W = (BENCH[k] for k in "BTCNW")
    video = torch.randn(B, T, C, generator=gen).to(dev, torch.bfloat16)
    ids = torch.randint(1, 60000, (B, N, W), generator=gen).to(dev)
    mask = (ids != 0).int()

    def forward():
        with torch.inference_mode():
            model.text_visual_sims(video, model.encode_text(ids, mask))

    fwd_ms = cuda_ms(torch, forward)
    busy_ms, per_kernel, _, timing = device_profile(torch, forward)
    busy_ms = busy_ms if timing == "profiler" else None  # events time the host too
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]
    # slice 8: the same forward as the loaded torch.export program (its video
    # float32, cast inside), on the same weights and ids
    params = ee.eval_params(model)
    program = ee.deserialize(ee.serialize(ee.export_eval_forward(model, params, B, T, C, N,
                                                                 W))).module()
    video32 = video.float()

    def serve():
        with torch.no_grad():
            program(params, video32, ids)

    serve_ms = cuda_ms(torch, serve)
    serve_busy, _, _, serve_timing = device_profile(torch, serve)
    serve_busy = serve_busy if serve_timing == "profiler" else None
    emit({"phase": "times", "metric": "eval_forward_windows_per_s", "card": card,
          "value": B / (fwd_ms / 1e3), "ms_per_call": fwd_ms, "workload": BENCH,
          "model": "E6D6 width 512, bf16, head on", "device_busy_ms_per_call": busy_ms,
          "idle_share": None if busy_ms is None else max(0.0, 1.0 - busy_ms / fwd_ms),
          "top_kernels_ms_per_call": {k[:90]: v for k, v in top},
          "loaded_program": {"windows_per_s": B / (serve_ms / 1e3), "ms_per_call": serve_ms,
                             "device_busy_ms_per_call": serve_busy, "timing": serve_timing}})


def phase_eval_forward_f32_times(torch, card):
    """The eval forward of the bench.py workload in f32, as ``eval --f32`` runs
    it (E6D6, head on): device ms of one call (profiler) beside the CUDA-event
    ms, and mha_fwd's launches per call by route (12, all on ``f32``) with
    their device ms."""
    from temporalalignnet_torch.ops.mha_fwd import mha_fwd

    dev = torch.device("cuda")
    model = make_model(torch, dev, torch.float32)
    gen = torch.Generator().manual_seed(SEED + 2)
    B, T, C, N, W = (BENCH[k] for k in "BTCNW")
    video = torch.randn(B, T, C, generator=gen).to(dev)
    ids = torch.randint(1, 60000, (B, N, W), generator=gen).to(dev)
    mask = (ids != 0).int()

    def forward():
        with torch.inference_mode():
            model.text_visual_sims(video, model.encode_text(ids, mask))

    before = dict(mha_fwd.launches_by_route)
    forward()
    torch.cuda.synchronize()
    per_call = {r: n - before[r] for r, n in mha_fwd.launches_by_route.items()}
    fwd_ms = cuda_ms(torch, forward, reps=5)  # a call takes ~33 ms
    busy_ms, per_kernel, _, timing = device_profile(torch, forward, reps=5)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    emit({"phase": "times", "metric": "eval_forward_f32_device_ms", "card": card,
          "workload": BENCH, "model": "E6D6 width 512, f32, head on",
          "device_ms_per_call": busy_ms if timing == "profiler" else None, "timing": timing,
          "ms_per_call": fwd_ms, "mha_fwd_launches_per_call": per_call,
          "mha_fwd_device_ms_per_call": sum(v for k, v in per_kernel.items() if "mha_fwd" in k),
          "top_kernels_ms_per_call": {k[:90]: v for k, v in top}})
    check(per_call["f32"] == 12 and sum(per_call.values()) == 12,
          f"f32 eval forward: mha_fwd launches per call {per_call}, expected 12 on f32")
    del model
    torch.cuda.empty_cache()


# ------------------------------------------------------ slice 13: the decoder stack

# models/transformer.py::TemporalDecoder at the TAN's width over the dual
# encoder's stream: B windows of T video tokens, the last quarter of each
# window padded, on a memory of M sentence tokens with ragged padding
DECODER = dict(width=512, heads=8, layers=6, mlp_ratio=4, B=64, T=64, M=16)


def decoder_expected(kernel, route):
    """(counts, routes) of a decoder call that launches ``kernel`` once a
    block on ``route`` and nothing else."""
    routes = {k: dict.fromkeys(v, 0) for k, v in STEP_ROUTES.items()}
    routes[kernel][route] = DECODER["layers"]
    return {k: sum(v.values()) for k, v in routes.items()}, routes


def decoder_case(torch):
    """The DECODER stack with random weights from the seed and its inputs, on
    the CPU: (model, x, memory, tgt_pad, mem_pad, the scalar's weights)."""
    from temporalalignnet_torch.models import TemporalDecoder

    W, H, L, R, B, T, M = (DECODER[k] for k in ("width", "heads", "layers", "mlp_ratio", "B",
                                                "T", "M"))
    model = TemporalDecoder(W, L, H, R).init_weights(torch.Generator().manual_seed(SEED + 30))
    gen = torch.Generator().manual_seed(SEED + 31)
    x, memory = torch.randn(B, T, W, generator=gen), torch.randn(B, M, W, generator=gen)
    tgt_pad = (torch.arange(T) >= T - T // 4)[None].repeat(B, 1)
    mem_pad = torch.arange(M)[None] >= torch.randint(1, M + 1, (B,), generator=gen)[:, None]
    weights = [torch.randn(B, T, W, generator=gen) for _ in range(L)]
    return model, x, memory, tgt_pad, mem_pad, weights


def decoder_scalar(taps, weights):
    """A random projection of the decoder's taps: the backward's seed."""
    return sum((t.float() * w).sum() / t.numel() ** 0.5 for t, w in zip(taps, weights))


def phase_decoder(torch, card):
    """The cross-attention decoder stack (random weights from the seed) on the
    card: its self-attention through mha_fwd and, under autograd, mha_bwd;
    its cross-attention plain (``ops/attention.py::cross_attention``).  The
    f32 taps and gradients of a scalar of the taps (every parameter, x and
    the memory) against the CPU's (routes ``f32``, F32_STEP_TOL); the bf16
    ones (autocast, routes ``short`` and ``fused``) against the plain
    attention on the card (PlainAttention) at phase_train's gradient bar;
    the padded memory rows set to 999 must leave the taps as they were; each
    forward and backward's launches by route (one a block, no MIL-NCE
    kernel).  Its device ms come from the ``decoder`` step-time child
    (``decoder_times``)."""
    import contextlib
    import copy

    from temporalalignnet_torch.ops.attention import cross_attention

    dev, cpu = torch.device("cuda"), torch.device("cpu")
    model, x, memory, tgt_pad, mem_pad, weights = decoder_case(torch)
    on_card = copy.deepcopy(model).to(dev)
    weights = {d: [w.to(d) for w in weights] for d in (cpu, dev)}
    padded = memory.masked_fill(mem_pad[..., None], 999.0)
    L = DECODER["layers"]

    def scalar(taps, device):
        return decoder_scalar(taps, weights[device])

    def run(m, device, bf16, mem=memory, grads=True, plain=False):
        """(taps f32 on the CPU, {name: gradient on the CPU} (with x's and the
        memory's), the scalar, the forward's and the backward's (counts,
        routes))."""
        m.zero_grad(set_to_none=True)
        xx, mm = (t.detach().to(device).requires_grad_(grads) for t in (x, mem))
        masks = tgt_pad.to(device), mem_pad.to(device)
        sync = torch.cuda.synchronize
        with PlainAttention() if plain else contextlib.nullcontext(), \
                torch.set_grad_enabled(grads):
            sync()
            reset_counts()
            with torch.autocast("cuda", dtype=torch.bfloat16, enabled=bf16):
                taps = m(xx, mm, *masks)
            sync()
            fwd = read_counts(), read_routes()
            loss = scalar(taps, device)
            bwd = None
            if grads:
                reset_counts()
                loss.backward()
                sync()
                bwd = read_counts(), read_routes()
        g = {n: p.grad.float().cpu() for n, p in m.named_parameters()} if grads else None
        if grads:
            g.update(x=xx.grad.float().cpu(), memory=mm.grad.float().cpu())
        return [t.detach().float().cpu() for t in taps], g, loss.item(), fwd, bwd

    def compare(ours, ref):
        """(scalar |a - b|, worst tap norm_err, worst gradient norm_err, its name)."""
        taps = max(norm_err(a, b) for a, b in zip(ours[0], ref[0]))
        grad, name = max((norm_err(ours[1][n], b), n) for n, b in ref[1].items())
        return abs(ours[2] - ref[2]), taps, grad, name

    calls, t0 = cross_attention.calls, time.perf_counter()
    f32_cpu = run(model, cpu, False)
    seconds = {"f32_cpu": time.perf_counter() - t0}
    f32_card = run(on_card, dev, False)
    kernels, plain = run(on_card, dev, True), run(on_card, dev, True, plain=True)
    moved = run(on_card, dev, True, mem=padded, grads=False)
    cross_calls = cross_attention.calls - calls
    seconds["all_runs"] = time.perf_counter() - t0
    f32_err, bf16_err = compare(f32_card, f32_cpu), compare(kernels, plain)
    pad_err = max(abs_err(a, b) for a, b in zip(moved[0], kernels[0]))

    expected = {"f32_forward": decoder_expected("mha_fwd", "f32"),
                "f32_backward": decoder_expected("mha_bwd", "f32"),
                "bf16_forward": decoder_expected("mha_fwd", "short"),
                "bf16_backward": decoder_expected("mha_bwd", "fused")}
    seen = {"f32_forward": f32_card[3], "f32_backward": f32_card[4],
            "bf16_forward": kernels[3], "bf16_backward": kernels[4]}
    emit({"phase": "decoder", "card": card, "power": card_power(),
          "model": decoder_name(),
          "shape": {"B": x.shape[0], "T": x.shape[1], "M": memory.shape[1],
                    "tgt_padded_per_window": int(tgt_pad[0].sum()),
                    "memory_valid": [int(n) for n in (~mem_pad).sum(1)[:8]]},
          "launches": {k: v[0] for k, v in seen.items()},
          "routes": {k: {n: v[1][n] for n in ("mha_fwd", "mha_bwd")} for k, v in seen.items()},
          "plain_launches": {"forward": plain[3][0], "backward": plain[4][0]},
          "cross_attention_calls": cross_calls,
          "f32_card_vs_cpu": dict(zip(("scalar_abs_err", "tap_norm_err", "grad_norm_err",
                                       "worst_grad"), f32_err), tol=F32_STEP_TOL),
          "bf16_kernels_vs_plain": dict(zip(("scalar_abs_err", "tap_norm_err", "grad_norm_err",
                                             "worst_grad"), bf16_err),
                                        scalar=plain[2], tol=TRAIN_GRAD_TOL),
          "padded_memory_max_abs_err": pad_err, "padded_memory_tol": F32_TOL,
          "seconds": seconds})
    for what, (counts, routes) in expected.items():
        check(seen[what] == (counts, routes), f"decoder {what} launched {seen[what]}")
    zero = {k: 0 for k in STEP_LAUNCHES}
    check(plain[3][0] == zero and plain[4][0] == zero, "the plain decoder launched a kernel")
    check(cross_calls == 5 * L, f"cross_attention ran {cross_calls} times, expected {5 * L}")
    check(all(torch.isfinite(t).all() for t in kernels[0] + f32_card[0]), "non-finite taps")
    check(f32_err[0] <= F32_STEP_TOL and f32_err[1] <= F32_STEP_TOL
          and f32_err[2] <= F32_STEP_TOL, f"decoder f32 card vs CPU {f32_err}")
    # bf16: the taps and gradients norm-relative at phase_train's gradient bar;
    # the scalar, a random projection of the taps, errs by their norm_err
    # times their rms and has no bar of its own
    check(bf16_err[1] <= TRAIN_GRAD_TOL and bf16_err[2] <= TRAIN_GRAD_TOL,
          f"decoder bf16 kernels vs plain {bf16_err}")
    check(pad_err <= F32_TOL, f"padded memory moved the taps by {pad_err}")
    del on_card
    torch.cuda.empty_cache()
    return {name: {"bf16_forward": kernels[3][0][name], "bf16_backward": kernels[4][0][name]}
            for name in STEP_LAUNCHES}, {k: v[1] for k, v in seen.items()}


def decoder_name():
    return "TemporalDecoder width {width}, {heads} heads, {layers} blocks, mlp ratio " \
           "{mlp_ratio}".format(**DECODER)


def decoder_times(torch, card, ready=lambda: None):
    """The ``decoder`` step-time child: the device ms (profiler, 5 calls a
    session) and the host-inclusive ms (CUDA events) of phase_decoder's bf16
    forward and forward + backward, with the port's kernels' and the top
    kernels' device ms.  In a process of its own: in the whole run's
    process, after the eval forward's profiles, the profiler sessions of
    these calls recorded no device time."""
    dev = torch.device("cuda")
    model, x, memory, tgt_pad, mem_pad, weights = decoder_case(torch)
    model.to(dev)
    x, memory, tgt_pad, mem_pad = (t.to(dev) for t in (x, memory, tgt_pad, mem_pad))
    weights = [w.to(dev) for w in weights]

    def forward():
        with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
            model(x, memory, tgt_pad, mem_pad)

    def forward_backward():
        model.zero_grad(set_to_none=True)
        with torch.autocast("cuda", dtype=torch.bfloat16):
            taps = model(x, memory, tgt_pad, mem_pad)
        decoder_scalar(taps, weights).backward()

    ready()
    times = {}
    for what, fn in (("forward", forward), ("forward_backward", forward_backward)):
        ms, per_kernel, _, timing = device_profile(torch, fn, reps=5)
        wall = cuda_ms(torch, fn, reps=5)
        times[what] = {"device_ms": ms if timing == "profiler" else None, "timing": timing,
                       "ms": wall, "idle_share": max(0.0, 1.0 - ms / wall)
                       if timing == "profiler" else None,
                       "port_kernels_ms": {k[:60]: v for k, v in per_kernel.items()
                                           if "mha_fwd" in k or "mha_bwd" in k},
                       "top_kernels_ms": dict(list(by_name(per_kernel, 60).items())[:8])}
    emit({"phase": "times", "metric": "decoder_bf16_ms", "card": card, "power": card_power(),
          "model": decoder_name() + ", bf16 autocast, f32 params",
          "shape": {k: DECODER[k] for k in ("B", "T", "M")}, **times})


# slice 13: the train CLI at --seq_len 128 (joint S = 144: mha_bwd's long route)
# on feature files of 128 s or more, in a child that counts the wrappers'
# launches over the run (bench_tool_child); CLI_T128["steps"] steps, as many
# epochs (a filtered epoch of fewer than 2 B videos is one step)
CLI_T128 = dict(videos=128, steps=2)


def start_cli_t128(files):
    """The --seq_len 128 train CLI child, started now; phase_train_cli
    releases it and reads it."""
    feats, captions, vocab = files
    prefix = os.path.join(REPO, "build", "chip_smoke_train_t128", "exp")
    return start_gated("--bench-tool", "temporalalignnet_torch.train", (
        "--feature_dir", feats, "--captions", captions, "--vocab", vocab, "--seq_len", "128",
        "--max_steps", str(CLI_T128["steps"]), "--epochs", str(CLI_T128["steps"]),
        "--log_every", "1",
        "--prefix", prefix), name="cli_t128")


def finish_cli_t128(child, t0):
    """The --seq_len 128 train CLI's lines, checked; returns its launches
    per step and, by route, per step."""
    out = finish(child[0], "train CLI at --seq_len 128", timeout=900)
    jsons = [json.loads(l) for l in out.splitlines() if l.startswith("{")]
    final = next(j for j in jsons if "final_step" in j)
    counts = next(j for j in jsons if "bench_counts" in j)
    n = final["final_step"]
    per_step = {k: v / max(n, 1) for k, v in counts["bench_counts"].items()}
    routes = {k: {r: c / max(n, 1) for r, c in v.items()}
              for k, v in counts["bench_routes"].items()}
    emit({"phase": "train_cli_t128", "final": final,
          "losses": [j["loss"] for j in jsons if "step" in j and "loss" in j],
          "launches": counts["bench_counts"], "routes": counts["bench_routes"],
          "launches_per_step": per_step, "routes_per_step": routes,
          "seconds_from_release": time.perf_counter() - t0})
    check(n == CLI_T128["steps"] and final["loss_finite"], f"--seq_len 128 CLI final {final}")
    check(counts["bench_counts"] == {k: v * n for k, v in STEP_LAUNCHES.items()},
          f"--seq_len 128 CLI launched {counts['bench_counts']} over {n} steps")
    check(counts["bench_routes"] == {k: {r: c * n for r, c in v.items()}
                                     for k, v in T128_ROUTES.items()},
          f"--seq_len 128 CLI routes {counts['bench_routes']}")
    return per_step, routes


def synthetic_train_batch(torch, B, seed):
    """A train batch of TRAIN's shapes at batch size B, on the card."""
    from temporalalignnet_torch.data.synthetic import synthetic_batch

    T, N, W = (TRAIN[k] for k in "TNW")
    return {k: torch.from_numpy(v).to(torch.device("cuda")) for k, v in synthetic_batch(
        np.random.RandomState(seed), batch_size=B, seq_len=T, max_sentences=N,
        feature_dim=1024, vocab_size=66250, max_words=W).items()}


def counted_step(torch, step, batch):
    """One train step with the launch counts set to 0 just before it and read
    just after: (metrics, launches, routes)."""
    torch.cuda.synchronize()
    reset_counts()
    out = step(batch)
    torch.cuda.synchronize()
    return out, read_counts(), read_routes()


def step_peak_bytes(torch, step, batch):
    """torch.cuda.max_memory_allocated over one train step (after a warm-up
    step), and the bytes allocated before it."""
    step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    step(batch)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated(), before


def phase_remat(torch):
    """Slice 5's --remat path: the E6D6 Stage-1 step at B = 64, bf16, fused,
    with every encoder block under torch.utils.checkpoint.  Two steps from
    one state on one batch with remat on and off: losses, gradients and
    params equal to the bit, or held to compare_steps' limits; launches per
    step (REMAT_STEP_LAUNCHES: the backward recomputes each block's forward,
    so mha_fwd twice per block); a cotrain step with remat (36 mha_fwd);
    the peak memory of a step at B = 64 and 256 both ways.  The device ms
    per step come from ``chip_smoke.py --step-times remat``."""
    dev = torch.device("cuda")
    batch = synthetic_train_batch(torch, TRAIN["B"], SEED + 9)
    big = {B: synthetic_train_batch(torch, B, SEED + 10) for B in REMAT_MEMORY_BATCHES}
    runs, counts, memory = {}, {}, {}
    for remat in (False, True):
        model, _, step, _ = train_setup(torch, dev, fused=True, cfg_kw=dict(remat=remat))
        losses, grads, per_step = [], [], []
        for _ in range(2):
            out, n, r = counted_step(torch, step, batch)
            losses.append(out["loss"].item())
            grads.append({k: p.grad.detach().float().cpu() for k, p in model.named_parameters()
                          if p.grad is not None})
            per_step.append((n, r))
        params = {k: v.detach().float().cpu() for k, v in model.state_dict().items()}
        runs[remat], counts[remat] = (losses, grads, params), per_step
        for B, b in big.items():
            peak, before = step_peak_bytes(torch, step, b)
            memory[f"B{B}_{'remat' if remat else 'plain'}"] = {
                "max_memory_allocated": peak, "allocated_before_step": before}
        del model, step
        torch.cuda.empty_cache()
    (l0, g0, p0), (l1, g1, p1) = runs[False], runs[True]
    bit_equal = (l0 == l1 and all(torch.equal(a[k], b[k]) for a, b in zip(g0, g1) for k in a)
                 and all(torch.equal(p0[k], p1[k]) for k in p0))
    loss_err, grad_err, worst = compare_steps((l1, g1), (l0, g0))
    param_err = max((p0[k] - p1[k]).abs().max().item() for k in p0)
    # a cotrain step with remat: the twin's no-grad forward runs plain
    _, _, cstep, _ = train_setup(torch, dev, fused=True, cotrain=True, cfg_kw=dict(remat=True))
    _, cot_counts, cot_routes = counted_step(torch, cstep, batch)
    del cstep
    emit({"phase": "remat", "model": "E6D6 width 512, fused, bf16", "batch": TRAIN,
          "losses_plain": l0, "losses_remat": l1, "bit_equal": bit_equal,
          "loss_max_abs_err": loss_err, "grad_max_norm_err": grad_err, "worst_grad": worst,
          "param_max_abs_err": param_err, "loss_tol": TRAIN_LOSS_TOL, "grad_tol": TRAIN_GRAD_TOL,
          "launches_per_step": counts[True][0][0], "routes_per_step": counts[True][0][1],
          "launches_per_step_plain": counts[False][0][0],
          "cotrain_launches_per_step": cot_counts, "memory_bytes": memory})
    check(bit_equal or (loss_err <= TRAIN_LOSS_TOL and grad_err <= TRAIN_GRAD_TOL),
          f"remat against plain steps: loss {loss_err}, grads {grad_err} ({worst})")
    for (n, r), want, want_r in ((c, REMAT_STEP_LAUNCHES, REMAT_STEP_ROUTES)
                                 for c in counts[True]):
        check(n == want and r == want_r, f"remat step launched {n} {r}, expected {want}")
    check(all(n == STEP_LAUNCHES for n, _ in counts[False]),
          f"plain step launched {counts[False]}")
    check(cot_counts == REMAT_COTRAIN_LAUNCHES and cot_routes["mha_fwd"]["short"] == 36,
          f"cotrain step with remat launched {cot_counts} {cot_routes}")
    largest = f"B{REMAT_MEMORY_BATCHES[-1]}_"
    check(memory[largest + "remat"]["max_memory_allocated"]
          < memory[largest + "plain"]["max_memory_allocated"], f"remat saved no memory: {memory}")
    return {k: sum(c[0][k] for c in counts[True]) for k in REMAT_STEP_LAUNCHES}


def phase_cache_videos(torch, files):
    """--cache_videos: 10 Stage-1 steps through the data pipeline (the
    train phase's loader, 8 threads) with the per-video host cache off and
    at its default 256: seconds_with_data each, and the losses, which must
    be equal (the same samples)."""
    from temporalalignnet_torch.core.config import DataConfig
    from temporalalignnet_torch.data import HTMFeatureDataset, TrainLoader
    from temporalalignnet_torch.models.word2vec import Word2VecTokenizer

    dev = torch.device("cuda")
    feats, captions, vocab = files
    B, T, N, W = (TRAIN[k] for k in "BTNW")
    out = {}
    for cache in (0, 256):
        ds = HTMFeatureDataset(feats, captions, DataConfig(seq_len=T, max_sentences=N,
                                                           max_words=W),
                               "train", Word2VecTokenizer(vocab, max_words=W),
                               cache_videos=cache)
        loader = TrainLoader(ds, B, seed=SEED, num_workers=8, pin_memory=True)
        _, _, step, _ = train_setup(torch, dev, fused=True)
        _, metrics, _, _, secs = run_steps(torch, loader, step, TRAIN_STEPS)
        out[cache] = {"seconds_with_data": secs, "losses": [m["loss"] for m in metrics],
                      "videos_cached": len(ds._cache._d)}
    emit({"phase": "cache_videos", "steps": TRAIN_STEPS, "batch": TRAIN,
          **{f"cache_videos_{k}": v for k, v in out.items()}})
    check(out[0]["losses"] == out[256]["losses"],
          f"cached and uncached samples trained differently: {out}")


def write_milnce_file(torch, path):
    """A synthetic s3d_howto100m.pth: the word2vec text tower (66251 x 300
    table, fc1 300 -> 2048, fc2 2048 -> 512) and the 1024 -> 512 fc from the
    seed, a few S3D conv and BN tensors, one key the converter does not
    recognise, under "state_dict" with DataParallel's "module." prefix.
    Returns the text tower's tensors."""
    g = torch.Generator().manual_seed(SEED + 11)
    rand = lambda *s: torch.randn(*s, generator=g) * 0.05
    text = {"word_embd.weight": rand(66251, 300), "fc1.weight": rand(2048, 300),
            "fc1.bias": rand(2048), "fc2.weight": rand(512, 2048), "fc2.bias": rand(512)}
    sd = {f"module.text_module.{k}": v for k, v in text.items()}
    sd.update({"module.fc.weight": rand(512, 1024), "module.fc.bias": rand(512),
               "module.conv1.conv1.weight": rand(64, 3, 3, 7, 7),
               "module.conv1.bn1.weight": rand(64), "module.conv1.bn1.bias": rand(64),
               "module.conv1.bn1.running_mean": rand(64),
               "module.conv1.bn1.running_var": rand(64).abs(),
               "module.conv1.bn1.num_batches_tracked": torch.tensor(3),
               "module.mixed_3b.gating.scale": rand(8)})
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({"state_dict": sd}, path)
    return text


def phase_milnce_ckpt(torch, files):
    """--milnce_ckpt: the train CLI (E6D6, B = 32, bf16, fused) runs 3 steps
    (one epoch of the 96 videos) from a synthetic s3d_howto100m.pth, as
    Stage 1 and as cotrain; when the
    train step is built (after the merge, before any step) the language
    model holds the file's tensors, and under cotrain so does the EMA twin's
    copy; the losses are finite.  Launches are counted over each run."""
    from temporalalignnet_torch.train import train_step

    feats, captions, vocab = files
    root = os.path.join(REPO, "build", "chip_smoke_milnce")
    path = os.path.join(root, "s3d_howto100m.pth")
    text = write_milnce_file(torch, path)
    inner = train_step.make_train_step
    built = {}

    def capture(model, optimizer, *a, twin=None, **kw):
        built["online"] = {k: v.detach().cpu().clone() for k, v in model.bert.state_dict().items()}
        built["target"] = None if twin is None else {
            k: v.detach().cpu().clone() for k, v in twin.model.bert.state_dict().items()}
        return inner(model, optimizer, *a, twin=twin, **kw)

    launches = {}
    train_step.make_train_step = capture
    try:
        for model in ("init", "cotrain"):
            built.clear()
            t0 = time.perf_counter()
            torch.cuda.synchronize()
            reset_counts()
            out, log = train_cli_in_process(
                ["--model", model, "--milnce_ckpt", path, "--feature_dir", feats,
                 "--captions", captions, "--vocab", vocab, "--batch_size", "32",
                 "--max_steps", "3", "--log_every", "1", "--runtime_save_iter", "0",
                 "--prefix", os.path.join(root, "exp")])
            torch.cuda.synchronize()
            launches[model] = read_counts()
            halves = {h: sd for h, sd in built.items() if sd is not None}
            equal = {h: sorted(sd) == sorted(text) and all(torch.equal(sd[k], text[k])
                                                           for k in text)
                     for h, sd in halves.items()}
            report = [l for l in log.splitlines() if l.startswith(("[milnce]", "[s3d_convert]"))]
            losses = logged_losses(log)
            emit({"phase": "milnce_ckpt", "model": model, "losses": losses,
                  "final_step": out["final_step"], "lang_model_equals_file": equal,
                  "report": report, "launches": launches[model],
                  "seconds": time.perf_counter() - t0})
            check(out["final_step"] == 3 and out["loss_finite"] and len(losses) == 3
                  and all(np.isfinite(losses)), f"--milnce_ckpt {model}: {out} {losses}")
            check(all(equal.values()) and len(equal) == (2 if model == "cotrain" else 1),
                  f"--milnce_ckpt {model}: the language model against the file: {equal}")
            per_step = COTRAIN_STEP_LAUNCHES if model == "cotrain" else STEP_LAUNCHES
            check(launches[model] == {k: 3 * n for k, n in per_step.items()},
                  f"--milnce_ckpt {model} launched {launches[model]}")
    finally:
        train_step.make_train_step = inner
    return path, launches


def phase_baseline(torch, eval_files, yc2_files, milnce_path):
    """The eval CLI's raw-feature baseline (no --ckpt, --milnce_ckpt of
    phase_milnce_ckpt's file, dot product): --task align by both methods on
    the cli phase's corpus and --task retrieval on the YC2 corpus, in f32 on
    the card and on the CPU, whose metrics must be equal, and in bf16 on the
    card (printed).  The baseline launches no kernel."""
    from temporalalignnet_torch.eval.cli import main as eval_main

    import contextlib
    import io

    e_feats, anno, e_vocab = eval_files
    y_feats, y_anno, y_vocab = yc2_files
    tasks = {"align_overlap-seq": ["--task", "align", "--method", "overlap-seq",
                                   "--features", e_feats, "--anno", anno, "--vocab", e_vocab],
             "align_global": ["--task", "align", "--method", "global", "--features", e_feats,
                              "--anno", anno, "--vocab", e_vocab],
             "retrieval": ["--task", "retrieval", "--features", y_feats, "--anno", y_anno,
                           "--vocab", y_vocab]}
    modes = {"card_f32": ["--f32"], "cpu": ["--device", "cpu"], "card_bf16": []}
    for task, args in tasks.items():
        out = {}
        for mode, extra in modes.items():
            t0 = time.perf_counter()
            torch.cuda.synchronize()
            reset_counts()
            with contextlib.redirect_stdout(io.StringIO()):
                metrics = eval_main(args + ["--milnce_ckpt", milnce_path] + extra)
            out[mode] = {"metrics": metrics, "seconds": time.perf_counter() - t0,
                         "launches": sum(read_counts().values())}
        emit({"phase": "baseline", "task": task, "sim": "dot", **out})
        check(out["card_f32"]["metrics"] == out["cpu"]["metrics"],
              f"baseline {task}: f32 card {out['card_f32']['metrics']} vs cpu "
              f"{out['cpu']['metrics']}")
        check(all(np.isfinite(v) for o in out.values() for v in o["metrics"].values()),
              f"baseline {task}: non-finite metrics")
        check(all(o["launches"] == 0 for o in out.values()), f"baseline {task} launched a kernel")


PROFILE_KERNELS = ("mha_fwd_wgmma", "mha_bwd_fused", "milnce_fwd_wgmma", "milnce_grad_wgmma")


def start_profile_dir(files):
    """--profile_dir: the train CLI (E6D6, B = 32, bf16, fused, --remat 1)
    for 3 steps (one epoch of the 96 videos) in a child process, its torch.profiler trace written to
    build/chip_smoke_profile/; read by phase_profile_dir."""
    feats, captions, vocab = files
    root = os.path.join(REPO, "build", "chip_smoke_profile")
    return start([sys.executable, "-m", "temporalalignnet_torch.train", "--feature_dir", feats,
                  "--captions", captions, "--vocab", vocab, "--batch_size", "32",
                  "--max_steps", "3", "--log_every", "1", "--runtime_save_iter", "0", "--remat", "1",
                  "--profile_dir", os.path.join(root, "trace"),
                  "--prefix", os.path.join(root, "exp")]), root


def phase_profile_dir(child):
    """The trace the --profile_dir child wrote names the port's kernels
    (PROFILE_KERNELS, the bf16 routes of mha_fwd, mha_bwd and the MIL-NCE
    forward and gradients) among its device events; and the train CLI's
    metrics log (train.metrics.jsonl) holds its train/* lines."""
    proc, root = child
    t0 = time.perf_counter()
    out = finish(proc, "train CLI with --profile_dir", timeout=600)
    final = json.loads(out.strip().splitlines()[-1])
    traces = [os.path.join(root, "trace", f) for f in os.listdir(os.path.join(root, "trace"))
              if f.startswith("trace_") and f.endswith(".json")]
    check(len(traces) == 1, f"--profile_dir wrote {traces}")
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    named = {k: sum(k in e.get("name", "") for e in kernels) for k in PROFILE_KERNELS}
    exp = [os.path.join(root, "exp", d) for d in os.listdir(os.path.join(root, "exp"))]
    with open(os.path.join(exp[0], "train.metrics.jsonl")) as f:
        logged = [json.loads(l) for l in f]
    emit({"phase": "profile_dir", "final": final, "trace": os.path.relpath(traces[0], REPO),
          "trace_bytes": os.path.getsize(traces[0]), "device_kernel_events": len(kernels),
          "kernel_events_by_name": named, "metrics_log_lines": len(logged),
          "metrics_log_keys": sorted(logged[-1]) if logged else [],
          "wait_seconds": time.perf_counter() - t0})
    check(final["final_step"] == 3 and final["loss_finite"], f"--profile_dir run {final}")
    check(all(named.values()), f"the trace lacks kernels: {named}")
    check(len(logged) == 3 and all("train/device/sps" in l for l in logged),
          f"train.metrics.jsonl: {logged}")


# ------------------------------------------------------------- slice 6: S3D


def randomize_bn_stats(torch, model, seed):
    """BN running statistics drawn as tests/test_end2end.py:150-155 draws them
    (means U(-0.2, 0.2), variances U(0.5, 1.5)), so a stats mix-up shows."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(torch.rand(b.shape, generator=g) * 0.4 - 0.2)
            elif name.endswith("running_var"):
                b.copy_(torch.rand(b.shape, generator=g) + 0.5)
    return model


def s3d_weights(torch, seed, text=False, **kw):
    """An S3D (``text``: S3DWithText, vocab 66,251) of random weights from
    ``seed``, BN statistics randomised, f32 on the CPU."""
    from temporalalignnet_torch.models.s3d import S3D
    from temporalalignnet_torch.train.end2end import S3DWithText

    model = (S3DWithText if text else S3D)(**kw)
    model.init_weights(torch.Generator().manual_seed(seed))
    return randomize_bn_stats(torch, model, seed + 1)


def e2e_clips(torch, seed, B, T, S):
    """[B, 3, T, S, S] clips in [0, 1]: the permute of the pipeline's
    [B, T, S, S, 3], so channels_last_3d."""
    x = np.random.RandomState(seed).rand(B, T, S, S, 3).astype(np.float32)
    return torch.from_numpy(x).permute(0, 4, 1, 2, 3)


def s3d_macs(torch, model, x, stem=False):
    """Multiply-adds per clip of one S3D forward on ``x``, from the output
    shapes: every Conv3d and Linear, and conv1 at its 3 x 4 x 8 x 8 raw-pixel
    window (folded or not, 768 terms per output); ``stem``: (all, conv1's)."""
    total, hooks = [0, 0], []

    def add(n, first=False):
        total[0] += n
        total[1] += n if first else 0

    for name, m in model.named_modules():
        if name == "conv1":
            hooks.append(m.register_forward_hook(
                lambda m, i, o: add(o.numel() * 768, first=True)))
        elif isinstance(m, torch.nn.Conv3d) and name != "conv1.conv1":
            hooks.append(m.register_forward_hook(lambda m, i, o: add(
                o.numel() * m.in_channels * int(np.prod(m.kernel_size)))))
        elif isinstance(m, torch.nn.Linear) and not name.startswith("text_module"):
            hooks.append(m.register_forward_hook(lambda m, i, o: add(o.numel() * m.in_features)))
    try:
        with torch.no_grad():
            model(x, return_embedding=False)
    finally:
        for h in hooks:
            h.remove()
    per_clip = (total[0] // x.shape[0], total[1] // x.shape[0])
    return per_clip if stem else per_clip[0]


def phase_s3d(torch, card):
    """S3D-G at the e2e width on one 16 x 224² clip, random weights from the
    seed with random BN statistics: f32 on the card against the CPU, the
    folded conv1 against space_to_depth + conv1 (f32, card), bf16 against
    f32 on the card, and every block's and BN's output dtype under bf16
    autocast.  Returns the forward's multiply-adds per clip."""
    from temporalalignnet_torch.models.s3d import S3D, BatchNorm

    dev = torch.device("cuda")
    cpu = s3d_weights(torch, SEED + 20).eval()
    x = e2e_clips(torch, SEED + 21, 1, E2E["T"], E2E["S"])
    t0 = time.perf_counter()
    with torch.no_grad():
        want = cpu(x, return_embedding=True)
        want_logits = cpu.fc(want)
    cpu_seconds = time.perf_counter() - t0
    macs = s3d_macs(torch, cpu, x)
    card_model = S3D()
    card_model.load_state_dict(cpu.state_dict())
    card_model = card_model.to(dev, memory_format=torch.channels_last_3d).eval()
    explicit = S3D(fold_s2d=False)
    explicit.load_state_dict(cpu.state_dict())
    explicit = explicit.to(dev, memory_format=torch.channels_last_3d).eval()
    xc = x.to(dev)
    dtypes, hooks = {}, []  # every block and every BN
    for name, m in card_model.named_modules():
        if name and (name.count(".") == 0 or isinstance(m, BatchNorm)) and name != "fc":
            hooks.append(m.register_forward_hook(
                lambda m, i, o, name=name: dtypes.__setitem__(name, str(o.dtype))))
    with torch.no_grad():
        emb32 = card_model(xc, return_embedding=True)
        logits32 = card_model.fc(emb32)
        emb_explicit = explicit(xc, return_embedding=True)
        dtypes.clear()
        with torch.autocast("cuda", dtype=torch.bfloat16):
            emb16 = card_model(xc, return_embedding=True)
    for h in hooks:
        h.remove()
    torch.cuda.synchronize()
    errs = {"f32_card_vs_cpu": norm_err(emb32.cpu(), want),
            "f32_logits_card_vs_cpu": norm_err(logits32.cpu(), want_logits),
            "folded_vs_explicit_conv1": norm_err(emb32, emb_explicit),
            "bf16_vs_f32": norm_err(emb16, emb32)}
    not_bf16 = {n: d for n, d in dtypes.items() if d != "torch.bfloat16"}
    emit({"phase": "s3d", "card": card, "clip": [1, 3, E2E["T"], E2E["S"], E2E["S"]],
          "rel_norm_err": errs, "tol": {"f32": S3D_F32_REL, "bf16": S3D_BF16_REL},
          "emb_rms": rms(want), "blocks_checked_bf16": len(dtypes), "not_bf16": not_bf16,
          "macs_per_clip": macs, "cpu_forward_seconds": cpu_seconds})
    for what in ("f32_card_vs_cpu", "f32_logits_card_vs_cpu", "folded_vs_explicit_conv1"):
        check(errs[what] <= S3D_F32_REL, f"S3D {what} {errs[what]} > {S3D_F32_REL}")
    check(errs["bf16_vs_f32"] <= S3D_BF16_REL,
          f"S3D bf16 against f32 {errs['bf16_vs_f32']} > {S3D_BF16_REL}")
    check(len(dtypes) == len(hooks) and not not_bf16,
          f"S3D outputs not bf16 under autocast: {not_bf16} ({len(dtypes)} of {len(hooks)})")
    return macs


def e2e_setup(torch, device, compute, grads=None, feed=None, dtype=None, group=None, **flags):
    """S3DWithText (vocab 66,251, dim 512) of random weights from the seed on
    ``device`` (channels_last_3d on the card), in ``dtype`` (f32 unless
    given), its e2e optimizer (lr E2E_LR, wd E2E_WD, no warm-up: the first
    step moves the params) and train step; ``grads``, when given a list,
    gets each micro-step's gradients (name -> a CPU f64 copy) as backward
    left them; ``feed`` (such a list) then replaces them, step by step, with
    the given ones before the optimizer reads them; ``group``, a process
    group, makes the step the data-parallel one."""
    from temporalalignnet_torch.core.config import TrainConfig
    from temporalalignnet_torch.train.end2end import make_e2e_optimizer, make_e2e_train_step

    model = s3d_weights(torch, SEED + 22, text=True, **flags).to(dtype or torch.float32)
    layout = torch.channels_last_3d if device.type == "cuda" else torch.contiguous_format
    model = model.to(device, memory_format=layout)
    cfg = TrainConfig(lr=E2E_LR, wd=E2E_WD, warmup_iterations=0, total_iterations=100)
    opt = make_e2e_optimizer(model, cfg)
    if grads is not None:
        named, apply = dict(model.named_parameters()), opt.step

        def spy():
            grads.append({n: (p.grad.detach().double().cpu() if p.grad is not None
                              else torch.zeros(p.shape, dtype=torch.float64))
                          for n, p in named.items()})
            for n, p in named.items() if feed else ():
                p.grad = feed[len(grads) - 1][n].to(p.device, p.dtype)
            return apply()

        opt.step = spy
    return model, make_e2e_train_step(model, opt, compute_dtype=compute, group=group)


def e2e_batch(torch, seed, B, n, T, S, W=32):
    """{'clips' [B, n, T, S, S, 3] in [0, 1], 'input_ids' [B, n, W]} on the host."""
    rng = np.random.RandomState(seed)
    return {"clips": torch.from_numpy(rng.rand(B, n, T, S, S, 3).astype(np.float32)),
            "input_ids": torch.from_numpy(rng.randint(0, 66251, (B, n, W)).astype(np.int32))}


def snapshot(model, f64=False):
    return {k: (v.detach().double() if f64 else v.detach().float()).cpu().clone()
            for k, v in model.state_dict().items()}


def phase_e2e_step(torch):
    """The e2e train step at full width (32 clips of 16 x 224², bf16) with
    train_bn_stats (the running statistics move) and freeze_early (conv1 ...
    mixed_3c move by the decay alone) and the frozen-BN default, whose
    launches of the five port kernels are counted (none: S3D's convolutions
    and the InfoNCE are PyTorch's); then two f32 steps of 4 clips of 8 x 64²
    on the card against the CPU, from one state on the same batches: losses,
    grad_norms and every param within the CPU tests' bars, and the first
    step's gradients and its update, decay taken out, held apart (see
    E2E_GRAD_RTOL)."""
    dev = torch.device("cuda")
    batch = {k: v.to(dev) for k, v in e2e_batch(torch, SEED + 23, E2E["B"], E2E["n"],
                                                   E2E["T"], E2E["S"]).items()}
    out = {}
    for name, flags in (("frozen_bn", {}), ("train_bn_stats", {"train_bn_stats": True}),
                        ("freeze_early", {"freeze_early": True})):
        model, step = e2e_setup(torch, dev, torch.bfloat16, **flags)
        before = snapshot(model)
        metrics, launches, _ = counted_step(torch, step, batch)
        after = snapshot(model)
        loss = metrics["loss"].item()
        stats_moved = sum(not torch.equal(after[k], before[k]) for k in after if "running" in k)
        shrink = 1.0 - E2E_LR * E2E_WD
        early_err = max(norm_err(after[k], before[k] * shrink) for k in after
                        if k.split(".")[0] in ("conv1", "conv_2b", "mixed_3c")
                        and "running" not in k and not k.endswith("bias")
                        and ".bn" not in k)
        out[name] = {"loss": loss, "grad_norm": metrics["grad_norm"].item(),
                     "launches": launches, "stats_moved": stats_moved,
                     "early_err_vs_decay_only": early_err}
        check(np.isfinite(loss), f"e2e {name} step loss {loss}")
        check(sum(launches.values()) == 0, f"e2e {name} step launched port kernels {launches}")
        check((stats_moved > 0) == (name == "train_bn_stats"),
              f"e2e {name}: {stats_moved} BN statistics moved")
        if name == "freeze_early":
            check(early_err <= 1e-6, f"freeze_early: early params moved beyond the decay "
                                     f"({early_err})")
        del model, step
    del batch
    torch.cuda.empty_cache()
    emit({"phase": "e2e_step", "clips": [E2E["B"] * E2E["n"], E2E["T"], E2E["S"], E2E["S"]],
          **out})
    e2e_card_vs_cpu(torch)
    return out["frozen_bn"]["launches"]


def e2e_card_vs_cpu(torch, device="cuda"):
    """The e2e step on ``device`` against the CPU, from one state on the same
    two batches of 4 clips of 8 x 64²: two f32 steps (losses, grad_norms,
    then every param) and two f64 steps (each step's gradients leaf by leaf;
    then, the card's optimizer fed the CPU's gradients, its update with the
    decay taken out, with a sign-flipped update planted against it); the
    bars: see E2E_GRAD_RTOL."""
    from temporalalignnet_torch.core.config import TrainConfig
    from temporalalignnet_torch.train.optimizer import lr_at, no_decay

    small = [e2e_batch(torch, SEED + 24 + i, 2, 2, 8, 64) for i in range(2)]
    runs = {}
    for d in ("cpu", device):
        f32_grads = []
        model, step = e2e_setup(torch, torch.device(d), torch.float32, grads=f32_grads)
        metrics = [{k: v.item() for k, v in step(b).items() if k in ("loss", "grad_norm")}
                   for b in small]
        f32_params, grads = snapshot(model), []
        model, step = e2e_setup(torch, torch.device(d), torch.float32, grads=grads,
                                feed=runs["cpu"][3] if d != "cpu" else None,
                                dtype=torch.float64)
        params = [snapshot(model, f64=True)]
        for b in small:
            step({"clips": b["clips"].double(), "input_ids": b["input_ids"]})
            params.append(snapshot(model, f64=True))
        runs[d] = (metrics, f32_params, params, grads, f32_grads[0])
        del model, step
    (g_met, g_par, g_f64, g_grads, g_f32), (c_met, c_par, c_f64, c_grads, c_f32) = (
        runs[device], runs["cpu"])
    loss_err = max(abs(a["loss"] - b["loss"]) for a, b in zip(g_met, c_met))
    gnorm_err = max(abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
                    for a, b in zip(g_met, c_met))
    excess = {k: float(((g_par[k] - c_par[k]).abs() - E2E_PARAM_RTOL * c_par[k].abs()).max())
              for k in c_par}
    worst = sorted(excess.items(), key=lambda kv: -kv[1])[:3]
    f32_grad_err = sorted(((k, norm_err(g_f32[k], c_f32[k])) for k in c_f32
                           if c_f32[k].norm() > 0), key=lambda kv: -kv[1])[:6]
    # each f64 step: the card's gradients against the CPU's, leaf by leaf
    # (the error over its bar); then, both optimizers fed the CPU's, the
    # update with the decay taken out; a sign-flipped update is planted
    # against it
    cfg = TrainConfig(lr=E2E_LR, wd=E2E_WD, warmup_iterations=0, total_iterations=100)
    f64 = []
    for i, (g_grad, c_grad) in enumerate(zip(g_grads, c_grads)):
        whole = sum(g.pow(2).sum().item() for g in c_grad.values()) ** 0.5
        grad_excess = {k: ((g_grad[k] - c_grad[k]).norm().item()
                           / (E2E_GRAD_RTOL * c_grad[k].norm().item() + E2E_GRAD_ATOL * whole))
                       for k in c_grad}
        lr = lr_at(cfg, i)
        upd = {"step": i, "grad_norm": whole,
               "grad_err_over_bar": sorted(grad_excess.items(), key=lambda kv: -kv[1])[:3],
               "lr": lr, "max_err": 0.0, "planted_sign_flip_err": 0.0, "adam_moved": 0,
               "of": sum(g.numel() for g in c_grad.values()), "max_abs_u": 0.0}
        for k in c_grad:
            keep = 1 - lr * (0.0 if no_decay(k, "e2e") else E2E_WD)
            u_card = (g_f64[i + 1][k] - g_f64[i][k] * keep) / lr
            u_cpu = (c_f64[i + 1][k] - c_f64[i][k] * keep) / lr
            upd["max_err"] = max(upd["max_err"], (u_card - u_cpu).abs().max().item())
            upd["planted_sign_flip_err"] = max(upd["planted_sign_flip_err"],
                                               (u_card + u_cpu).abs().max().item())
            upd["adam_moved"] += int((u_cpu.abs() > 0.5).sum())
            upd["max_abs_u"] = max(upd["max_abs_u"], u_cpu.abs().max().item())
        f64.append(upd)
    res = {
        "f32_losses_card": [m["loss"] for m in g_met],
        "f32_losses_cpu": [m["loss"] for m in c_met],
        "f32_loss_max_abs_err": loss_err, "f32_grad_norm_max_rel_err": gnorm_err,
        "f32_worst_param_excess": worst, "f32_first_step_grad_rel_err": f32_grad_err,
        "f64_steps": f64,
        "tol": {"loss": E2E_LOSS_TOL, "params": [E2E_PARAM_ATOL, E2E_PARAM_RTOL],
                "grad_norm": E2E_GRAD_NORM_RTOL, "grad": [E2E_GRAD_RTOL, E2E_GRAD_ATOL],
                "update": E2E_UPDATE_ATOL}}
    emit({"phase": "e2e_step_card_vs_cpu", **res})
    check(loss_err <= E2E_LOSS_TOL, f"e2e f32 card vs cpu loss {loss_err}")
    check(gnorm_err <= E2E_GRAD_NORM_RTOL, f"e2e f32 card vs cpu grad_norm {gnorm_err}")
    check(worst[0][1] <= E2E_PARAM_ATOL, f"e2e f32 card vs cpu params {worst}")
    for upd in f64:
        check(upd["grad_err_over_bar"][0][1] <= 1.0, f"e2e f64 card vs cpu gradients {upd}")
        check(upd["adam_moved"] > 0,
              f"the f64 step's update is the decay alone: {upd}")
        check(upd["max_err"] <= E2E_UPDATE_ATOL, f"e2e f64 card vs cpu update {upd}")
        check(upd["planted_sign_flip_err"] > E2E_UPDATE_ATOL,
              f"a sign-flipped update would pass the update check: {upd}")
    return res


class SyntheticVideos:
    """Whole synthetic videos for the extractor (``data/clips.py::
    synthetic_decode`` of ``seconds`` x fps frames around the middle),
    decoded up to ``ahead`` videos in advance in threads, in the sorted
    order the extractor asks for them."""

    def __init__(self, durations, ahead=4):
        from concurrent.futures import ThreadPoolExecutor

        self.durations = durations  # path -> seconds
        self.order = sorted(durations)
        self.ahead = ahead
        self.pool = ThreadPoolExecutor(ahead)
        self.futures = {}

    def _decode(self, path, fps, size):
        from temporalalignnet_torch.data.clips import synthetic_decode

        secs = self.durations[path]
        return synthetic_decode(path, secs / 2.0, secs * fps, fps, size)

    def __call__(self, path, fps, size):
        i = self.order.index(path)
        for p in self.order[i:i + self.ahead]:
            if p not in self.futures:
                self.futures[p] = self.pool.submit(self._decode, p, fps, size)
        return self.futures.pop(path).result()

    def close(self):
        self.pool.shutdown(cancel_futures=True)


def timed_encoder(torch, encode, seconds):
    """``encode`` with its wall time (the card synchronised) added to seconds[0]
    and its clips to seconds[1]."""
    def run(clips):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = encode(clips)  # a host array: the card is done
        seconds[0] += time.perf_counter() - t0
        seconds[1] += len(clips)
        return out
    return run


def phase_htm_aa_pipeline(torch, card):
    """The product path on the card, in order: (1) tools/extract_features.py
    writes 1 fps S3D features (bf16, 16 frames of 224² a feature) of
    HTM_AA["videos"] synthetic videos from an s3d_howto100m.pth-format file
    of random weights; (2) tools/generate_htm_aa.py on them with a random
    E6D6 TAN: bf16 (its mha_fwd launches counted: 12 per video, short
    route), and f32 on the card against the CPU (the same rows, scores
    within HTM_AA_SCORE_TOL); (3) the csv feeds the e2e CLI at its default
    widths (--decoder synthetic, 6 steps, runtime and epoch checkpoints,
    params_latest.pth), and a second 2-step run starts from that file with
    --pretrain; (4) linear_probe on the card equals the CPU's on the
    extracted features.  The first e2e run goes beside the f32 rows of (2),
    the second beside (4)."""
    from temporalalignnet_torch.eval.linear_probe import linear_probe
    from temporalalignnet_torch.tools import extract_features, generate_htm_aa

    root = os.path.join(REPO, "build", "chip_smoke_htm_aa")
    shutil.rmtree(root, ignore_errors=True)  # a run before this one left its files
    dirs = {k: os.path.join(root, k) for k in ("videos", "features", "e2e", "e2e_again")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    rng = np.random.RandomState(SEED + 30)
    vocab = os.path.join(root, "vocab.npy")
    np.save(vocab, np.array([f"w{i}" for i in range(66250)]))
    s3d_path = os.path.join(root, "s3d_howto100m.pth")
    torch.save({f"module.{k}": v for k, v in s3d_weights(torch, SEED + 31, text=True)
                .state_dict().items()}, s3d_path)
    V, secs = HTM_AA["videos"], HTM_AA["seconds"]
    videos = {f"vid{i:02d}": os.path.join(dirs["videos"], f"vid{i:02d}.mp4") for i in range(V)}
    for path in videos.values():
        open(path, "w").close()  # the synthetic decoder reads only the name
    out = {}

    # (1) features
    decoder = SyntheticVideos({p: secs for p in videos.values()})
    encode_s = [0.0, 0]
    encode = timed_encoder(torch, extract_features.make_s3d_encoder(
        s3d_path, device="cuda", dtype=torch.bfloat16), encode_s)
    t0 = time.perf_counter()
    try:
        written = extract_features.FeatureExtractor(
            encode, size=HTM_AA["size"], batch_size=HTM_AA["batch"], decoder=decoder).run(
                videos, dirs["features"])
    finally:
        decoder.close()
    feats = {v: np.load(os.path.join(dirs["features"], f"{v}.npy")) for v in videos}
    out["extract"] = {"videos": len(written), "features": encode_s[1],
                      "run_seconds": time.perf_counter() - t0, "encode_seconds": encode_s[0],
                      "clips_per_s": encode_s[1] / encode_s[0],
                      "feature_rms": float(np.sqrt(np.mean(np.concatenate(
                          list(feats.values())).astype(np.float32) ** 2)))}
    check(len(written) == V and all(f.shape == (secs, 1024) and np.isfinite(f).all()
                                    for f in feats.values()),
          f"extract_features wrote {len(written)} of {V}: "
          f"{[f.shape for f in feats.values()]}")

    # (2) HTM-AA from a random E6D6 TAN
    captions = {}
    for vid in videos:
        starts = np.sort(rng.uniform(0, secs - 4, HTM_AA["sentences"]))
        captions[vid] = {"text": [" ".join(f"w{w}" for w in rng.randint(0, 66250, 6))
                                  for _ in starts],
                         "start": starts.tolist(), "end": (starts + 3.0).tolist()}
    cap_path = os.path.join(root, "captions.json")
    with open(cap_path, "w") as f:
        json.dump(captions, f)
    ckpt = os.path.join(root, "tan.pth.tar")
    torch.save({"epoch": 0, "state_dict": make_model(torch, torch.device("cpu"), torch.float32)
                .state_dict(), "iteration": 0}, ckpt)
    args = ["--ckpt", ckpt, "--features", dirs["features"], "--captions", cap_path,
            "--vocab", vocab]
    csv_path = os.path.join(root, "htm_aa.csv")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    rows = generate_htm_aa.main(args + ["--out", csv_path])
    torch.cuda.synchronize()
    gen_seconds = time.perf_counter() - t0
    launches, routes = read_counts(), read_routes()
    cli = [sys.executable, "-m", "temporalalignnet_torch.train.end2end_cli",
           "--htm_aa_csv", csv_path, "--video_root", dirs["videos"], "--vocab", vocab,
           "--decoder", "synthetic"]
    t_cli = time.perf_counter()
    first_proc = start(cli + ["--pretrain", s3d_path, "--max_steps", "6", "--epochs", "6",
                              "--runtime_save_iter", "3", "--log_every", "1",
                              "--prefix", dirs["e2e"]])
    f32 = {d: generate_htm_aa.main(args + ["--out", os.path.join(root, f"htm_aa_{d}.csv"),
                                           "--device", d, "--f32"])
           for d in ("cuda", "cpu")}
    key = lambda r: (r["vid"], r["text"], r["timestamp"])
    score_err = max([abs(a["score"] - b["score"]) for a, b in zip(f32["cuda"], f32["cpu"])]
                    or [0.0])
    out["generate"] = {"pairs": len(rows), "sentences": V * HTM_AA["sentences"],
                       "seconds_bf16": gen_seconds, "launches": launches,
                       "mha_fwd_routes": routes["mha_fwd"],
                       "f32_rows_equal": [key(r) for r in f32["cuda"]] == [key(r) for r in
                                                                           f32["cpu"]],
                       "f32_pairs": len(f32["cpu"]), "f32_score_max_abs_err": score_err,
                       "bf16_rows_equal_f32": [key(r) for r in rows] == [key(r) for r in
                                                                         f32["cpu"]]}
    check(len(rows) > 0, "generate_htm_aa wrote no pair")
    check(launches["mha_fwd"] == 12 * V and routes["mha_fwd"]["short"] == 12 * V
          and sum(launches.values()) == launches["mha_fwd"],
          f"generate_htm_aa launches {launches}, routes {routes['mha_fwd']}")
    check(out["generate"]["f32_rows_equal"] and score_err <= HTM_AA_SCORE_TOL,
          f"generate_htm_aa f32 card vs cpu: {out['generate']}")

    # (3) the e2e CLI on that csv (started above), then again from its export
    first = finish(first_proc, "e2e CLI", timeout=900)
    first_seconds = time.perf_counter() - t_cli
    exp = os.path.join(dirs["e2e"], os.listdir(dirs["e2e"])[0])  # e2e_bs16_lr1e-05_f16
    final = json.loads(first.strip().splitlines()[-1])
    export = os.path.join(exp, "params_latest.pth")
    again_proc = start(cli + ["--pretrain", export, "--max_steps", "2", "--epochs", "2",
                              "--prefix", dirs["e2e_again"]])

    # (4) the probe: each video a class, its first 24 s to train, the rest to test
    X = np.stack([feats[v].astype(np.float32) for v in sorted(feats)])  # [V, secs, 1024]
    y = np.repeat(np.arange(V), secs).reshape(V, secs)
    split = (X[:, :24].reshape(-1, 1024), y[:, :24].reshape(-1),
             X[:, 24:].reshape(-1, 1024), y[:, 24:].reshape(-1))
    probe = {d: linear_probe(*split, num_classes=V, device=d) for d in ("cuda", "cpu")}
    out["probe"] = probe

    again = finish(again_proc, "e2e CLI --pretrain", 900)
    final_again = json.loads(again.strip().splitlines()[-1])
    listing = {d: sorted(os.listdir(os.path.join(exp, d))) for d in ("runtime", "epoch")}
    out["e2e_cli"] = {"final": final, "seconds": first_seconds, "checkpoints": listing,
                      "losses": [l for l in first.splitlines() if l.startswith("Epoch")],
                      "again_final": final_again,
                      "again_pretrain_lines": [l for l in again.splitlines()
                                               if l.startswith("[pretrain]")]}
    check(final["final_step"] == 6 and np.isfinite(final["loss"]), f"e2e CLI {final}")
    check(listing["runtime"] == ["step_000000006.pth.tar"] and len(listing["epoch"]) == 5
          and os.path.exists(export), f"e2e CLI checkpoints {listing}")
    check(final_again["final_step"] == 2 and np.isfinite(final_again["loss"])
          and not out["e2e_cli"]["again_pretrain_lines"],
          f"e2e CLI from its params_latest.pth: {final_again}")
    emit({"phase": "htm_aa_pipeline", "card": card, "videos": V, "seconds_per_video": secs,
          **out})
    check((probe["cuda"]["top1"], probe["cuda"]["top5"]) == (probe["cpu"]["top1"],
                                                             probe["cpu"]["top5"]),
          f"linear_probe card vs cpu {probe}")
    return launches, routes["mha_fwd"]


# ------------------------------------------------------------------ slice 7


def bert_vocab():
    """A synthetic 30,522-token WordPiece vocab in bert-base-uncased's layout
    ([PAD] 0, [unused*], [UNK] 100, [CLS] 101, [SEP] 102, [MASK] 103): 'w'
    and the pieces '##0' ... '##9' first, so that every caption word 'w<n>'
    of the synthetic corpora splits, then whole words 'w0', 'w1', ... up to
    the size."""
    vocab = ["[PAD]"] + [f"[unused{i}]" for i in range(99)] + ["[UNK]", "[CLS]", "[SEP]",
                                                                "[MASK]", "w", ",", ".", "!"]
    vocab += [f"##{d}" for d in range(10)]
    return vocab + [f"w{i}" for i in range(BERT_CFG["vocab_size"] - len(vocab))]


def make_bert_dir(torch, root):
    """An HF BERT directory at BERT_CFG's widths: config.json, the synthetic
    vocab.txt, tokenizer_config.json and random pytorch_model.bin weights
    from the seed in BertForPreTraining's key space (``bert.*`` and two
    ``cls.*`` head tensors)."""
    from temporalalignnet_torch.models.bert import BertConfig, BertEncoder, write_bert_dir

    cfg = BertConfig(**BERT_CFG)
    encoder = BertEncoder(cfg).init_weights(torch.Generator().manual_seed(SEED + 20))
    weights = {f"bert.{k}": v for k, v in encoder.state_dict().items()}
    weights["cls.predictions.bias"] = torch.zeros(cfg.vocab_size)
    weights["cls.seq_relationship.weight"] = torch.zeros(2, cfg.hidden_size)
    shutil.rmtree(root, ignore_errors=True)
    path = os.path.join(root, "bert-base-uncased")
    write_bert_dir(path, cfg, bert_vocab(), weights)
    emit({"phase": "bert_dir", "path": os.path.relpath(path, REPO), "config": BERT_CFG,
          "params": sum(v.numel() for v in encoder.state_dict().values()),
          "weight_file_bytes": os.path.getsize(os.path.join(path, "pytorch_model.bin"))})
    return path


def bert_tan(torch, device, bert_dir):
    """The E6D6 BERT TAN (head on) from the seed, BERT from ``bert_dir``'s
    weights, f32, in eval mode."""
    from temporalalignnet_torch.checkpoint import merge_into
    from temporalalignnet_torch.core.config import ModelConfig
    from temporalalignnet_torch.models.net import TANWithText

    model = TANWithText(ModelConfig(language_model="bert", use_alignability_head=True,
                                    random_pos_start=False), bert_config=bert_dir.config)
    model.init_weights(torch.Generator().manual_seed(SEED))
    merge_into(model.bert, bert_dir.weights, "bert")
    return model.to(device).eval()


def phase_bert(torch, files, bert_path):
    """Slice 7's main path, the BERT TAN at bert-base-uncased's widths: its
    f32 forward on the card against the CPU (B = 2, N = 4); then BERT_STEPS
    Stage-1 steps through the data pipeline (the synthetic captions through
    the WordPiece tokenizer) and BERT_STEPS cotrain steps from their state,
    at B = 64, N = 16, W = 32, E6D6, bf16, fused, BERT from the directory's
    weights: finite losses, and each step's launches and routes."""
    from temporalalignnet_torch.checkpoint import merge_into
    from temporalalignnet_torch.core.config import DataConfig
    from temporalalignnet_torch.data import HTMFeatureDataset, TrainLoader
    from temporalalignnet_torch.data.synthetic import synthetic_batch
    from temporalalignnet_torch.models.bert import load_bert_dir

    dev = torch.device("cuda")
    bert_dir = load_bert_dir(bert_path)
    check(bert_dir.weights is not None and len(bert_dir.report) == 2,
          f"BERT directory read: {bert_dir.report}")
    B, T, N, W = (TRAIN[k] for k in "BTNW")

    # f32, full width, the card's f32 kernels against the CPU
    b = {k: torch.from_numpy(v) for k, v in synthetic_batch(
        np.random.RandomState(SEED + 21), batch_size=2, seq_len=T, max_sentences=4,
        feature_dim=1024, vocab_size=BERT_CFG["vocab_size"] - 1, max_words=W).items()}
    outs, launches = {}, None
    for d in ("cuda", "cpu"):
        model = bert_tan(torch, torch.device(d), bert_dir)
        x = {k: v.to(torch.device(d)) for k, v in b.items()}
        torch.cuda.synchronize()
        reset_counts()
        with torch.no_grad():
            outs[d] = model(x["video"], x["input_ids"].long(), x["video_padding_mask"],
                            x["text_padding_mask"], deterministic=True)
        torch.cuda.synchronize()
        launches = launches or read_routes()["mha_fwd"]
        del model
    errs = {k: norm_err(outs["cuda"][k].cpu(), outs["cpu"][k]) for k in outs["cpu"]}
    emit({"phase": "bert_f32_card_vs_cpu", "model": "E6D6 width 512, BERT 12 x 768, f32",
          "batch": dict(B=2, N=4, W=W), "rel_norm_err": errs, "tol": TOWER_F32_REL,
          "mha_fwd_routes": launches})
    check(max(errs.values()) <= TOWER_F32_REL, f"BERT TAN f32 card vs cpu {errs}")
    expected = {"short": 0, "long": 0, "f32": 12 + BERT_CFG["num_hidden_layers"]}
    check(launches == expected, f"BERT TAN f32 forward launches {launches}, expected {expected}")

    ds = HTMFeatureDataset(files[0], files[1], DataConfig(seq_len=T, max_sentences=N,
                                                          max_words=W), "train", bert_dir.tokenizer)
    loader = TrainLoader(ds, B, seed=SEED, num_workers=8, pin_memory=True)
    totals, state = {}, None
    for name, cotrain, per_step, by_route in (
            ("init", False, BERT_STEP_LAUNCHES, BERT_STEP_ROUTES),
            ("cotrain", True, BERT_COTRAIN_LAUNCHES, BERT_COTRAIN_ROUTES)):
        model, _, step, _ = train_setup(torch, dev, fused=True, state=state, cotrain=cotrain,
                                        bert=True)
        if state is None:
            merge_into(model.bert, bert_dir.weights, "bert")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _, metrics, counts, routes, secs = run_steps(torch, loader, step, BERT_STEPS)
        losses = [m["loss"] for m in metrics]
        emit({"phase": f"bert_{name}", "model": "E6D6 width 512, BERT 12 x 768, fused, bf16",
              "batch": TRAIN, "steps": len(metrics), "losses": losses,
              "confidence_ratio": [m.get("confidence-ratio") for m in metrics],
              "launches_per_step": counts[0], "routes_per_step": routes[0],
              "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "seconds_with_data": secs})
        check(all(np.isfinite(losses)), f"BERT {name}: non-finite loss {losses}")
        check(all(0.0 <= m.get("confidence-ratio", 0.0) <= 1.0 for m in metrics),
              f"BERT {name}: confidence ratio out of [0, 1]")
        totals[name] = check_launches(counts, routes, per_step, by_route, f"BERT {name}")
        state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        del model, step
    return totals


def phase_bert_cli(files, bert_path, eval_files, yc2_files, say=emit):
    """The user's entry points with --language_model bert on the card: the
    train CLI (3 steps at B = 16) from the directory's weights, --model
    cotrain --pretrain on its checkpoint (3 steps), then at once the eval
    CLI's two tasks on the twin checkpoint; ``say`` takes each line."""
    feats, captions, _ = files
    prefix = os.path.join(REPO, "build", "chip_smoke_bert", "exp")
    train = [sys.executable, "-m", "temporalalignnet_torch.train", "--feature_dir", feats,
             "--captions", captions, "--language_model", "bert", "--bert_dir", bert_path,
             "--batch_size", "16", "--max_steps", "3", "--epochs", "1", "--log_every", "1",
             "--runtime_save_iter", "0", "--prefix", prefix]
    ckpt = None
    for name, extra in (("bert_train_cli", ["--use_alignability_head", "1"]),
                        ("bert_cotrain_cli", ["--model", "cotrain", "--pretrain", "{ckpt}"])):
        t0 = time.perf_counter()
        out = finish(start(train + [a.format(ckpt=ckpt) for a in extra]), name, timeout=900)
        lines = [json.loads(l) for l in out.splitlines() if l.startswith("{")]
        report = [l for l in out.splitlines() if l.startswith(("[bert]", "[pretrain]"))]
        final = lines[-1]
        say({"phase": name, "log": lines[:-1], "final": final, "report": report,
             "seconds": time.perf_counter() - t0})
        check(final["final_step"] == 3 and final["loss_finite"], f"{name} final line {final}")
        check(not [l for l in report if l.startswith("[bert] missing")],
              f"{name}: BERT keys missing from the weight file: {report}")
        ckpt = final["checkpoint"]

    e_feats, anno, _ = eval_files
    y_feats, y_anno, _ = yc2_files
    ev = [sys.executable, "-m", "temporalalignnet_torch.eval", "--ckpt", ckpt,
          "--language_model", "bert", "--bert_dir", bert_path]
    t0 = time.perf_counter()
    procs = {"align": start(ev + ["--task", "align", "--features", e_feats, "--anno", anno]),
             "retrieval": start(ev + ["--task", "retrieval", "--features", y_feats,
                                      "--anno", y_anno])}
    try:
        outs = {task: json.loads(finish(proc, f"BERT eval CLI {task}", timeout=600)
                                 .strip().splitlines()[-1]) for task, proc in procs.items()}
    finally:
        stop(procs.values())
    say({"phase": "bert_eval_cli", "metrics": outs,
         "seconds_both_tasks": time.perf_counter() - t0})
    check(0.0 <= outs["align"]["Recall"] <= 1.0 and 0.0 <= outs["align"]["AUC"] <= 1.0,
          f"BERT eval CLI align: {outs['align']}")
    check(len(outs["retrieval"]) == 12 and all(np.isfinite(v) for v in outs["retrieval"].values()),
          f"BERT eval CLI retrieval: {outs['retrieval']}")


def start_bert_cli(files, bert_path, eval_files, yc2_files):
    """phase_bert_cli in the background (its CLIs time nothing), its lines
    kept; joined by finish_bert_cli."""
    lines = []
    return in_background(phase_bert_cli, files, bert_path, eval_files, yc2_files,
                         lines.append), lines


def finish_bert_cli(started):
    """The BERT CLIs' lines, once their thread has ended; its failure raised."""
    background, lines = started
    try:
        joined(background, "the BERT CLIs")
    finally:
        for line in lines:
            emit(line)


def hf_shapes(tower):
    """{key: shape} of an HF state_dict of ``tower`` at its published widths:
    'clip_text' (CLIPTextModelWithProjection), 'clip_vision'
    (CLIPVisionModelWithProjection) or 'timesformer' (TimesformerModel)."""
    shapes = {}

    def add(prefix, **named):
        shapes.update({f"{prefix}{k}": v for k, v in named.items()})

    def ln(prefix, w):
        add(prefix, weight=(w,), bias=(w,))

    def linear(prefix, d_out, d_in):
        add(prefix, weight=(d_out, d_in), bias=(d_out,))

    if tower.startswith("clip"):
        c = CLIP_TEXT if tower == "clip_text" else CLIP_VISION
        pre, w = f"{tower[5:]}_model.", c["width"]
        for i in range(c["layers"]):
            p = f"{pre}encoder.layers.{i}."
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                linear(f"{p}self_attn.{proj}.", w, w)
            ln(f"{p}layer_norm1.", w)
            ln(f"{p}layer_norm2.", w)
            linear(f"{p}mlp.fc1.", 4 * w, w)
            linear(f"{p}mlp.fc2.", w, 4 * w)
        if tower == "clip_text":
            add(pre + "embeddings.", **{"token_embedding.weight": (c["vocab_size"], w),
                                        "position_embedding.weight": (c["context_length"], w)})
            ln(pre + "final_layer_norm.", w)
            shapes["text_projection.weight"] = (c["embed_dim"], w)
        else:
            p = c["patch_size"]
            add(pre + "embeddings.", **{"patch_embedding.weight": (w, 3, p, p),
                                        "class_embedding": (w,), "position_embedding.weight":
                                        ((c["image_size"] // p) ** 2 + 1, w)})
            ln(pre + "pre_layrnorm.", w)
            ln(pre + "post_layernorm.", w)
            shapes["visual_projection.weight"] = (c["embed_dim"], w)
        return shapes
    c = TIMESFORMER
    w, p, m = c["width"], c["patch_size"], c["mlp_width"]
    linear("embeddings.patch_embeddings.projection.", w, 1)
    shapes["embeddings.patch_embeddings.projection.weight"] = (w, 3, p, p)
    add("embeddings.", cls_token=(1, 1, w), time_embeddings=(1, c["frames"], w),
        position_embeddings=(1, (c["image_size"] // p) ** 2 + 1, w))
    ln("layernorm.", w)
    for i in range(c["layers"]):
        q = f"encoder.layer.{i}."
        for name in ("temporal_layernorm", "layernorm_before", "layernorm_after"):
            ln(f"{q}{name}.", w)
        for att in ("temporal_attention", "attention"):
            linear(f"{q}{att}.attention.qkv.", 3 * w, w)
            linear(f"{q}{att}.output.dense.", w, w)
        linear(f"{q}temporal_dense.", w, w)
        linear(f"{q}intermediate.dense.", m, w)
        linear(f"{q}output.dense.", w, m)
    return shapes


def random_hf_state(torch, tower, seed):
    """Random tensors of ``hf_shapes(tower)`` from ``seed``: LayerNorm weights
    1 + N(0, 0.02²), embedding tables, biases and tokens N(0, 0.02²), the
    other weights N(0, 1/fan_in), so that 12 residual layers keep their
    activations in range."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for key, shape in hf_shapes(tower).items():
        x = torch.randn(shape, generator=gen)
        if "norm" in key and key.endswith("weight"):
            out[key] = 1.0 + 0.02 * x
        elif key.endswith("weight") and x.dim() >= 2 and not (
                x.dim() == 2 and key.endswith(("embedding.weight", "embeddings.weight"))):
            out[key] = x * float(np.prod(shape[1:])) ** -0.5
        else:
            out[key] = 0.02 * x
    return out


def write_clip_bpe(root):
    """HF-style vocab.json and merges.txt of the CLIP byte-BPE: every byte and
    byte</w>, a few merges of the caption words' characters, then
    <|startoftext|> and <|endoftext|> (the highest id, as in CLIP's)."""
    from temporalalignnet_torch.models.clip_text import EOT, SOT, bytes_to_unicode

    chars = list(bytes_to_unicode().values())
    merges = [("w", "1"), ("w", "2"), ("w", "3"), ("1", "2"), ("2", "3")] + [
        (str(d), f"{e}</w>") for d in range(10) for e in range(10)]
    vocab = chars + [c + "</w>" for c in chars] + ["".join(m) for m in merges] + [SOT, EOT]
    vocab_path, merges_path = os.path.join(root, "vocab.json"), os.path.join(root, "merges.txt")
    with open(vocab_path, "w") as f:
        json.dump({t: i for i, t in enumerate(vocab)}, f)
    with open(merges_path, "w") as f:
        f.write("#version: 0.2\n" + "\n".join(" ".join(m) for m in merges) + "\n")
    return vocab_path, merges_path


def phase_clip_baseline(torch):
    """The eval CLI's CLIP baseline (no --ckpt, --clip_text_ckpt of a random
    HF-key-space ViT-B/32 text checkpoint, the byte-BPE files, cos) on a
    synthetic HTM-Align corpus of 512-d features, in f32 on the card and on
    the CPU (the same metrics, within one sentence's Recall and AUC_TOL) and
    in bf16 on the card.  The text tower's causal attention is plain on both
    devices: no kernel launches, ``causal_calls`` counts it."""
    import contextlib
    import io

    from temporalalignnet_torch.eval.cli import main as eval_main
    from temporalalignnet_torch.ops.attention import multihead_attention

    root = os.path.join(REPO, "build", "chip_smoke_clip")
    shutil.rmtree(root, ignore_errors=True)
    feats = os.path.join(root, "features")
    os.makedirs(feats)
    ckpt = os.path.join(root, "clip_text.pth")
    torch.save(random_hf_state(torch, "clip_text", SEED + 30), ckpt)
    vocab, merges = write_clip_bpe(root)
    anno, n_aligned = {}, 0
    for i, item in enumerate(make_corpus(3, 100, 300, SEED + 31, dim=CLIP_TEXT["embed_dim"])):
        np.save(os.path.join(feats, f"vid{i}.npy"), item["video"])
        anno[f"vid{i}"] = [[s["aligned"], s["start"], s["end"],
                            " ".join(f"w{t - 1}" for t in s["input_ids"] if t)]
                           for s in item["sentences"]]
        n_aligned += sum(s["aligned"] for s in item["sentences"])
    anno_path = os.path.join(root, "htm_align.json")
    with open(anno_path, "w") as f:
        json.dump(anno, f)
    args = ["--task", "align", "--features", feats, "--anno", anno_path, "--clip_text_ckpt", ckpt,
            "--clip_vocab", vocab, "--clip_merges", merges, "--clip_context",
            str(CLIP_TEXT["context_length"]), "--clip_text_heads", str(CLIP_TEXT["heads"]),
            "--clip_hidden_act", "quick_gelu", "--baseline_sim", "cos",
            "--video_embed_dim", str(CLIP_TEXT["embed_dim"])]
    out = {}
    for mode, extra in {"card_f32": ["--f32"], "cpu": ["--device", "cpu"], "card_bf16": []}.items():
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        reset_counts()
        causal = multihead_attention.causal_calls
        with contextlib.redirect_stdout(io.StringIO()):
            metrics = eval_main(args + extra)
        out[mode] = {"metrics": metrics, "seconds": time.perf_counter() - t0,
                     "launches": sum(read_counts().values()),
                     "causal_attention_calls": multihead_attention.causal_calls - causal}
    emit({"phase": "clip_baseline", "task": "align", "sim": "cos", "tower": CLIP_TEXT, **out})
    card, cpu = out["card_f32"]["metrics"], out["cpu"]["metrics"]
    check(abs(card["Recall"] - cpu["Recall"]) * n_aligned <= 1 + 1e-9
          and abs(card["AUC"] - cpu["AUC"]) <= AUC_TOL, f"CLIP baseline card {card} vs cpu {cpu}")
    check(all(np.isfinite(v) for o in out.values() for v in o["metrics"].values()),
          "CLIP baseline: non-finite metrics")
    check(all(o["launches"] == 0 and o["causal_attention_calls"] > 0 for o in out.values()),
          f"CLIP baseline launches {out}")


def phase_tower_extract(torch):
    """tools/extract_features.py's CLIP (ViT-B/32, CLIP_FRAMES frames a call)
    and TimeSformer (base, TIMESFORMER_CLIPS clips of 8 x 224² a call)
    encoders on the card from random HF-key-space weights through the key
    maps: bf16 (the path: its launches and routes counted, clips/s over
    three calls), bf16 against f32 on the card, and f32 on the card
    against the CPU on the first one or two clips.  Returns the launches of
    one bf16 call of each."""
    from temporalalignnet_torch.checkpoint import clip_vision_state_dict, timesformer_state_dict
    from temporalalignnet_torch.tools.extract_features import (make_clip_encoder,
                                                               make_timesformer_encoder)

    towers = {
        "clip": (clip_vision_state_dict, make_clip_encoder, CLIP_VISION, "clip_vision",
                 (CLIP_FRAMES, 1), 2, {"short": 12, "long": 0, "f32": 0}),
        "timesformer": (timesformer_state_dict, make_timesformer_encoder, TIMESFORMER,
                        "timesformer", (TIMESFORMER_CLIPS, TIMESFORMER["frames"]), 1,
                        {"short": 12, "long": 12, "f32": 0}),
    }
    launches = {}
    for i, (name, (convert, make, kw, tower, lead, n_cpu, routes)) in enumerate(towers.items()):
        report = []
        weights = convert(random_hf_state(torch, tower, SEED + 40 + i), report)
        check(report == [], f"{name} key map: {report}")
        size = kw["image_size"]
        frames = np.random.RandomState(SEED + 42 + i).randint(
            0, 256, lead + (size, size, 3)).astype(np.uint8)
        bf16 = make(weights, dtype=torch.bfloat16, **kw)
        bf16(frames)  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        feats = bf16(frames)
        torch.cuda.synchronize()
        launches[name], taken = read_counts(), read_routes()["mha_fwd"]
        t0 = time.perf_counter()
        for _ in range(3):
            bf16(frames)  # returns a host array: the card is done
        secs = (time.perf_counter() - t0) / 3
        f32 = make(weights, **kw)
        ref = f32(frames)
        cpu = make(weights, device="cpu", **kw)(frames[:n_cpu])
        rel = {"bf16_vs_f32": norm_err(torch.from_numpy(feats), torch.from_numpy(ref)),
               "f32_card_vs_cpu": norm_err(torch.from_numpy(ref[:n_cpu]), torch.from_numpy(cpu))}
        emit({"phase": "tower_extract", "tower": name, "config": kw, "batch": list(lead),
              "features": list(feats.shape), "clips_per_s": lead[0] / secs,
              "seconds_per_call": secs, "mha_fwd_launches_per_call": launches[name]["mha_fwd"],
              "mha_fwd_routes_per_call": taken, "rel_norm_err": rel,
              "tol": {"bf16_vs_f32": TOWER_BF16_REL, "f32_card_vs_cpu": TOWER_F32_REL}})
        check(taken == routes, f"{name} encoder mha_fwd routes {taken}, expected {routes}")
        check(bool(np.isfinite(feats).all()), f"{name}: non-finite features")
        check(rel["bf16_vs_f32"] <= TOWER_BF16_REL and rel["f32_card_vs_cpu"] <= TOWER_F32_REL,
              f"{name} features: {rel}")
        del bf16, f32
    return launches


def serving_call(torch, program, params, video, ids):
    """One call of a serving program, with the launch counts set to 0 just
    before it and read just after: (output, every kernel's launches, the
    mha_fwd routes)."""
    torch.cuda.synchronize()
    reset_counts()
    with torch.no_grad():
        out = program(params, video, ids)
    torch.cuda.synchronize()
    return out, read_counts(), read_routes()["mha_fwd"]


def start_export_cli():
    """The export CLI (--poly_batch, bf16 on the card) in a child, started
    beside cotrain_cli and read by phase_serving_export: (process, its
    artifact's path)."""
    root = os.path.join(REPO, "build", "chip_smoke_export")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    out = os.path.join(root, "tan_eval_poly.pt2")
    return start([sys.executable, "-m", "temporalalignnet_torch.tools.export_eval",
                  "--out", out, "--poly_batch"]), out


def phase_serving_export(torch, card, stage1_ckpt, export_cli):
    """Slice 8's serving path: tools/export_eval.py on the E6D6 TAN (random
    weights from the seed) at the bench.py workload, bf16 (fixed and
    --poly_batch) and f32 (fixed): the artifact saved, loaded and called,
    its graph holding SERVE_NODES temporalalignnet::mha_fwd nodes, each call
    of the loaded program launching the kernel as often on the bf16 "short"
    (or "f32") route and no other kernel, its outputs equal to the live
    model's to the bit (at B = 192, and at 7 from the poly artifact; the
    loaded program's time comes with the eval forward's).  Then the export
    CLI's line (``start_export_cli``), and tools/export_torch.py on
    train_cli's experiment directory, whose file loads strict into a fresh
    TAN with a forward equal to the trained checkpoint's."""
    from temporalalignnet_torch.checkpoint import load_reference_checkpoint
    from temporalalignnet_torch.core.config import ModelConfig
    from temporalalignnet_torch.models.net import TANWithText
    from temporalalignnet_torch.ops.mha_fwd import route
    from temporalalignnet_torch.tools import export_eval as ee
    from temporalalignnet_torch.tools import export_torch

    dev = torch.device("cuda")
    B, T, C, N, W = (BENCH[k] for k in "BTCNW")
    child, cli_out = export_cli
    try:
        for dtype, kinds in ((torch.bfloat16, ("fixed", "poly")), (torch.float32, ("fixed",))):
            model = make_model(torch, dev, dtype)
            params = ee.eval_params(model)
            which = route(dtype, T)
            for kind in kinds:
                t0 = time.perf_counter()
                exported = ee.export_eval_forward(model, params, B, T, C, N, W,
                                                  poly_batch=kind == "poly")
                export_s = time.perf_counter() - t0
                blob = ee.serialize(exported)
                t0 = time.perf_counter()
                loaded = ee.deserialize(blob)
                load_s = time.perf_counter() - t0
                program = loaded.module()
                row = {"phase": "serving_export", "dtype": str(dtype).replace("torch.", ""),
                       "kind": kind, "bytes": len(blob), "mha_fwd_nodes": ee.mha_fwd_nodes(loaded),
                       "export_seconds": export_s, "load_seconds": load_s, "served": {}}
                for b in SERVE_BATCHES if kind == "poly" else (B,):
                    diffs = ee.roundtrip_check(blob, model, params, b, T, C, N, W,
                                               atol=float("inf"))
                    video, ids = ee.seeded_inputs(b, T, C, N, W, dev)
                    _, counts, routes = serving_call(torch, program, params, video, ids)
                    row["served"][b] = {"launches": counts["mha_fwd"], "routes": routes,
                                        "other_kernels": sum(counts.values()) - counts["mha_fwd"],
                                        **diffs}
                    if (dtype, kind, b) == (torch.bfloat16, "fixed", B):
                        launches = counts
                emit(row)
                check(row["mha_fwd_nodes"] == SERVE_NODES,
                      f"{kind} {dtype} artifact holds {row['mha_fwd_nodes']} mha_fwd nodes")
                for b, got in row["served"].items():
                    check(got["launches"] == SERVE_NODES and got["routes"][which] == SERVE_NODES
                          and got["other_kernels"] == 0,
                          f"{kind} {dtype} program at B = {b}: {got}")
                    check(all(v == 0.0 for k, v in got.items() if k.startswith("max_abs")),
                          f"{kind} {dtype} round trip at B = {b} not bit-equal: {got}")
        cli = json.loads(finish(child, "export_eval CLI", timeout=600).strip().splitlines()[-1])
    finally:
        stop([child])
    emit({"phase": "serving_export_cli", **cli})
    check(cli["mha_fwd_nodes"] == SERVE_NODES and cli["poly_batch"] and cli["device"] == card
          and os.path.getsize(cli_out) == cli["bytes"]
          and all(cli[k] == 0.0 for k in cli if k.startswith("max_abs_diff/")),
          f"export CLI line {cli}")

    # export_torch on the trained checkpoint's experiment directory
    out = os.path.join(os.path.dirname(cli_out), "stage1_export.pth.tar")
    export_torch.main(["--params", os.path.dirname(stage1_ckpt), "--out", out, "--epoch", "3",
                       "--iteration", "4"])
    ckpt = torch.load(out, map_location="cpu", weights_only=True)
    fwd = {}
    for name, path in (("exported", out), ("trained", stage1_ckpt)):
        m = TANWithText(ModelConfig(use_alignability_head=True, random_pos_start=False),
                        vocab_size=66251)
        load_reference_checkpoint(path, m, verbose=False)
        m.to(dev).eval()
        video, ids = ee.seeded_inputs(8, T, C, N, W, dev)
        with torch.no_grad():
            fwd[name] = ee.EvalForward(m)(ee.eval_params(m), video, ids)
    err = max((fwd["exported"][k] - fwd["trained"][k]).abs().max().item() for k in fwd["trained"])
    emit({"phase": "export_torch", "keys": sorted(ckpt), "epoch": ckpt["epoch"],
          "iteration": ckpt["iteration"], "forward_max_abs_err": err})
    check(sorted(ckpt) == ["best_acc", "epoch", "iteration", "optimizer", "state_dict"]
          and ckpt["optimizer"] == {} and ckpt["iteration"] == 4 and err == 0.0,
          "export_torch's file")
    return launches


# the kernel each wrapper launches once a call on the train step's bf16 routes, by
# a part of the name torch.profiler gives it (its demangled symbol)
KERNEL_SYMBOLS = {"mha_fwd": "mha_fwd_wgmma_kernel<", "mha_bwd": "mha_bwd_fused_kernel<",
                  "milnce_fwd": "milnce_fwd_wgmma_kernel<",
                  "milnce_dv": "milnce_grad_wgmma_kernel<true,",
                  "milnce_dt": "milnce_grad_wgmma_kernel<false,"}


def profiled_launches(torch, fn, nccl=False):
    """{wrapper: launches of its kernel (KERNEL_SYMBOLS) in one call of
    ``fn``}, counted on the device in a torch.profiler trace: what ran,
    however it was launched (a replayed CUDA graph passes no wrapper); with
    ``nccl`` also NCCL's kernels (NCCL_KERNEL_MARKS) under "nccl".  A
    session can lose device activity (``device_profile``), so the counts are
    those two sessions recorded alike, none of them all zero; None if no two
    of PROFILER_TRIES + 1 did."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    seen = []
    for _ in range(PROFILER_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        counts = dict.fromkeys(KERNEL_SYMBOLS, 0)
        if nccl:
            counts["nccl"] = 0
        events = prof.key_averages()
        host = {e.key for e in events if e.device_type == DeviceType.CPU}  # ranges, not kernels
        for e in events:
            if e.key in host:
                continue
            for name, symbol in KERNEL_SYMBOLS.items():
                if e.device_type == DeviceType.CUDA and symbol in e.key:
                    counts[name] += e.count
            if nccl and e.device_type == DeviceType.CUDA and any(
                    m in e.key.lower() for m in NCCL_KERNEL_MARKS):
                counts["nccl"] += e.count
        if any(counts.values()) and counts in seen:
            return counts
        seen.append(counts)
    return None


def same_floats(a, b) -> bool:
    """Two lists of floats equal to the bit, NaN where the other is NaN."""
    return len(a) == len(b) and all(x == y or (x != x and y != y) for x, y in zip(a, b))


def grouped_against_eager(torch, batches, cotrain, state, train_kw=None):
    """From one state (the seed's, or ``state``), two groups of ``batches``
    as eager train steps and as grouped ones (E6D6, B = 64, bf16, fused;
    ``train_kw`` the TrainConfig flags): the first group's eager warm-up
    steps, the captures (one a kind of step), and replays.  Each run's
    losses, params (and the twin's), wrapper launch counts and routes,
    update and non-finite counts and generator state; for the grouped run
    also the launches at capture, the device's launches in one more group
    of replays (``profiled_launches``) and the host syncs of a group and
    its one fetch (``fetch_group``)."""
    from temporalalignnet_torch.train.train_step import fetch_group

    dev = torch.device("cuda")
    runs = {}
    for mode in ("eager", "graph"):
        model, opt, step, twin = train_setup(torch, dev, fused=True, state=state,
                                             cotrain=cotrain, multi=mode == "graph",
                                             train_kw=train_kw)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        if mode == "eager":
            losses = torch.stack([step(b)["loss"] for b in batches + batches])
        else:
            first = step(batches)["loss"]
            updates_after = step.updates_after
            second = step(batches)["loss"]
            losses = torch.cat([first, second])
            updates_after = torch.cat([updates_after, step.updates_after]).tolist()
        torch.cuda.synchronize()
        runs[mode] = {
            "seconds": time.perf_counter() - t0, "losses": losses.tolist(),
            "launches": read_counts(), "routes": read_routes(),
            "params": {k: v.detach().clone() for k, v in model.state_dict().items()},
            "target": None if twin is None else {k: v.detach().clone()
                                                 for k, v in twin.model.state_dict().items()},
            "updates": opt.updates, "notfinite": opt.notfinite, "micro": opt.micro,
            "micro_steps": None if twin is None else twin.micro_steps,
            "generator": step.generator.get_state()}
        if mode == "graph":
            runs[mode].update(per_step=step.launches_per_step, warmup=step.warmup,
                              captures=len(step.kinds), updates_after=updates_after)
            runs[mode]["replayed"] = profiled_launches(torch, lambda: step(batches))
            more = batches[:2]
            runs[mode]["host_syncs_per_group"] = host_syncs(
                torch, lambda: fetch_group(step(more), step.updates_after))
        del model, opt, step, twin
    return runs


# grouped dispatch's cases: (case, cotrain, TrainConfig flags, the batch of a group made
# non-finite); the first two since slice 8, the rest since slice 12
GROUPED_CASES = (("stage1", False, {}, None), ("cotrain", True, {}, None),
                 ("stage1_backprop_freq_3", False, dict(backprop_freq=3), None),
                 ("cotrain_backprop_freq_2", True, dict(backprop_freq=2), None),
                 ("stage1_skip_nonfinite", False, dict(skip_nonfinite_updates=True), 2))


def phase_grouped_dispatch(torch, files, stage1_state):
    """--steps_per_dispatch on the card (GROUPED_CASES): Stage 1 and cotrain
    (from the train phase's Stage-1 state) at E6D6, B = 64, bf16, fused,
    plain, at --backprop_freq 3 (Stage 1) and 2 (cotrain), and Stage 1 at
    --skip_nonfinite 1 with a non-finite batch in each group (a NaN feature:
    a NaN loss, its update skipped): from one state, two groups of GROUP_K
    batches as grouped steps (eager warm-up steps, a capture a kind of
    step, replays) and as as many eager steps must give equal losses,
    params, twin params, update and non-finite counts and generator state
    (to the bit).  The wrappers count the eager steps' launches and the
    captures', and none of a replay's: a capture's must be STEP_LAUNCHES /
    COTRAIN_STEP_LAUNCHES on their routes, and a group of GROUP_K replays,
    profiled, must run GROUP_K times that on the device; then the host syncs
    of a group (its one fetch).  Beside it, in children, the train CLI at
    GROUP_CLI_STEPS steps an epoch with --steps_per_dispatch GROUP_K
    --max_steps 10, which must overshoot to 12 and say so, against
    --max_steps 12 per step, and with --backprop_freq 2 grouped against per
    step: equal losses and params.  Returns, per case, the launches on the
    device in one group of replays and the wrappers' count at capture."""
    from temporalalignnet_torch.core.config import DataConfig
    from temporalalignnet_torch.data import HTMFeatureDataset, TrainLoader
    from temporalalignnet_torch.models.word2vec import Word2VecTokenizer

    feats, captions, vocab = files
    B, T, N, W = (TRAIN[k] for k in "BTNW")
    ds = HTMFeatureDataset(feats, captions, DataConfig(seq_len=T, max_sentences=N, max_words=W),
                           "train", Word2VecTokenizer(vocab, max_words=W))
    # the CLI's batch: GROUP_CLI_STEPS steps an epoch, so that its groups of GROUP_K
    # end at GROUP_K, 2 GROUP_K, ... and the one that crosses --max_steps 10 runs past it
    cli_b = len(ds) // GROUP_CLI_STEPS
    stop_at = -(-10 // GROUP_K) * GROUP_K
    prefix = os.path.join(REPO, "build", "chip_smoke_group")
    shutil.rmtree(prefix, ignore_errors=True)
    base = [sys.executable, "-m", "temporalalignnet_torch.train", "--feature_dir", feats,
            "--captions", captions, "--vocab", vocab, "--batch_size", str(cli_b),
            "--epochs", "2", "--log_every", "1", "--warmup_iterations", "2",
            "--runtime_save_iter", "0"]
    bf2 = ["--backprop_freq", "2", "--max_steps", str(GROUP_CLI_STEPS)]
    children = {
        "grouped": start(base + ["--steps_per_dispatch", str(GROUP_K), "--max_steps", "10",
                                 "--prefix", os.path.join(prefix, "grouped")]),
        "per_step": start(base + ["--max_steps", str(stop_at), "--prefix",
                                  os.path.join(prefix, "per_step")]),
        "grouped_backprop_freq_2": start(base + bf2 + [
            "--steps_per_dispatch", str(GROUP_K), "--prefix", os.path.join(prefix, "g_bf2")]),
        "per_step_backprop_freq_2": start(base + bf2 + [
            "--prefix", os.path.join(prefix, "p_bf2")])}
    try:
        loader = TrainLoader(ds, B, seed=SEED + 30, num_workers=8, pin_memory=True)
        batches = []
        while len(batches) < GROUP_K:  # 1 batch an epoch at B = 64 over the 96 videos
            loader.set_epoch(len(batches))
            batches += list(loader)
        batches = batches[:GROUP_K]
        launches = {}
        for case, cotrain, flags, bad in GROUPED_CASES:
            per_step, by_route = ((COTRAIN_STEP_LAUNCHES, COTRAIN_STEP_ROUTES) if cotrain
                                  else (STEP_LAUNCHES, STEP_ROUTES))
            group = list(batches)
            if bad is not None:  # a copy, so that the other cases see the finite batch
                group[bad] = dict(group[bad], video=group[bad]["video"].clone().pin_memory())
                group[bad]["video"][0, 0, 0] = float("nan")
            runs = grouped_against_eager(torch, group, cotrain, stage1_state if cotrain
                                         else None, flags)
            eager, graph = runs["eager"], runs["graph"]
            param_err = max((eager["params"][k] - graph["params"][k]).abs().max().item()
                            for k in eager["params"])
            target_err = None if eager["target"] is None else max(
                (eager["target"][k] - graph["target"][k]).abs().max().item()
                for k in eager["target"])
            param_equal = all(torch.equal(eager["params"][k], graph["params"][k])
                              for k in eager["params"])
            target_equal = None if eager["target"] is None else all(
                torch.equal(eager["target"][k], graph["target"][k]) for k in eager["target"])
            captured = {k: v[""] for k, v in graph["per_step"].items()}
            captured_routes = {k: {r: n for r, n in v.items() if r} for k, v in
                               graph["per_step"].items()}
            steps = 2 * GROUP_K
            k = flags.get("backprop_freq", 1)
            skipped = 0 if bad is None else 2
            row = {"phase": "grouped_dispatch", "case": case, "flags": flags, "steps": steps,
                   "nonfinite_batch": bad, "eager_warmup_steps": graph["warmup"],
                   "captures": graph["captures"],
                   "losses_eager": eager["losses"], "losses_grouped": graph["losses"],
                   "param_max_abs_err": param_err, "target_max_abs_err": target_err,
                   "params_bit_equal": param_equal, "target_bit_equal": target_equal,
                   "launches_per_step_at_capture": captured,
                   "routes_per_step_at_capture": captured_routes,
                   "launches_wrappers_grouped": graph["launches"],
                   "launches_wrappers_eager": eager["launches"],
                   "launches_device_group_of_replays": graph["replayed"],
                   "updates": [eager["updates"], graph["updates"]],
                   "updates_after_grouped": graph["updates_after"],
                   "notfinite": [eager["notfinite"], graph["notfinite"]],
                   "twin_micro_steps": [eager["micro_steps"], graph["micro_steps"]],
                   "host_syncs_per_group": graph["host_syncs_per_group"],
                   "seconds": {m: r["seconds"] for m, r in runs.items()}}
            emit(row)
            check(same_floats(eager["losses"], graph["losses"]) and param_equal
                  and target_equal in (None, True), f"{case}: grouped steps differ from eager")
            check(sum(x != x for x in graph["losses"]) == skipped,
                  f"{case}: NaN losses {graph['losses']}")
            check(captured == per_step and captured_routes == by_route,
                  f"{case}: launches per step at capture {captured} {captured_routes}")
            wrapper_steps = graph["warmup"] + graph["captures"]
            check(eager["launches"] == {n: steps * v for n, v in per_step.items()}
                  and graph["launches"] == {n: wrapper_steps * v for n, v in per_step.items()},
                  f"{case}: wrapper launches {graph['launches']}, eager {eager['launches']}")
            check(graph["replayed"] == {n: GROUP_K * per_step[n] for n in KERNEL_SYMBOLS},
                  f"{case}: kernels on the device in a group of replays {graph['replayed']}")
            check(eager["updates"] == graph["updates"] == steps // k - skipped
                  and graph["updates_after"][-1] == graph["updates"]
                  and eager["notfinite"] == graph["notfinite"]
                  and eager["micro"] == graph["micro"]
                  and eager["micro_steps"] == graph["micro_steps"]
                  and torch.equal(eager["generator"], graph["generator"]),
                  f"{case}: counters or generator differ")
            check(sum(graph["host_syncs_per_group"].values()) == 1,
                  f"{case}: host syncs of a group {graph['host_syncs_per_group']}")
            launches[case] = {"replayed": graph["replayed"], "at_capture": captured}
        outs = {c: finish(p, f"train CLI {c}", timeout=900) for c, p in children.items()}
    finally:
        stop(children.values())
    finals = {c: json.loads(o.strip().splitlines()[-1]) for c, o in outs.items()}
    losses = {c: logged_losses(o) for c, o in outs.items()}
    overshoot = [l for l in outs["grouped"].splitlines() if l.startswith("[stop]")]
    for suffix in ("", "_backprop_freq_2"):
        grouped, per_step = f"grouped{suffix}", f"per_step{suffix}"
        err = state_err(torch, finals[grouped]["checkpoint"], finals[per_step]["checkpoint"])
        emit({"phase": "grouped_dispatch_cli" + suffix, "batch": cli_b,
              "steps_per_epoch": len(ds) // cli_b,
              "stop_lines": overshoot if not suffix else None,
              "finals": {c: finals[c] for c in (grouped, per_step)},
              "losses": {c: losses[c] for c in (grouped, per_step)}, "param_max_abs_err": err})
        want = stop_at if not suffix else GROUP_CLI_STEPS
        check(finals[grouped]["final_step"] == finals[per_step]["final_step"] == want
              and losses[grouped] == losses[per_step] and err == 0.0,
              f"grouped CLI run{suffix} differs from the per-step one")
    check(overshoot == [f"[stop] --steps_per_dispatch group overshot --max_steps 10 by "
                        f"{stop_at - 10} steps (stopped at {stop_at})"],
          f"no overshoot line: {overshoot}")
    return launches


def e2e_step_time(torch, card, ready=lambda: None):
    """The e2e train step at full width (E2E: 32 clips of 16 x 224², bf16,
    frozen BN): steps/s and clips/s from CUDA events around back-to-back
    steps on one batch, the device time and idle share (torch.profiler),
    every kernel's device ms, the peak memory of a step, and the bound from
    the S3D forward's multiply-adds (a step: 3x the forward, conv1 2x as the
    clips take no gradient; 2 FLOPs each)."""
    dev = torch.device("cuda")
    model, step = e2e_setup(torch, dev, torch.bfloat16)
    macs, stem_macs = s3d_macs(torch, model, e2e_clips(torch, SEED, 1, E2E["T"],
                                                      E2E["S"]).to(dev), stem=True)
    batch = {k: v.to(dev) for k, v in e2e_batch(torch, SEED + 25, E2E["B"], E2E["n"],
                                                   E2E["T"], E2E["S"]).items()}
    ready()
    run = lambda: step(batch)
    step_ms = cuda_ms(torch, run, reps=10, warmup=3)
    busy_ms, per_kernel, host_ms, timing = device_profile(torch, run, reps=5, warmup=1)
    busy_ms = busy_ms if timing == "profiler" else None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run()
    torch.cuda.synchronize()
    clips = E2E["B"] * E2E["n"]
    # forward, data gradient and weight gradient: 3x the forward, but the
    # clips need no gradient, so conv1 does 2x
    flops = 2 * (3 * macs - stem_macs) * clips
    _, bf16_peak = peaks(card)
    top_host = sorted(host_ms.items(), key=lambda kv: -kv[1])[:15]
    emit({"phase": "times", "metric": "e2e_steps_per_s", "card": card, "value": 1e3 / step_ms,
          "ms_per_step": step_ms, "clips_per_s": clips * 1e3 / step_ms, "batch": E2E,
          "model": "S3D-G + word2vec text tower, dim 512, vocab 66,251, bf16 compute, "
                   "frozen BN, channels_last_3d",
          "device_busy_ms_per_step": busy_ms, "timing": timing,
          "idle_share": None if busy_ms is None else max(0.0, 1.0 - busy_ms / step_ms),
          "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
          "s3d_forward_macs_per_clip": macs, "conv1_macs_per_clip": stem_macs,
          "step_flops": flops,
          "bound_ms_bf16_peak": flops / bf16_peak * 1e3,
          "kernels_ms_per_step": by_name(per_kernel),
          "top_host_ops_self_ms_per_step": {k[:90]: v for k, v in top_host}})


# ------------------------------------------------ slice 9: data parallelism

# dp_world1: the train CLI's steps in a world of one (NCCL) and without a group, and
# (since slice 10) in a world of one with --steps_per_dispatch GROUP_K: the one epoch of
# the resume videos (5 batches of 64), groups of 4 and 1 (GraphedStep.WARMUP eager
# steps, then 3 replays)
DP_WORLD1_STEPS = 5
# dp_two_ranks: the cases of the two ranks (two processes on the one card,
# joined by gloo: NCCL refuses two ranks on one device), each two steps from
# the Stage-1 state on two global batches of TRAIN["B"], B / 2 rows a rank:
# (name, cotrain, compute dtype)
DP_CASES = (("stage1_f32", False, "float32"), ("stage1_bf16", False, "bfloat16"),
            ("cotrain_f32", True, "float32"), ("cotrain_bf16", True, "bfloat16"))
DP_LOSS_TOL = {"float32": F32_STEP_TOL, "bfloat16": TRAIN_LOSS_TOL}
# params after the two steps, per element: |a - b| <= F32_STEP_TOL·|b| + DP_PARAM_ATOL
# (the twin's: + TARGET_ATOL).  Adam moves a weight by up to about lr whatever
# its gradient, so where the gradient is rounding noise two runs may step
# opposite ways; of the two steps only the second has lr > 0 (see TARGET_ATOL)
DP_PARAM_ATOL = 4 * TRAIN_LR
# the e2e step of the two ranks: (case, flags, dtype, batch); "full" is E2E in bf16
# (8 videos a rank), "small" E2E_DP_SMALL in f64 (2 videos a rank, as e2e_card_vs_cpu)
DP_E2E_CASES = (("frozen_bn", {}, "bfloat16", "full"),
                ("train_bn_stats", {"train_bn_stats": True}, "bfloat16", "full"),
                ("frozen_bn_f64", {}, "float64", "small"),
                ("train_bn_stats_f64", {"train_bn_stats": True}, "float64", "small"))
E2E_DP_SMALL = dict(B=4, n=2, T=8, S=64)
# e2e gradients, per tensor: |a - b| <= tol·(|b| + |whole gradient|): the InfoNCE
# sums each text's gradient with the others', so a tensor downstream of that
# sum (the text tower's biases) can cancel to a few 1e-6 of the whole gradient,
# where bf16 rounding alone decides its direction; f64: the InfoNCE runs in
# f32 (tests/test_torch_multiprocess.py's bar)
DP_E2E_GRAD_TOL = {"bfloat16": GRAD_TOL["bfloat16"], "float64": 1e-5}
# bf16 with train_bn_stats: a random-weight S3D normalised by batch statistics
# amplifies rounding through its BNs, so the 1-process step against itself on
# the same clips in another video order (the "spread") is the yardstick: the
# ranks must stay within DP_SPREAD_FACTOR times it
DP_SPREAD_FACTOR = 4.0
# NCCL's kernels by name: ncclDevKernel_* over several ranks; over one rank the
# AVG of the gradient average is NCCL's onerank.cu kernel (an H100, NCCL 2.28)
NCCL_KERNEL_MARKS = ("nccl", "onerank")
# the kernel names of a trace, per step of the train CLI (milnce_grad_wgmma: dv and dt)
DP_TRACE_KERNELS = {"mha_fwd_wgmma": 12, "mha_bwd_fused": 12, "milnce_fwd_wgmma": 2,
                    "milnce_grad_wgmma": 4}
# each kernel line entry's name among them
DP_GRAPH_SYMBOLS = {"mha_fwd": "mha_fwd_wgmma", "mha_bwd": "mha_bwd_fused",
                    "milnce_fwd": "milnce_fwd_wgmma", "milnce_dv": "milnce_grad_wgmma",
                    "milnce_dt": "milnce_grad_wgmma"}


def card_power() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def start_dp_world1(files):
    """The train CLI (E6D6, B = 64, bf16, fused; DP_WORLD1_STEPS steps, lr from
    the second) in two children: with ``--multihost`` in a world of one (NCCL,
    ``--profile_dir``) and without a process group; read by phase_dp_world1."""
    feats, captions, vocab = files
    root = os.path.join(REPO, "build", "chip_smoke_dp_world1")
    shutil.rmtree(root, ignore_errors=True)
    base = [sys.executable, "-m", "temporalalignnet_torch.train", "--feature_dir", feats,
            "--captions", captions, "--vocab", vocab, "--max_steps", str(DP_WORLD1_STEPS),
            "--epochs", "1", "--log_every", "1", "--runtime_save_iter", "0",
            "--warmup_iterations", "1"]
    world1 = lambda: ["--multihost", "--coordinator", f"127.0.0.1:{free_port()}",
                      "--num_processes", "1", "--process_id", "0"]
    procs = {"world1": start(base + ["--prefix", os.path.join(root, "world1"), *world1(),
                                     "--profile_dir", os.path.join(root, "trace")]),
             "plain": start(base + ["--prefix", os.path.join(root, "plain")]),
             # slice 10: the same world of one, its steps as a CUDA graph holding NCCL's
             "graph": start(base + ["--prefix", os.path.join(root, "graph"), *world1(),
                                    "--steps_per_dispatch", str(GROUP_K),
                                    "--profile_dir", os.path.join(root, "trace_graph")])}
    return procs, root


def phase_resume_and_world1(torch, yc2_files):
    """phase_resume, then the world-of-one CLIs (start_dp_world1) on its
    training files, read by phase_dp_world1, whose graph row it returns."""
    world1 = start_dp_world1(phase_resume(torch, yc2_files))
    try:
        return phase_dp_world1(torch, world1)
    finally:
        stop(world1[0].values())


def phase_dp_world1(torch, children):
    """The train CLI with ``--multihost`` in a world of one (NCCL) against the
    same run without a process group: the losses and the final params (equal
    to the bit, or the largest difference), the ``[multihost]`` line, and in
    the world-of-one run's torch.profiler trace the NCCL kernel of the
    gradient average and the port's kernels, per step.  Since slice 10 also
    the world-of-one run with --steps_per_dispatch GROUP_K (its steps and
    their NCCL collectives in a CUDA graph) against the eager one: losses
    and params equal to the bit, NCCL's kernel once per step in its trace,
    once per replay among the kernels its cudaGraphLaunch calls issued.
    Returns that run's row."""
    procs, root = children
    t0 = time.perf_counter()
    try:
        outs = {k: finish(p, f"train CLI {k} (dp_world1)", timeout=900) for k, p in procs.items()}
    finally:
        stop(procs.values())
    finals = {k: json.loads(o.strip().splitlines()[-1]) for k, o in outs.items()}
    losses = {k: logged_losses(o) for k, o in outs.items()}
    loss_err = max(abs(a - b) for a, b in zip(losses["world1"], losses["plain"]))
    param_err = state_err(torch, finals["world1"]["checkpoint"], finals["plain"]["checkpoint"])
    steps = DP_WORLD1_STEPS
    events = {}
    for which in ("trace", "trace_graph"):
        traces = [os.path.join(root, which, f) for f in os.listdir(os.path.join(root, which))
                  if f.startswith("trace_") and f.endswith(".json")]
        check(len(traces) == 1, f"--profile_dir wrote {traces}")
        with open(traces[0]) as f:
            events[which] = json.load(f)["traceEvents"]
    kernels = [e for e in events["trace"] if e.get("cat") == "kernel"]
    is_nccl = lambda e: any(m in e.get("name", "").lower() for m in NCCL_KERNEL_MARKS)
    nccl = {}
    for e in kernels:
        if is_nccl(e):
            row = nccl.setdefault(e["name"][:120], {"per_step": 0.0, "ms_per_step": 0.0})
            row["per_step"] += 1 / steps
            row["ms_per_step"] += e.get("dur", 0) / 1e3 / steps
    ours = {k: sum(k in e.get("name", "") for e in kernels) / steps for k in DP_TRACE_KERNELS}
    # the graphed run: its NCCL kernels, and those a cudaGraphLaunch issued (the
    # kernel's correlation id is its launching runtime call's)
    g_kernels = [e for e in events["trace_graph"] if e.get("cat") == "kernel"]
    launches = {e.get("args", {}).get("correlation") for e in events["trace_graph"]
                if e.get("cat") == "cuda_runtime" and "GraphLaunch" in e.get("name", "")}
    replays = steps - 2  # GraphedStep.WARMUP eager steps, then replays
    graph_row = {
        "steps": steps, "replayed_steps": replays, "graph_launches_in_trace": len(launches),
        "nccl_kernels": sum(map(is_nccl, g_kernels)),
        "nccl_kernels_in_replays": sum(
            is_nccl(e) and e.get("args", {}).get("correlation") in launches for e in g_kernels),
        "port_kernels_per_step": {k: sum(k in e.get("name", "") for e in g_kernels) / steps
                                  for k in DP_TRACE_KERNELS},
        "losses": logged_losses(outs["graph"]),
        "loss_max_abs_err_vs_eager": max(abs(a - b) for a, b in zip(logged_losses(outs["graph"]),
                                                                    losses["world1"])),
        "param_max_abs_err_vs_eager": state_err(torch, finals["graph"]["checkpoint"],
                                                finals["world1"]["checkpoint"])}
    line = [l for l in outs["world1"].splitlines() if l.startswith("[multihost]")]
    row = {"phase": "dp_world1", "card": card_power(), "steps": steps,
           "losses_world1": losses["world1"], "losses_plain": losses["plain"],
           "bit_equal": loss_err == 0.0 and param_err == 0.0,
           "loss_max_abs_err": loss_err, "param_max_abs_err": param_err,
           "param_bound": 2 * steps * TRAIN_LR, "multihost_line": line,
           "nccl_kernels_in_trace": nccl, "port_kernels_per_step_in_trace": ours,
           "seconds": time.perf_counter() - t0}
    emit(row)
    emit({"phase": "dp_world1_graph", "card": row["card"],
          "run": f"the same CLI, --steps_per_dispatch {GROUP_K}: the step and its NCCL "
                 "collectives in one CUDA graph", **graph_row})
    check(len(losses["world1"]) == len(losses["plain"]) == steps, f"dp_world1 losses {losses}")
    check(line == ["[multihost] process 0/1 builds batch rows [0, 64)"], f"dp_world1 {line}")
    check(loss_err <= TRAIN_LOSS_TOL, f"dp_world1 losses off the plain run by {loss_err}")
    check(param_err <= 2 * steps * TRAIN_LR, f"dp_world1 params off the plain run by {param_err}")
    check(sum(r["per_step"] for r in nccl.values()) >= 1,
          f"dp_world1: no NCCL kernel in the trace: {sorted({e['name'][:60] for e in kernels})}")
    check(ours == DP_TRACE_KERNELS, f"dp_world1 kernels per step in the trace {ours}")
    check(graph_row["loss_max_abs_err_vs_eager"] == 0.0
          and graph_row["param_max_abs_err_vs_eager"] == 0.0
          and len(graph_row["losses"]) == steps, f"dp_world1_graph against eager {graph_row}")
    check(graph_row["nccl_kernels"] == steps, f"dp_world1_graph NCCL kernels {graph_row}")
    check(not launches or graph_row["nccl_kernels_in_replays"] == replays,
          f"dp_world1_graph: NCCL kernels in the replays {graph_row}")
    check(graph_row["port_kernels_per_step"] == DP_TRACE_KERNELS,
          f"dp_world1_graph kernels per step in the trace {graph_row}")
    return graph_row


def dp_errors(ours, ref, dtype):
    """A rank's ``two_steps`` result and params against the 1-process one:
    loss and gradient errors (the three worst tensors), and the params'
    and the twin's worst |a - b| / (F32_STEP_TOL·|b| + atol)."""
    loss_err, grad_err, worst = compare_steps(ours, ref)

    def ratio(a, b, atol):
        return max((((a[n] - b[n]).abs() / (F32_STEP_TOL * b[n].abs() + atol)).max().item(), n)
                   for n in b)

    out = {"loss_max_abs_err": loss_err, "grad_max_norm_err": grad_err, "worst_grad": worst,
           "loss_tol": DP_LOSS_TOL[dtype], "grad_tol": GRAD_TOL[dtype],
           "param_ratio": ratio(ours[3], ref[3], DP_PARAM_ATOL)}
    if ref[2] is not None:
        out["target_ratio"] = ratio(ours[2], ref[2], TARGET_ATOL)
    return out


def e2e_grad_err(ours, ref):
    """The worst |a - b| / (|b| + |whole gradient|) over the tensors of two
    {name: gradient} dicts, and the three worst tensors."""
    whole = sum(g.double().square().sum().item() for g in ref.values()) ** 0.5
    errs = sorted((((ours[n].double() - g.double()).norm().item()
                    / (g.double().norm().item() + whole)), n) for n, g in ref.items())[::-1]
    return errs[0][0], errs[:3]


def dp_e2e_step(torch, dev, flags, dtype, clips, group=None):
    """One e2e step (E2E_LR): (loss, {param: gradient}, {BN statistic: value})."""
    grads = []
    compute = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    model, step = e2e_setup(torch, dev, compute, grads=grads, group=group,
                            dtype=torch.float64 if dtype == "float64" else None, **flags)
    loss = step(clips)["loss"].item()
    stats = {k: v.double().cpu() for k, v in model.state_dict().items() if "running" in k}
    return loss, grads[0], stats


def dp_steps(torch, model, step, batches, twin=None):
    """``two_steps`` with each step's launches and routes, and the params after."""
    losses, grads, per_step, routes = [], [], [], []
    for batch in batches:
        metrics, counts, r = counted_step(torch, step, batch)
        losses.append(metrics["loss"].item())
        grads.append({n: p.grad.detach().float().cpu()
                      for n, p in model.named_parameters() if p.grad is not None})
        per_step.append(counts)
        routes.append(r)
    target = None if twin is None else {n: p.detach().float().cpu()
                                        for n, p in twin.model.named_parameters()}
    params = {n: p.detach().float().cpu() for n, p in model.named_parameters()}
    return (losses, grads, target, params), per_step, routes


def dp_rank(torch, rank, port, work):
    """One rank of dp_two_ranks (a child of phase_dp_two_ranks): waits for
    the go file, joins the other rank by gloo on the card, then runs in turn
    the DP_CASES steps on its rows, a step with the column merge skipped (a
    planted fault), the 1-process steps of its half of DP_CASES on the
    global batches (both ranks at once), against which it holds those
    cases' results, the sharded align and retrieval CLIs (the 1-process
    CLIs' retrieval metrics, equal; align as ``phase_cli`` holds its CLI
    to the in-process evaluator), and one e2e step
    with frozen and with trained BN statistics, held against the 1-process
    results the parent saved; writes its results as JSON.  The two ranks'
    gradients and params are the same to the bit (``digest``)."""
    import temporalalignnet_torch.ops.milnce as milnce
    from temporalalignnet_torch.eval.cli import main as eval_main
    from temporalalignnet_torch.parallel import distributed
    from temporalalignnet_torch.parallel.mesh import local_batch_rows

    distributed.initialize_multihost(f"127.0.0.1:{port}", 2, rank, backend="gloo",
                                     device="cuda:0")
    group = distributed.default_group()
    dev = torch.device("cuda", 0)
    inputs = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    lo, hi = local_batch_rows(TRAIN["B"], group)
    rows = [{k: v[lo:hi] for k, v in b.items()} for b in inputs["batches"]]
    out = {"rank": rank, "rows": [lo, hi], "cases": {}}

    def digest(tensors):
        return sum(t.double().sum().item() * (i + 1) for i, t in enumerate(tensors))

    sharded, targets = {}, {}
    for name, cotrain, dt in DP_CASES:
        model, _, step, twin = train_setup(torch, dev, fused=True, state=inputs["state"],
                                           compute=getattr(torch, dt), cotrain=cotrain,
                                           group=group)
        with TargetRecorder() as rec:
            res, per_step, routes = dp_steps(torch, model, step, rows, twin)
        # every rank's agreement targets of each step, [B, T, N]
        targets[name] = [distributed.all_gather(t, 0, group) for _, t in rec.calls]
        sharded[name] = res
        out["cases"][name] = {"losses": res[0], "launches_per_step": per_step,
                              "routes_per_step": routes,
                              "digest": [digest(res[3].values())]
                              + [digest(g.values()) for g in res[1]]}
        del model, step, twin
    # the planted fault: each rank's own column logsumexps, no merge
    merge = milnce.merge_lse
    milnce.merge_lse = lambda lse, group: lse
    try:
        model, _, step, _ = train_setup(torch, dev, fused=True, state=inputs["state"],
                                        compute=torch.bfloat16, group=group)
        fault, _, _ = dp_steps(torch, model, step, rows[:1])
    finally:
        milnce.merge_lse = merge
    del model, step
    # the 1-process steps of this rank's half of the cases, on the global batches
    for i, (name, cotrain, dt) in enumerate(DP_CASES):
        if i % 2 != rank:
            continue
        model, _, step, twin = train_setup(torch, dev, fused=True, state=inputs["state"],
                                           compute=getattr(torch, dt), cotrain=cotrain)
        with TargetRecorder() as rec:
            ref, _, _ = dp_steps(torch, model, step, inputs["batches"], twin)
        if cotrain:  # the agreement targets of one process against the ranks'
            diff = [(i, *map(int, x)) for i, ((_, a), b) in enumerate(zip(rec.calls,
                                                                           targets[name]))
                    for x in (a != b).nonzero()[:, [0, 2]].unique(dim=0)]
            out["cases"][name]["target_sentences_differing"] = [
                {"step": i, "video": b, "sentence": n,
                 "margins_joint_dual": window_margins(torch, rec.calls[i][0], b, n)}
                for i, b, n in diff]
        if cotrain and dt == "bfloat16":
            # bf16 rounds the twin's sims apart on the two runs, and a discrete
            # target may then flip at a near-tie: the 1-process step is held
            # with the ranks' targets (the f32 case holds them as they come)
            del model, step, twin
            model, _, step, twin = train_setup(torch, dev, fused=True, state=inputs["state"],
                                               compute=getattr(torch, dt), cotrain=cotrain)
            with ForcedTargets(targets[name]):
                ref, _, _ = dp_steps(torch, model, step, inputs["batches"], twin)
        out["cases"][name].update(dp_errors(sharded[name], ref, dt), checked_by=rank)
        if name == "stage1_bf16":
            out["fault"] = compare_steps((fault[0], fault[1]), (ref[0][:1], ref[1][:1]))
        del model, step, twin, ref
    del sharded, fault
    torch.cuda.empty_cache()
    distributed.barrier()
    t0 = time.perf_counter()
    e_feats, anno, e_vocab = inputs["eval_files"]
    y_feats, y_anno, y_vocab = inputs["yc2_files"]
    ckpt = ["--ckpt", inputs["ckpt"], "--shard_eval"]
    out["evals"] = {
        "align": eval_main(["--task", "align", "--features", e_feats, "--anno", anno,
                            "--vocab", e_vocab, *ckpt]),
        "retrieval": eval_main(["--task", "retrieval", "--features", y_feats, "--anno", y_anno,
                                "--vocab", y_vocab, *ckpt]),
        "seconds": time.perf_counter() - t0}
    torch.cuda.empty_cache()
    out["e2e"], sharded = {}, {}
    for case, flags, dt, size in DP_E2E_CASES:
        full = inputs["e2e_batch" if size == "full" else "e2e_small"]
        per = full["clips"].shape[0] // 2
        clips = {k: v[per * rank:per * (rank + 1)] for k, v in full.items()}
        t0 = time.perf_counter()
        sharded[case] = dp_e2e_step(torch, dev, flags, dt, clips, group)
        loss, grads, stats = sharded[case]
        out["e2e"][case] = {"loss": loss, "digest": [digest(grads.values()),
                                                     digest(stats.values())],
                            "setup_and_step_seconds": time.perf_counter() - t0}
        torch.cuda.empty_cache()
    # the 1-process steps of this rank's half of the cases, on the global clips
    for i, (case, flags, dt, size) in enumerate(DP_E2E_CASES):
        if i % 2 != rank:
            continue
        clips = inputs["e2e_batch" if size == "full" else "e2e_small"]
        ref_loss, ref_grads, ref_stats = dp_e2e_step(torch, dev, flags, dt, clips)
        loss, grads, stats = sharded[case]
        grad_err, worst = e2e_grad_err(grads, ref_grads)
        row = out["e2e"][case]
        row.update(loss_abs_err=abs(loss - ref_loss), grad_err=grad_err, worst_grad=worst,
                   stats_max_norm_err=max(((norm_err(stats[k], v), k)
                                           for k, v in ref_stats.items()), default=[0.0, None]),
                   spread=None, checked_by=rank)
        if dt == "bfloat16":  # the same clips, the videos in reverse order
            back = {k: v.flip(0) for k, v in clips.items()}
            loss2, grads2, stats2 = dp_e2e_step(torch, dev, flags, dt, back)
            row["spread"] = {
                "loss_abs_err": abs(loss2 - ref_loss),
                "grad_err": e2e_grad_err(grads2, ref_grads)[0],
                "stats_max_norm_err": max((norm_err(stats2[k], v) for k, v in ref_stats.items()),
                                          default=0.0)}
        del ref_grads, ref_stats
        torch.cuda.empty_cache()
    distributed.destroy()
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def start_dp_two_ranks(torch, stage1_state, stage1_ckpt, eval_files, yc2_files):
    """dp_two_ranks' two children (``dp_rank``), started on the inputs they
    share (written to build/chip_smoke_dp/); phase_dp_two_ranks reads
    them."""
    from temporalalignnet_torch.data.synthetic import synthetic_batch

    work = os.path.join(REPO, "build", "chip_smoke_dp")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    T, N, W = (TRAIN[k] for k in "TNW")
    batches = [{k: torch.from_numpy(v) for k, v in synthetic_batch(
        np.random.RandomState(SEED + 40 + i), batch_size=TRAIN["B"], seq_len=T,
        max_sentences=N, feature_dim=1024, vocab_size=66250, max_words=W).items()}
        for i in range(2)]
    e2e_small = e2e_batch(torch, SEED + 43, *(E2E_DP_SMALL[k] for k in "BnTS"))
    e2e_small["clips"] = e2e_small["clips"].double()
    torch.save({"batches": batches, "state": stage1_state, "e2e_small": e2e_small,
                "e2e_batch": e2e_batch(torch, SEED + 42, E2E["B"], E2E["n"], E2E["T"], E2E["S"]),
                "ckpt": stage1_ckpt, "eval_files": eval_files, "yc2_files": yc2_files},
               os.path.join(work, "inputs.pt"))
    port = free_port()
    ranks = [start([sys.executable, os.path.abspath(__file__), "--dp-rank", str(r), str(port),
                    work]) for r in range(2)]
    return ranks, work, time.perf_counter()


def phase_dp_two_ranks(children, eval_files, cli_metrics):
    """Two processes on the one card joined by gloo through the library's
    entry points (``initialize_multihost(backend="gloo")``; the CLIs keep
    NCCL), started by start_dp_two_ranks and read here.  Each rank holds its B / 2 rows: the Stage-1 and cotrain steps,
    f32 compute and bf16, each against the 1-process step on the same two
    global batches (loss, per-tensor norm-relative gradients, params and
    the twin after the second step; the launches and routes per rank and
    step: 12/12/2/2/2, 24 mha_fwd in cotrain), a planted fault (the column
    merge skipped) that must exceed the bf16 limit, the sharded align and
    retrieval CLIs on the train CLI's checkpoint (the 1-process CLIs'
    metrics: retrieval equal, align within phase_cli's bars), and one e2e
    step, frozen BN and train_bn_stats, at E2E (16 videos x 2 clips of 16 x
    224², bf16, 8 videos a rank) and at E2E_DP_SMALL in f64 (loss,
    gradients, BN statistics).  Returns each rank's launches over its bf16
    Stage-1 and cotrain steps."""
    ranks, work, t_start = children
    try:
        for r, proc in enumerate(ranks):
            finish(proc, f"dp_two_ranks rank {r}", timeout=900)
    finally:
        stop(ranks)
    t_ranks = time.perf_counter() - t_start
    outs = []
    for r in range(2):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            outs.append(json.load(f))
    card = card_power()
    for name, cotrain, dt in DP_CASES:
        rows = [o["cases"][name] for o in outs]
        checked = next(row for row in rows if "checked_by" in row)
        emit({"phase": "dp_two_ranks", "case": name, "card": card, "batch": TRAIN["B"],
              "rows_per_rank": TRAIN["B"] // 2, **{f"rank{r}": row for r, row in enumerate(rows)}})
        want = COTRAIN_STEP_LAUNCHES if cotrain else STEP_LAUNCHES
        routes = ((COTRAIN_STEP_ROUTES if cotrain else STEP_ROUTES) if dt == "bfloat16" else
                  {k: {r: (want[k] if r == "f32" else 0) for r in v}
                   for k, v in STEP_ROUTES.items()})
        what = f"dp_two_ranks {name}"
        if cotrain and dt == "float32":
            check(not checked["target_sentences_differing"], f"{what}: agreement targets differ")
        check(checked["loss_max_abs_err"] <= DP_LOSS_TOL[dt], f"{what} loss {checked}")
        check(checked["grad_max_norm_err"] <= GRAD_TOL[dt],
              f"{what} grads {checked['worst_grad']}")
        check(checked["param_ratio"][0] <= 1.0, f"{what} params {checked['param_ratio']}")
        check(checked.get("target_ratio", [0.0])[0] <= 1.0, f"{what} twin {checked}")
        check(rows[0]["digest"] == rows[1]["digest"] and rows[0]["losses"] == rows[1]["losses"],
              f"{what}: the ranks' gradients, params or losses differ")
        for r, row in enumerate(rows):
            check_launches(row["launches_per_step"], row["routes_per_step"], want, routes,
                           f"{what} rank {r}")
    fault = next(o["fault"] for o in outs if "fault" in o)
    emit({"phase": "dp_two_ranks_planted_fault", "card": card,
          "fault": "column logsumexps not merged over the ranks (bf16 Stage-1 step)",
          "loss_abs_err": fault[0], "grad_max_norm_err": fault[1], "worst_grad": fault[2],
          "tol": GRAD_TOL["bfloat16"]})
    check(fault[1] > GRAD_TOL["bfloat16"], f"planted fault not caught {fault}")
    evals = [o["evals"] for o in outs]
    emit({"phase": "dp_two_ranks_evals", "card": card, "ranks": evals,
          "one_process": {"align": cli_metrics["align"], "retrieval": cli_metrics["metrics"]}})
    with open(eval_files[1]) as f:
        n_aligned = sum(s[0] for sents in json.load(f).values() for s in sents)
    for ev in evals:
        # retrieval: equal; align: as phase_cli, within the order of index_add_'s
        # atomic sums on the card, which no two runs share (one sentence, AUC_TOL)
        align, ref = ev["align"], cli_metrics["align"]
        check(ev["retrieval"] == cli_metrics["metrics"],
              f"sharded retrieval {ev['retrieval']} against one process {cli_metrics}")
        check(abs(align["Recall"] - ref["Recall"]) * n_aligned <= 1 + 1e-9
              and abs(align["AUC"] - ref["AUC"]) <= AUC_TOL,
              f"sharded align {align} against one process {ref}")
    e2e_rows = [o["e2e"] for o in outs]
    emit({"phase": "dp_two_ranks_e2e", "card": card,
          "cases": {c: {"dtype": dt, "clips": ([E2E["B"] * E2E["n"], E2E["T"], E2E["S"], E2E["S"]]
                                               if size == "full" else
                                               [E2E_DP_SMALL["B"] * E2E_DP_SMALL["n"],
                                                E2E_DP_SMALL["T"], E2E_DP_SMALL["S"],
                                                E2E_DP_SMALL["S"]])}
                    for c, _, dt, size in DP_E2E_CASES},
          "ranks": e2e_rows, "loss_tol": TRAIN_LOSS_TOL, "grad_tol": DP_E2E_GRAD_TOL,
          "spread_factor": DP_SPREAD_FACTOR})
    for case, _, dt, _ in DP_E2E_CASES:
        v = next(row[case] for row in e2e_rows if "checked_by" in row[case])
        what = f"dp e2e {case}: {v}"
        loss_bar, grad_bar = TRAIN_LOSS_TOL, DP_E2E_GRAD_TOL[dt]
        stats_bar = GRAD_TOL["bfloat16"] if dt == "bfloat16" else 1e-9
        if dt == "float64":
            loss_bar = 1e-6
        elif case.startswith("train_bn_stats"):
            loss_bar = max(loss_bar, DP_SPREAD_FACTOR * v["spread"]["loss_abs_err"])
            grad_bar = max(grad_bar, DP_SPREAD_FACTOR * v["spread"]["grad_err"])
            stats_bar = max(stats_bar, DP_SPREAD_FACTOR * v["spread"]["stats_max_norm_err"])
        check(v["loss_abs_err"] <= loss_bar, f"{what} loss over {loss_bar}")
        check(v["grad_err"] <= grad_bar, f"{what} grads over {grad_bar}")
        check(v["stats_max_norm_err"][0] <= stats_bar, f"{what} BN statistics over {stats_bar}")
        check(e2e_rows[0][case]["digest"] == e2e_rows[1][case]["digest"]
              and e2e_rows[0][case]["loss"] == e2e_rows[1][case]["loss"],
              f"dp e2e {case}: the ranks' gradients, BN statistics or losses differ")
    emit({"phase": "dp_two_ranks_seconds", "card": card,
          "ranks_from_their_start": t_ranks})
    shutil.rmtree(work, ignore_errors=True)
    per_rank = {}
    for o in outs:
        counts = [c for name in ("stage1_bf16", "cotrain_bf16")
                  for c in o["cases"][name]["launches_per_step"]]
        per_rank[f"rank{o['rank']}"] = {k: sum(c[k] for c in counts) for k in counts[0]}
    return per_rank


# ------------------------------------------------------------------ slice 10


def make_punct_dir(torch, root):
    """A punctuator directory at bert-base's widths: config.json with 15
    labels (Sentencify's LABEL_LIST), the synthetic 30,522-line vocab with
    PUNCT_STOPWORDS in place of its last words (so English captions pass
    the language filter and tokenize), and random pytorch_model.bin weights
    from the seed in HF's BertForTokenClassification key space (``bert.*``
    without the pooler, ``classifier.*``)."""
    from temporalalignnet_torch.models.bert import (BertConfig, BertForTokenClassification,
                                                    write_bert_dir)
    from temporalalignnet_torch.tools.sentencify import LABEL_LIST

    cfg = BertConfig(**BERT_CFG)
    gen = torch.Generator().manual_seed(SEED + 50)
    model = BertForTokenClassification(cfg, PUNCT["labels"])
    model.bert.init_weights(gen)
    with torch.no_grad():
        model.classifier.weight.copy_(torch.randn(model.classifier.weight.shape, generator=gen)
                                      * cfg.initializer_range)
        model.classifier.bias.zero_()
    vocab = bert_vocab()
    vocab[-len(PUNCT_STOPWORDS):] = PUNCT_STOPWORDS
    path = os.path.join(root, "bert-restore-punctuation")
    write_bert_dir(path, cfg, vocab, model.state_dict())
    with open(os.path.join(path, "config.json")) as f:
        config = json.load(f)
    config["id2label"] = {str(i): label for i, label in enumerate(LABEL_LIST)}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    return path


def make_punct_captions(path, seed):
    """PUNCT["videos"] videos of about PUNCT["captions"] unpunctuated ASR
    captions of 6-12 words, half of them PUNCT_STOPWORDS and half 'w<n>'
    words (n past the vocab's whole words splits into wordpieces), 1.5-4 s
    each, now and then after a gap over 1 s, in the raw {vid: {text, start,
    end}} layout."""
    rng = np.random.RandomState(seed)
    raw = {}
    for v in range(PUNCT["videos"]):
        caps, starts, ends, t = [], [], [], 0.0
        for _ in range(PUNCT["captions"] + rng.randint(-8, 9)):
            n = rng.randint(6, 13)
            words = [str(w) for w in rng.choice(PUNCT_STOPWORDS, n)]
            for j in rng.choice(n, n // 2, replace=False):
                words[j] = f"w{rng.randint(0, 60000)}"
            d = 1.5 + 2.5 * rng.rand()
            caps.append(" ".join(words))
            starts.append(round(t, 3))
            ends.append(round(t + d, 3))
            t += d + (1.5 if rng.rand() < 0.1 else 0.0)
        raw[f"punct{v:02d}"] = {"text": caps, "start": starts, "end": ends}
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


def punct_labels(logits, mask):
    """Sentencify's labels of one predict call (softmax, the -0.4 bias on
    the no-punctuation labels, argmax) and the biased probabilities."""
    e = np.exp(logits - logits.max(-1, keepdims=True))
    prob = e / e.sum(-1, keepdims=True)
    prob[:, :, 0:2] += -0.4
    return prob.argmax(-1), prob


def phase_punctuate(torch, card):
    """Slice 10's main path: ``python -m temporalalignnet_torch.tools.process_htm``
    (split, the language and length filters in a process pool, then the
    punctuator on the card) over PUNCT's synthetic videos with a bert-base
    punctuator directory: the files it writes, the mha_fwd launches (12 per
    predict call, all ``f32``), tokens/s of the predict calls and the
    pipeline's seconds; then the first PUNCT["cpu_videos"] calls on the
    CPU: logits (relative norm against TOWER_F32_REL), labels (a flip must
    be a near-tie, its margin printed) and the sentences of those videos.
    Returns the launches of the pipeline's run."""
    from temporalalignnet_torch.tools import process_htm, sentencify

    root = os.path.join(REPO, "build", "chip_smoke_punct")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t0 = time.perf_counter()
    model_dir = make_punct_dir(torch, root)
    raw = make_punct_captions(os.path.join(root, "raw_caption.json"), SEED + 51)
    t_files = time.perf_counter() - t0
    calls = []  # (ids, mask, logits, seconds) of each card predict call
    predict = sentencify.HFPunctuator.predict

    def recorded(self, ids, mask):
        t = time.perf_counter()
        out = predict(self, ids, mask)  # ends in a copy to the host
        calls.append((ids, mask, out, time.perf_counter() - t))
        return out

    sentencify.HFPunctuator.predict = recorded
    try:
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        outs = process_htm.main(["--raw_caption", raw, "--out_dir", os.path.join(root, "out"),
                                 "--punct_model_dir", model_dir, "--num_chunks", "2",
                                 "--jobs", "2"])
        wall = time.perf_counter() - t0
        launches, routes = read_counts(), read_routes()
    finally:
        sentencify.HFPunctuator.predict = predict
    written = {}
    for p in outs:
        with open(p) as f:
            written.update(json.load(f))
    tokens = int(sum(m.sum() for _, m, _, _ in calls))
    predict_s = sum(c[3] for c in calls)
    # the first videos again on the CPU, from the same inputs
    cpu = sentencify.HFPunctuator(model_dir, device="cpu")
    prepared = [item for p in outs
                for item in process_htm._prepare_chunk(p.replace("sentencified_chunk",
                                                                 "filtered_chunk"))]
    n_cpu = PUNCT["cpu_videos"]
    rel, max_abs, flips, sentences_equal = [], 0.0, [], []
    t0 = time.perf_counter()
    for i, (ids, mask, card_logits, _) in enumerate(calls[:n_cpu]):
        cpu_logits = cpu.predict(ids, mask)
        valid = mask.astype(bool)
        a, b = card_logits[valid], cpu_logits[valid]
        rel.append(float(np.linalg.norm(a - b) / np.linalg.norm(b)))
        max_abs = max(max_abs, float(np.abs(a - b).max()))
        ours, _ = punct_labels(card_logits, mask)
        theirs, prob = punct_labels(cpu_logits, mask)
        for r, c in zip(*np.nonzero((ours != theirs) & valid)):
            flips.append({"video": prepared[i][0], "chunk": int(r), "token": int(c),
                          "card_label": int(ours[r, c]), "cpu_label": int(theirs[r, c]),
                          "cpu_margin": float(prob[r, c, theirs[r, c]] - prob[r, c, ours[r, c]])})
        vid, caps, starts, ends = prepared[i]
        text, s0, e0 = sentencify.Sentencify(cpu).punctuate_and_cut(caps, starts, ends)
        sentences_equal.append(written[vid] == {"text": text, "start": s0, "end": e0})
    cpu_seconds = time.perf_counter() - t0
    chunks = [int(c[0].shape[0]) for c in calls]
    emit({"phase": "punctuate", "card": card_power(), "model": "BERT-base token classifier "
          f"(12 x 768, 12 heads, {PUNCT['labels']} labels), random weights, f32, TF32 off",
          "videos": PUNCT["videos"], "videos_written": len(written),
          "sentences": sum(len(v["text"]) for v in written.values()),
          "predict_calls": len(calls), "chunks_per_call": chunks,
          "max_chunk_len": max(int(c[0].shape[1]) for c in calls), "tokens": tokens,
          "tokens_per_s_predict": tokens / predict_s, "predict_seconds": predict_s,
          "pipeline_seconds": wall, "files_seconds": t_files,
          "launches": launches, "routes": routes,
          "cpu_videos": n_cpu, "logits_rel_norm_err": rel, "logits_max_abs_err": max_abs,
          "tol": TOWER_F32_REL, "label_flips": flips, "margin_tol": PUNCT_MARGIN_TOL,
          "sentences_equal": sentences_equal, "cpu_seconds": cpu_seconds})
    check(len(written) == PUNCT["videos"], f"punctuate wrote {len(written)} videos")
    check(len(calls) == PUNCT["videos"] and min(chunks) >= 2,
          f"punctuate: {len(calls)} predict calls of {chunks} chunks")
    check(launches["mha_fwd"] == 12 * len(calls)
          and routes["mha_fwd"] == {"short": 0, "long": 0, "f32": 12 * len(calls)},
          f"punctuate launched mha_fwd {launches['mha_fwd']} on {routes['mha_fwd']}")
    check(all(launches[k] == 0 for k in launches if k != "mha_fwd"), f"punctuate {launches}")
    check(max(rel) <= TOWER_F32_REL, f"punctuator logits card vs CPU {rel}")
    check(all(f["cpu_margin"] <= PUNCT_MARGIN_TOL for f in flips), f"label flips {flips}")
    check(all(sentences_equal) or flips, f"punctuate sentences differ: {sentences_equal}")
    shutil.rmtree(root, ignore_errors=True)
    return dict(launches, routes=routes)


def tp_rank(torch, rank, port, work):
    """One rank of tp_two_ranks (a child of phase_tp_two_ranks): joins the
    other by gloo on the card, makes the (1, TP) mesh, then runs each of
    TP_CASES' two steps on the global batches with its shard of the encoder
    blocks, the 1-process steps of its half of the cases (both ranks at
    once), a planted fault (the row-parallel biases added on both ranks, on
    weights whose row-parallel biases are random) against the 1-process
    step on those weights; the gathered params and gradients and their
    errors as JSON."""
    from temporalalignnet_torch.parallel import distributed
    from temporalalignnet_torch.parallel import tensor as tp_ops
    from temporalalignnet_torch.parallel.mesh import make_mesh

    distributed.initialize_multihost(f"127.0.0.1:{port}", TP, rank, backend="gloo",
                                     device="cuda:0")
    mesh = make_mesh(1, TP)
    dev = torch.device("cuda", 0)
    inputs = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    batches = inputs["batches"]
    out = {"rank": rank, "cases": {}}

    def digest(tensors):
        return sum(t.double().sum().item() * (i + 1) for i, t in enumerate(tensors))

    def gathered(res):
        losses, grads, target, params = res
        gather = lambda sd: tp_ops.tp_gather_state_dict(sd, mesh.tp_group)
        return (losses, [gather(g) for g in grads], None if target is None else gather(target),
                gather(params))

    def tp_steps(state, compute, cotrain, steps):
        model, _, step, twin = train_setup(torch, dev, fused=True, state=state,
                                           compute=compute, cotrain=cotrain,
                                           group=mesh.dp_group, tp_group=mesh.tp_group)
        with TargetRecorder() as rec:
            res, per_step, routes = dp_steps(torch, model, step, steps, twin)
        replicated = [p for n, p in model.named_parameters() if not tp_ops.is_sharded(p)]
        return gathered(res), per_step, routes, digest(replicated), [t for _, t in rec.calls]

    sharded, targets = {}, {}
    t0 = time.perf_counter()
    for name, cotrain, dt in TP_CASES:
        res, per_step, routes, rep, targets[name] = tp_steps(
            inputs["state"], getattr(torch, dt), cotrain, batches)
        sharded[name] = res
        out["cases"][name] = {"losses": res[0], "launches_per_step": per_step,
                              "routes_per_step": routes, "replicated_digest": rep,
                              "digest": [digest(res[3].values())]
                              + [digest(g.values()) for g in res[1]]}
        torch.cuda.empty_cache()
    # the planted fault, on weights whose row-parallel biases are random
    row = tp_ops.row_parallel_linear
    tp_ops.row_parallel_linear = lambda x, w, b, g: tp_ops.reduce_from_tp(
        torch.nn.functional.linear(x, w, b.to(x.dtype)), g)
    try:
        fault = tp_steps(inputs["biased_state"], torch.bfloat16, False, batches[:1])[0]
    finally:
        tp_ops.row_parallel_linear = row
    correct = tp_steps(inputs["biased_state"], torch.bfloat16, False, batches[:1])[0]
    out["ranks_seconds"] = time.perf_counter() - t0
    # the 1-process steps of this rank's half of the cases, on the same batches
    for i, (name, cotrain, dt) in enumerate(TP_CASES):
        if i % TP != rank:
            continue
        model, _, step, twin = train_setup(torch, dev, fused=True, state=inputs["state"],
                                           compute=getattr(torch, dt), cotrain=cotrain)
        # bf16 cotrain: a discrete agreement target may flip at a near-tie between
        # two bf16 runs, so the 1-process step is held with the ranks' targets
        with ForcedTargets(targets[name]) if cotrain and dt == "bfloat16" else TargetRecorder():
            ref, _, _ = dp_steps(torch, model, step, batches, twin)
        out["cases"][name].update(dp_errors(sharded[name], ref, dt), checked_by=rank)
        del model, step, twin
        if dt == "bfloat16":  # the yardstick: one process, the features moved below bf16's step
            model, _, step, twin = train_setup(torch, dev, fused=True, state=inputs["state"],
                                               compute=torch.bfloat16, cotrain=cotrain)
            gen = torch.Generator().manual_seed(SEED + 63)
            moved = [dict(b, video=b["video"] * (1 + TP_SPREAD_NOISE * torch.randn(
                b["video"].shape, generator=gen))) for b in batches]
            with ForcedTargets(targets[name]) if cotrain else TargetRecorder():
                rev, _, _ = dp_steps(torch, model, step, moved, twin)
            loss_err, grad_err, _ = compare_steps(rev, ref)
            out["cases"][name]["spread"] = {"loss_abs_err": loss_err, "grad_max_norm_err": grad_err}
            del model, step, twin, rev
        del ref
        torch.cuda.empty_cache()
    if rank == 0:
        model, _, step, _ = train_setup(torch, dev, fused=True, state=inputs["biased_state"],
                                        compute=torch.bfloat16)
        ref, _, _ = dp_steps(torch, model, step, batches[:1])
        out["fault"] = compare_steps((fault[0], fault[1]), (ref[0], ref[1]))
        out["biased_correct"] = compare_steps((correct[0], correct[1]), (ref[0], ref[1]))
    distributed.destroy()
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def start_tp_two_ranks(torch, stage1_state):
    """tp_two_ranks' children (``tp_rank``) on the inputs they share, written
    to build/chip_smoke_tp/: the train phase's Stage-1 state, the same with
    random row-parallel biases (N(0, 0.1), for the planted fault) and two
    global batches of TRAIN's shapes."""
    from temporalalignnet_torch.data.synthetic import synthetic_batch
    from temporalalignnet_torch.parallel.tensor import tp_dim

    work = os.path.join(REPO, "build", "chip_smoke_tp")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    T, N, W = (TRAIN[k] for k in "TNW")
    batches = [{k: torch.from_numpy(v) for k, v in synthetic_batch(
        np.random.RandomState(SEED + 60 + i), batch_size=TRAIN["B"], seq_len=T,
        max_sentences=N, feature_dim=1024, vocab_size=66250, max_words=W).items()}
        for i in range(2)]
    gen = torch.Generator().manual_seed(SEED + 62)
    biased = {k: (torch.randn(v.shape, generator=gen) * 0.1
                  if k.endswith(("out_proj.bias", "c_proj.bias")) and ".resblocks." in k else v)
              for k, v in stage1_state.items()}
    check(any(tp_dim(k) is not None for k in biased), "tp: no sharded key in the state")
    torch.save({"batches": batches, "state": stage1_state, "biased_state": biased},
               os.path.join(work, "inputs.pt"))
    port = free_port()
    ranks = [start([sys.executable, os.path.abspath(__file__), "--tp-rank", str(r), str(port),
                    work]) for r in range(TP)]
    return ranks, work, time.perf_counter()


def tp_bars(checked, dt):
    """(loss bar, gradient bar) of a tensor-parallel case against one process:
    f32 DP_LOSS_TOL / GRAD_TOL; bf16 at least DP_SPREAD_FACTOR times the
    1-process step's own spread under input features moved by
    TP_SPREAD_NOISE (relative), below bf16's resolution of 2^-8: the same
    function, some roundings flipped.  The tp ranks round each partial
    product to bf16 where one GEMM rounds its sum once, in every block, and
    a random-weight network amplifies bf16 rounding (on an H100: bf16
    cotrain 0.047 against one process, its batch rows reversed 0.005; on
    the CPU the input moved so moves the cotrain gradients by 0.14)."""
    if dt != "bfloat16":
        return DP_LOSS_TOL[dt], GRAD_TOL[dt]
    spread = checked["spread"]
    return (max(DP_LOSS_TOL[dt], DP_SPREAD_FACTOR * spread["loss_abs_err"]),
            max(GRAD_TOL[dt], DP_SPREAD_FACTOR * spread["grad_max_norm_err"]))


def phase_tp_two_ranks(children):
    """Tensor parallelism, TP = 2 ranks on the one card joined by gloo (NCCL
    refuses two ranks on one device), started by start_tp_two_ranks: E6D6
    width 512, 8 heads (4 a rank), B = 64 on both ranks (dp 1), Stage 1
    and cotrain in f32 and bf16 compute, two steps each against the
    1-process step on the same weights and batches: losses, norm-relative
    gradients and the gathered params (and twin) after the second step;
    each rank's launches and routes per step (12/12/2/2/2, 24 mha_fwd in
    cotrain); both ranks' gathered results and replicated params equal; the
    planted fault (row-parallel biases added on both ranks) over the bf16
    limit, the same step done right within it.  Returns each rank's
    launches over its bf16 Stage-1 and cotrain steps."""
    ranks, work, t_start = children
    try:
        for r, proc in enumerate(ranks):
            finish(proc, f"tp_two_ranks rank {r}", timeout=900)
    finally:
        stop(ranks)
    t_ranks = time.perf_counter() - t_start
    outs = []
    for r in range(TP):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            outs.append(json.load(f))
    card = card_power()
    for name, cotrain, dt in TP_CASES:
        rows = [o["cases"][name] for o in outs]
        checked = next(row for row in rows if "checked_by" in row)
        emit({"phase": "tp_two_ranks", "case": name, "card": card, "batch": TRAIN["B"],
              "tp": TP, "heads_per_rank": 8 // TP,
              **{f"rank{r}": row for r, row in enumerate(rows)}})
        want = COTRAIN_STEP_LAUNCHES if cotrain else STEP_LAUNCHES
        routes = ((COTRAIN_STEP_ROUTES if cotrain else STEP_ROUTES) if dt == "bfloat16" else
                  {k: {r: (want[k] if r == "f32" else 0) for r in v}
                   for k, v in STEP_ROUTES.items()})
        what = f"tp_two_ranks {name}"
        loss_bar, grad_bar = tp_bars(checked, dt)
        check(checked["loss_max_abs_err"] <= loss_bar, f"{what} loss {checked}")
        check(checked["grad_max_norm_err"] <= grad_bar,
              f"{what} grads over {grad_bar}: {checked['worst_grad']}")
        check(checked["param_ratio"][0] <= 1.0, f"{what} params {checked['param_ratio']}")
        check(checked.get("target_ratio", [0.0])[0] <= 1.0, f"{what} twin {checked}")
        check(rows[0]["digest"] == rows[1]["digest"] and rows[0]["losses"] == rows[1]["losses"]
              and rows[0]["replicated_digest"] == rows[1]["replicated_digest"],
              f"{what}: the ranks' gathered gradients, params, replicated params or losses differ")
        for r, row in enumerate(rows):
            check_launches(row["launches_per_step"], row["routes_per_step"], want, routes,
                           f"{what} rank {r}")
    fault, correct = outs[0]["fault"], outs[0]["biased_correct"]
    bar = tp_bars(next(o["cases"]["stage1_bf16"] for o in outs
                       if "checked_by" in o["cases"]["stage1_bf16"]), "bfloat16")[1]
    emit({"phase": "tp_two_ranks_planted_fault", "card": card,
          "fault": "row-parallel biases (out_proj, c_proj) added on both ranks, before the "
                   "reduce (bf16 Stage-1 step; row-parallel biases N(0, 0.1))",
          "loss_abs_err": fault[0], "grad_max_norm_err": fault[1], "worst_grad": fault[2],
          "done_right": {"loss_abs_err": correct[0], "grad_max_norm_err": correct[1]},
          "tol": bar})
    check(fault[1] > bar, f"tp planted fault not caught by {bar}: {fault}")
    check(correct[1] <= bar, f"tp step on the biased weights over {bar}: {correct}")
    emit({"phase": "tp_two_ranks_seconds", "card": card, "ranks_from_their_start": t_ranks,
          "ranks_steps_seconds": [o["ranks_seconds"] for o in outs]})
    shutil.rmtree(work, ignore_errors=True)
    per_rank = {}
    for o in outs:
        counts = [c for name in ("stage1_bf16", "cotrain_bf16")
                  for c in o["cases"][name]["launches_per_step"]]
        per_rank[f"rank{o['rank']}"] = {
            "steps": {k: sum(c[k] for c in counts) for k in counts[0]},
            "stage1_step": o["cases"]["stage1_bf16"]["launches_per_step"][0],
            "cotrain_step": o["cases"]["cotrain_bf16"]["launches_per_step"][0]}
    return per_rank


# the step-time children of a whole run: the steps whose device ms bound the bench
# tools' rates (init, cotrain, e2e)
STEP_TIME_CHILDREN = ("init", "cotrain", "e2e", "decoder")
# the other step-time children, run by ``chip_smoke.py --step-times``: each times a
# path that a phase of the whole run drives and checks (the agreement in cotrain, the
# retrieval forward, the world-of-one NCCL step and its graph in dp_world1, the graphed
# steps in grouped_dispatch, remat, the BERT TAN, the Stage-1 step at T = 128 and in
# f32 in train_t128; since slice 12 the Stage-1 step at --backprop_freq 2 and at
# --skip_nonfinite 1, eager and graphed, as grouped_dispatch drives them)
STEP_TIME_MORE = ("agreement", "dp_world1", "init_graph", "remat", "cotrain_graph",
                  "bert_init", "bert_cotrain", "bf16_t128", "f32", "init_bf2",
                  "init_bf2_graph", "init_skip", "init_skip_graph")
# the TrainConfig flags of the step-time children named ``init_<variant>[_graph]``
STEP_TIME_FLAGS = {"bf2": dict(backprop_freq=2), "skip": dict(skip_nonfinite_updates=True)}


def start_gated(flag, which, extra=(), name=None):
    """A child ``chip_smoke.py <flag> <which> <go> <extra>`` started now; it
    makes ready (imports, for a step-time child its CUDA context) and waits
    until its go file (under build/, named after ``name`` or ``which``)
    exists.  Returns (process, go file)."""
    go = os.path.join(REPO, "build", f"go{flag.replace('-', '_')}_{name or which}")
    for path in (go, go + ".ready"):
        if os.path.exists(path):
            os.remove(path)
    return start([sys.executable, os.path.abspath(__file__), flag, which, go, *extra]), go


def wait_for_release(go) -> None:
    """In a gated child: say it is ready (``<go>.ready``), then wait for its
    go file."""
    open(go + ".ready", "w").close()
    while not os.path.exists(go):
        time.sleep(0.05)


def wait_ready(children, what, timeout):
    """Until every gated child in ``children`` ({name: (process, go)}) has
    said it is ready (``wait_for_release``); a child that ended before is
    finished here, which raises its error."""
    t0 = time.perf_counter()
    for name, (proc, go) in children.items():
        while not os.path.exists(go + ".ready"):
            if proc.poll() is not None:
                finish(proc, f"{what} {name} (before it was ready)", timeout=60)
            check(time.perf_counter() - t0 < timeout, f"{what} {name} not ready")
            time.sleep(0.05)


def release(child, what, timeout):
    """Release a ``start_gated`` child; (its stdout, seconds from release)."""
    proc, go = child
    t0 = time.perf_counter()
    open(go, "w").close()
    out = finish(proc, what, timeout)
    return out, time.perf_counter() - t0


def start_step_times(which_children=STEP_TIME_CHILDREN):
    """The step-time children of ``which_children``, started now; each makes
    ready and waits for its release by phase_step_times."""
    return {which: start_gated("--step-time", which) for which in which_children}


def phase_step_times(children):
    """The step times of the started ``children`` (STEP_TIME_CHILDREN in a
    whole run; with STEP_TIME_MORE the agreement self-labelling's and a
    retrieval forward call's device time, and Stage-1 (plain, remat, in a
    world of one and graphed) and cotrain (plain and graphed) steps/s with
    their device time), each in a process of its own: on an H100, profiler sessions
    that followed one of thousands of kernels (a train step, an eval
    forward) lost device activity.  The children start at once; each makes
    ready (its model, batch and inputs on the card) and waits until its go
    file exists; once all are ready they are released one after another, so
    that no two time at once and none times beside another's set-up.
    ``process_seconds`` counts from a child's release."""
    lines = []
    try:
        wait_ready(children, "step-time child", timeout=600)
        for which, child in children.items():
            out, seconds = release(child, f"step times of {which}", timeout=900)
            for line in out.splitlines():
                if line.startswith("{"):
                    lines.append(dict(json.loads(line), process_seconds=seconds))
                    emit(lines[-1])
    finally:
        stop([proc for proc, _ in children.values()])
    return lines


def by_name(per_kernel, n=90):
    """{name cut to n characters: device ms}, summed over the kernels whose
    names agree that far, largest first."""
    out = {}
    for k, v in per_kernel.items():
        out[k[:n]] = out.get(k[:n], 0.0) + v
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def host_syncs(torch, fn):
    """{where: count} of the host-device synchronisations one call of ``fn``
    makes (torch.cuda's sync debug mode warns at each): the frame that
    warned, then the innermost frame of this repo that led to it.  Only
    warnings raised within ``fn`` count: turning the mode on warns once from
    ``torch.cuda.set_sync_debug_mode`` itself (seen on an H100, torch 2.11)."""
    import traceback
    import warnings

    where, inside = {}, [False]

    def seen(message, category, filename, lineno, file=None, line=None):
        if not inside[0] or "synchroniz" not in str(message):
            return
        ours = [f for f in traceback.extract_stack()[:-1] if f.filename.startswith(REPO)]
        key = f"{os.path.relpath(filename, REPO)}:{lineno}"
        if ours:
            key += f" from {os.path.relpath(ours[-1].filename, REPO)}:{ours[-1].lineno}"
        where[key] = where.get(key, 0) + 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = seen
        torch.cuda.set_sync_debug_mode("warn")
        try:
            inside[0] = True
            fn()
        finally:
            inside[0] = False
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()  # after the debug mode: not one of fn's
    return where


def step_time(torch, which, card, ready=lambda: None):
    """One JSON line of times at B = 64: ``which`` 'init' (a Stage-1 train
    step), 'dp_world1' (the same, then in a world of one: dp_world1_step_time),
    'remat' (the same with --remat) or 'cotrain' (a Stage-2 one),
    'init_graph' / 'cotrain_graph' (those steps as a CUDA graph, a group of
    GROUP_K replays timed per step), 'init_bf2' / 'init_skip' and their
    '_graph' forms (the Stage-1 step at --backprop_freq 2, per micro-step,
    and at --skip_nonfinite 1, STEP_TIME_FLAGS; the latter also times the
    masked restore of a step alone, beside its bytes over the card's rate),
    and 'bert_init' / 'bert_cotrain' (the
    same of the BERT TAN): steps/s with the device time, idle share, peak
    memory, every kernel's device ms and the top host ops; 'agreement': the
    agreement self-labelling alone at the cotrain step's shapes.  Each also
    counts the call's host-device synchronisations.  'e2e': the end-to-end
    S3D step at E2E (``e2e_step_time``); 'bf16_t128' and 'f32' the
    Stage-1 steps of STEP_VIEWS (``step_view``); 'decoder' the decoder
    stack's bf16 forward and forward + backward (``decoder_times``)."""
    if which == "e2e":
        e2e_step_time(torch, card, ready)
        return
    if which == "decoder":
        decoder_times(torch, card, ready)
        return
    if which in STEP_VIEWS:
        step_view(torch, which, card, ready)
        return
    from temporalalignnet_torch.core.config import LossConfig
    from temporalalignnet_torch.data.synthetic import synthetic_batch
    from temporalalignnet_torch.losses.agreement import agreement_self_labelling
    from temporalalignnet_torch.losses.tan_loss import mask_from_time

    dev = torch.device("cuda")
    B, T, N, W = (TRAIN[k] for k in "BTNW")
    batch = {k: torch.from_numpy(v).to(dev) for k, v in synthetic_batch(
        np.random.RandomState(SEED + 6), batch_size=B, seq_len=T, max_sentences=N,
        feature_dim=1024, vocab_size=66250, max_words=W).items()}
    if which == "agreement":
        S = 6
        gen = torch.Generator().manual_seed(SEED + 8)
        diags = [torch.randn(B, S, T, N, generator=gen).to(dev) * 2.0 for _ in range(2)]
        raw = mask_from_time(batch["start"], batch["end"], T, batch["text_padding_mask"])
        cfg = LossConfig(model="cotrain", learn_agreement=True)
        run = lambda: agreement_self_labelling(*diags, batch["video_padding_mask"],
                                               batch["text_padding_mask"], raw, cfg)
        ready()
        busy_ms, per_kernel, host_ms, timing = device_profile(torch, run)
        emit({"phase": "times", "metric": "agreement_ms", "card": card, "shape": [B, S, T, N],
              "device_ms": busy_ms if timing == "profiler" else None, "timing": timing,
              "wall_ms": cuda_ms(torch, run), "kernels_per_call": len(per_kernel),
              "host_self_ms_under_profiler": sum(host_ms.values()),
              "host_syncs": host_syncs(torch, run),
              "kernels_ms": by_name(per_kernel)})
        retrieval_forward_times(torch, card)  # after the agreement's smaller sessions
        return
    bert = which.startswith("bert_")
    graph = which.endswith("_graph")
    cotrain, remat = which.startswith(("cotrain", "bert_cotrain")), which == "remat"
    variant = which.removesuffix("_graph").removeprefix("init_")
    flags = STEP_TIME_FLAGS.get(variant)
    if bert:  # BERT's vocab (ids 1 ... 30521)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in synthetic_batch(
            np.random.RandomState(SEED + 6), batch_size=B, seq_len=T, max_sentences=N,
            feature_dim=1024, vocab_size=BERT_CFG["vocab_size"] - 1, max_words=W).items()}
    _, opt, step, _ = train_setup(torch, dev, fused=True, cotrain=cotrain, bert=bert,
                                  cfg_kw=dict(remat=True) if remat else None, multi=graph,
                                  train_kw=flags)
    per_call = GROUP_K if graph else 1
    if graph:  # a group of GROUP_K replays, each batch copied in from pinned memory
        group = [{k: v.cpu().pin_memory() for k, v in batch.items()}] * GROUP_K
        run = lambda: step(group)
    else:
        run = lambda: step(batch)
    ready()
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(torch, run, reps=max(10 // per_call, 3), warmup=3) / per_call
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    busy_ms, per_kernel, host_ms, timing = device_profile(torch, run, reps=5, warmup=1)
    busy_ms = busy_ms / per_call if timing == "profiler" else None
    per_kernel = {k: v / per_call for k, v in per_kernel.items()}
    top_host = sorted(host_ms.items(), key=lambda kv: -kv[1])[:15]
    model = (f"E6D6 width 512, {'BERT 12 x 768' if bert else 'word2vec'}, fused MIL-NCE, "
             "bf16 compute, f32 params")
    metric = {"init": "train_steps_per_s", "dp_world1": "train_steps_per_s",
              "remat": "train_remat_steps_per_s",
              "cotrain": "cotrain_steps_per_s", "bert_init": "bert_train_steps_per_s",
              "bert_cotrain": "bert_cotrain_steps_per_s",
              "init_graph": "train_graph_steps_per_s",
              "cotrain_graph": "cotrain_graph_steps_per_s"}.get(
                  which, f"train_{which}_steps_per_s")
    kind = ("" if which in ("init", "dp_world1", "bert_init", "init_graph") or flags else
            ", --remat 1" if remat else ", EMA twin, agreement keep, head on")
    if flags:
        kind += {"bf2": ", --backprop_freq 2 (per micro-step)",
                 "skip": ", --skip_nonfinite 1 (every update finite)"}[variant]
    if graph:
        kind += f", --steps_per_dispatch {GROUP_K} (a CUDA graph replayed per step)"
    emit({"phase": "times", "metric": metric,
          "card": card, "value": 1e3 / step_ms, "ms_per_step": step_ms, "batch": TRAIN,
          "model": model + kind, "peak_gb": peak_gb,
          "device_busy_ms_per_step": busy_ms, "timing": timing,
          "idle_share": None if busy_ms is None else max(0.0, 1.0 - busy_ms / step_ms),
          ("host_syncs_per_group" if graph else "host_syncs_per_step"): host_syncs(torch, run),
          "kernels_ms_per_step": by_name(per_kernel), "kernels_per_step": len(per_kernel),
          "host_self_ms_per_step_under_profiler": sum(host_ms.values()) / per_call,
          "top_host_ops_self_ms_per_step": {k[:90]: v / per_call for k, v in top_host}})
    if variant == "skip":  # the snapshot and the select of a step, alone
        masked_restore_times(torch, opt, card, which)
    if which == "dp_world1":  # slice 9: the same step in a world of one
        del step, run
        dp_world1_step_time(torch, card, batch, {
            "ms_per_step": step_ms, "device_busy_ms_per_step": busy_ms, "timing": timing,
            "idle_share": None if busy_ms is None else max(0.0, 1.0 - busy_ms / step_ms)})


def masked_restore_times(torch, opt, card, which):
    """--skip_nonfinite's cost on the device: the copy of the params and both
    moments before the update and the select after it
    (``Optimizer._undo_unless``), as a step runs them, timed alone (the
    flag set: the select writes back what it reads, the state unmoved),
    beside the bytes they move (per element: the copy reads and writes, the
    select reads two and writes one) over the card's rate."""
    moved = opt._guarded()
    apply = torch.ones((), dtype=torch.bool, device=moved[0].device)

    @torch.no_grad()
    def guard():
        torch._foreach_copy_(opt._keep, moved)
        opt._undo_unless(apply, moved)

    busy_ms, per_kernel, _, timing = device_profile(torch, guard, reps=5, warmup=2)
    elements = sum(t.numel() for t in moved)
    moved_bytes = 5 * elements * moved[0].element_size()
    bandwidth, _ = peaks(card)
    emit({"phase": "times", "metric": "masked_restore_ms", "card": card, "step": which,
          "device_ms": busy_ms if timing == "profiler" else None, "timing": timing,
          "wall_ms": cuda_ms(torch, guard, reps=10, warmup=2), "tensors": len(moved),
          "elements": elements, "bytes": moved_bytes,
          "bound_ms": moved_bytes / bandwidth * 1e3, "kernels_per_call": len(per_kernel),
          "kernels_ms": by_name(per_kernel)})


# end-to-end views of the Stage-1 step (E6D6 width 512, B = 64, N = 16, fused MIL-NCE):
# bf16 at T = 128 (joint S = 144: mha_bwd's fused route on the dual encoder's S = 128,
# the route past S = 128 on the joint encoder's), and f32 compute at T = 64 (every
# kernel on its f32 route)
STEP_VIEWS = {"bf16_t128": dict(T=128, compute="bfloat16"),
              "f32": dict(T=TRAIN["T"], compute="float32")}


def step_view(torch, which, card, ready=lambda: None):
    """One line of the Stage-1 step of STEP_VIEWS[which]: device ms (profiler)
    and steps/s (CUDA events) of back-to-back steps on one batch, the
    launches and routes of one step and every kernel's device ms.  Run as
    ``chip_smoke.py --step-view <which> [<tree>]``, with the port of <tree>
    (another checkout, e.g. the parent commit's) in place of this one's, so
    that two trees are timed in turns by the same code."""
    from temporalalignnet_torch.data.synthetic import synthetic_batch

    dev = torch.device("cuda")
    view = STEP_VIEWS[which]
    B, N, W = (TRAIN[k] for k in "BNW")
    batch = {k: torch.from_numpy(v).to(dev) for k, v in synthetic_batch(
        np.random.RandomState(SEED + 6), batch_size=B, seq_len=view["T"], max_sentences=N,
        feature_dim=1024, vocab_size=66250, max_words=W).items()}
    _, _, step, _ = train_setup(torch, dev, fused=True, compute=getattr(torch, view["compute"]))
    step(batch)
    ready()
    out, launches, routes = counted_step(torch, step, batch)
    run = lambda: step(batch)
    step_ms = cuda_ms(torch, run, reps=10, warmup=2)
    busy, per_kernel, _, timing = device_profile(torch, run, reps=5, warmup=1)
    import temporalalignnet_torch

    emit({"phase": "times", "metric": f"step_view_{which}", "card": card_power(),
          "port": os.path.dirname(os.path.dirname(os.path.abspath(temporalalignnet_torch.__file__))),
          "batch": dict(TRAIN, T=view["T"]), "compute": view["compute"],
          "model": "E6D6 width 512, word2vec, fused MIL-NCE, f32 params",
          "loss": out["loss"].item(), "ms_per_step": step_ms, "steps_per_s": 1e3 / step_ms,
          "device_ms_per_step": busy if timing == "profiler" else None, "timing": timing,
          "launches_per_step": launches, "routes_per_step": routes,
          "kernels_ms_per_step": by_name(per_kernel)})


def dp_world1_step_time(torch, card, batch, plain):
    """The Stage-1 step (E6D6, B = 64, bf16, fused) in a world of one over
    NCCL, in the ``init`` child right after its plain step (``plain``: that
    step's timing): launches per step (STEP_LAUNCHES on STEP_ROUTES), ms per
    step, device busy ms and idle share, and the NCCL kernels' device ms
    per step (the gradient average: NCCL's AVG launches its kernel over one
    rank)."""
    from temporalalignnet_torch.parallel import distributed

    distributed.initialize_multihost(f"127.0.0.1:{free_port()}", 1, 0, device="cuda")
    try:
        _, _, step, _ = train_setup(torch, torch.device("cuda"), fused=True,
                                    group=distributed.default_group())
        step(batch)
        _, launches, routes = counted_step(torch, step, batch)
        check(launches == STEP_LAUNCHES and routes == STEP_ROUTES,
              f"dp_world1 step launched {launches} on {routes}")
        run = lambda: step(batch)
        step_ms = cuda_ms(torch, run, reps=10, warmup=2)
        busy_ms, per_kernel, _, timing = device_profile(torch, run, reps=5, warmup=1)
        nccl = {k: v for k, v in by_name(per_kernel, 120).items()
                if any(m in k.lower() for m in NCCL_KERNEL_MARKS)}
        emit({"phase": "times", "metric": "dp_world1_step", "card": card,
              "card_power": card_power(), "batch": TRAIN,
              "model": "E6D6 width 512, word2vec, fused MIL-NCE, bf16 compute, f32 params",
              "dp_world1": {"ms_per_step": step_ms, "timing": timing,
                            "device_busy_ms_per_step": busy_ms if timing == "profiler" else None,
                            "idle_share": (max(0.0, 1.0 - busy_ms / step_ms)
                                           if timing == "profiler" else None),
                            "nccl_kernels_ms_per_step": nccl, "launches_per_step": launches,
                            "routes_per_step": routes},
              "plain": plain})
        if timing == "profiler":
            check(nccl, "dp_world1: no NCCL kernel in the profile of a step")
        del step, run
        # slice 10: the same step as a CUDA graph holding the collectives, beside the
        # graphed step without a group
        graphed = {}
        for which, group in (("dp_world1_graph", distributed.default_group()),
                             ("plain_graph", None)):
            _, _, multi, _ = train_setup(torch, torch.device("cuda"), fused=True, multi=True,
                                         group=group)
            pinned = [{k: v.cpu().pin_memory() for k, v in batch.items()}] * GROUP_K
            run = lambda: multi(pinned)
            run()  # the warm-up steps and the capture
            ms = cuda_ms(torch, run, reps=3, warmup=1) / GROUP_K
            busy, per_kernel, _, timing = device_profile(torch, run, reps=2, warmup=1)
            busy = busy / GROUP_K if timing == "profiler" else None
            graphed[which] = {
                "ms_per_step": ms, "steps_per_s": 1e3 / ms, "timing": timing,
                "device_busy_ms_per_step": busy,
                "idle_share": None if busy is None else max(0.0, 1.0 - busy / ms),
                "nccl_kernels_ms_per_step": {k: v / GROUP_K for k, v in by_name(
                    per_kernel, 120).items() if any(m in k.lower() for m in NCCL_KERNEL_MARKS)},
                "device_launches_per_group": profiled_launches(torch, run, nccl=True)}
            del multi, run
        emit({"phase": "times", "metric": "dp_world1_graph_step", "card": card,
              "card_power": card_power(), "batch": TRAIN, "group_steps": GROUP_K,
              "model": "E6D6 width 512, word2vec, fused MIL-NCE, bf16 compute, f32 params, "
                       f"--steps_per_dispatch {GROUP_K} (a CUDA graph replayed per step)",
              **graphed})
        counts = graphed["dp_world1_graph"]["device_launches_per_group"]
        check(counts is None or counts == dict(
            {k: GROUP_K * n for k, n in STEP_LAUNCHES.items()}, nccl=GROUP_K),
            f"dp_world1_graph: device launches in a group of replays {counts}")
    finally:
        distributed.destroy()


def retrieval_forward_times(torch, card):
    """Device ms of one retrieval forward call (25 clips of 10 windows through
    the dual encoder, bf16, E6 with random weights from the seed: the time
    does not depend on them) at a bucket of each mha_fwd route, with the
    retrieval's key padding."""
    dev = torch.device("cuda")
    model = make_model(torch, dev, torch.bfloat16)
    gen = torch.Generator().manual_seed(SEED + 12)
    device_ms = {}
    for Lb in (96, 256):
        wins = torch.randn(250, Lb, 1024, generator=gen).to(dev, torch.bfloat16)
        pad = yc2_mask(torch, 250, Lb, dev)
        eff = torch.full((250,), Lb - 31, device=dev)

        def forward():
            with torch.inference_mode():
                model.visual_feature(wins, pad, 64, eff)

        ms, _, _, timing = device_profile(torch, forward)
        device_ms[f"[250, {Lb}]"] = {"ms": ms if timing == "profiler" else None,
                                     "timing": timing, "wall_ms": cuda_ms(torch, forward)}
    emit({"phase": "times", "metric": "retrieval_forward_device_ms", "card": card,
          "model": "E6 dual encoder, width 512, bf16", "per_call": device_ms})


def phase_times(torch, card):
    import torch.nn.functional as F

    from temporalalignnet_torch.ops.attention import attention_reference
    from temporalalignnet_torch.ops.mha_fwd import mha_fwd, mha_fwd_v1, route

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 2)
    bw, bf16_peak = peaks(card)
    rows = []
    # bf16: the eval's, the training's, the retrieval's (its key padding), then
    # the towers' (BERT's padding; the vision towers' calls have no mask); f32:
    # F32_TIMED_SHAPES (the punctuator's attention runs in f32)
    shapes = KERNEL_SHAPES + MHA_BWD_SHAPES[:2] + YC2_TIMED_SHAPES + TOWER_SHAPES + TP_SHAPES
    for shape, dtype in ([(sh, torch.bfloat16) for sh in shapes]
                         + [(sh, torch.float32) for sh in F32_TIMED_SHAPES]):
        Bq, H, S, D = shape
        q, k, v = (torch.randn(shape, generator=gen).to(dev, dtype) for _ in range(3))
        if shape in YC2_TIMED_SHAPES:
            pad = yc2_mask(torch, Bq, S, dev)
        elif shape in TOWER_SHAPES[1:]:
            pad = torch.zeros(Bq, S, dtype=torch.bool, device=dev)  # counts every key
        else:
            pad = tower_mask(torch, shape, gen, dev)
        mask = None if shape in TOWER_SHAPES[1:] else pad
        keep = None if mask is None else ~pad[:, None, None, :]
        fns = {
            "": lambda: mha_fwd(q, k, v, mask),
            "v1_": lambda: mha_fwd_v1(q, k, v, mask),
            "plain_": lambda: attention_reference(q, k, v, mask),
            "library_": lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keep),
        }
        # ms: device time of every kernel the call launched (profiler);
        # wall_ms: CUDA events around back-to-back calls, host issue included
        row = {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
               "route": route(q.dtype, S), "masked": mask is not None}
        if dtype == torch.float32:  # mha_fwd_v1 is the earlier bf16 kernel
            del fns["v1_"]
        for prefix, fn in fns.items():
            row[prefix + "ms"], per_kernel, _, row[prefix + "timing"] = device_profile(
                torch, fn, confirm=True)
            if not prefix:
                row["kernels_ms"] = {k_[:60]: v_ for k_, v_ in per_kernel.items()}
            row[prefix + "wall_ms"] = cuda_ms(torch, fn)
        nbytes, flops = attention_work(q, pad, full=2, passes=2)  # q, out; QK^T, PV
        nbytes -= 0 if mask is not None else pad.numel()  # no mask to read
        if dtype == torch.float32:
            row.update(f32_bounds(card, nbytes, flops), bytes=nbytes, flops=flops)
        else:
            t_bytes, t_ops = nbytes / bw, flops / bf16_peak
            row.update(bound_ms=max(t_bytes, t_ops) * 1e3, peak_flops_per_s=bf16_peak,
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       bytes=nbytes, flops=flops)
        emit({"phase": "times", "kernel": "mha_fwd", "card": card, **row})
        rows.append(row)
    return rows


# ------------------------------------------------------ slice 11: bench tools

# (name, tool, arguments): each run of phase_bench_tools, in the order released
BENCH_ROUNDS = ("--iters", "10", "--repeats", "2")
BENCH_MODE_ROUNDS = ("--iters", "5", "--repeats", "1")
BENCH_TRACE_STEPS = 10  # the steps bench_e2e_step's --profile_dir trace holds
BENCH_RUNS = (
    ("train_stage1_fused", "bench_train_step", ("--stage", "1", "--fused", "1", *BENCH_ROUNDS)),
    ("train_stage2_fused", "bench_train_step", ("--stage", "2", "--fused", "1", *BENCH_ROUNDS)),
    ("train_stage1_plain", "bench_train_step", ("--stage", "1", "--fused", "0", *BENCH_ROUNDS)),
    # with a trace of 10 steps after the timed rounds
    ("e2e_b16", "bench_e2e_step", ("--batch_size", str(E2E["B"]), *BENCH_ROUNDS,
                                   "--profile_dir",
                                   os.path.join(REPO, "build", "chip_smoke_bench_trace"))),
    # slice 13: the e2e step's other modes at twice e2e_b16's batch, each with a
    # trace of its own, whose device ms a step bound its rate.  The step must be
    # card-bound for the lower bound to hold: on an H100 80GB HBM3 at 700 W,
    # --train_bn_stats 1 at the tool's default batch of 8 ran at 67 % of its
    # trace's rate (11.27 steps/s, 59.50 device ms a step), --freeze_early 1 at
    # 16 at 81 % (17.79 steps/s, 45.57 device ms): the host's ~56 ms a step
    *((f"e2e_{mode}", "bench_e2e_step", ("--batch_size", str(2 * E2E["B"]), *flags,
                                         *BENCH_MODE_ROUNDS, "--profile_dir",
                                         os.path.join(REPO, "build", f"chip_smoke_bench_{mode}")))
      for mode, flags in (("train_bn_stats", ("--train_bn_stats", "1")),
                          ("freeze_early", ("--freeze_early", "1")), ("f32", ("--f32",)))),
    ("loader", "bench_loader", ()),
    ("loader_metadata", "bench_loader", ("--metadata", "20000")),
    ("loader_vlen", "bench_loader", ("--vlen_files", "2000")),
)
# steps of a bench_train_step run: 3 warm-up, then BENCH_ROUNDS (2 rounds of 10)
BENCH_TRAIN_STEPS = 3 + 2 * 10
# launches per step: --fused 1 as the train and cotrain phases', --fused 0 the
# attention kernels alone (the loss from the plain logits)
BENCH_PLAIN_LAUNCHES = dict(STEP_LAUNCHES, milnce_fwd=0, milnce_dv=0, milnce_dt=0)
BENCH_PLAIN_ROUTES = dict(STEP_ROUTES, **{k: {"wgmma": 0, "f32": 0}
                                          for k in ("milnce_fwd", "milnce_dv", "milnce_dt")})
BENCH_LAUNCHES = {"train_stage1_fused": (STEP_LAUNCHES, STEP_ROUTES, "train_steps_per_s"),
                  "train_stage2_fused": (COTRAIN_STEP_LAUNCHES, COTRAIN_STEP_ROUTES,
                                         "cotrain_steps_per_s"),
                  "train_stage1_plain": (BENCH_PLAIN_LAUNCHES, BENCH_PLAIN_ROUTES,
                                         "train_steps_per_s")}
# a tool's steps/s against 1000 / the step-time child's device ms a step at the
# same shape: the train step's at most this (the eager step is host-bound, so
# any fenced rate lies well under it); the e2e step's (card-bound, ~3 % idle)
# within these
BENCH_RATE_MAX = 1.05
BENCH_E2E_RATE = (0.8, 1.05)


def bench_tool_child(module, go, argv) -> int:
    """A child of phase_bench_tools (``module``: a tool of
    temporalalignnet_torch.tools) or the --seq_len 128 train CLI
    (``start_cli_t128``): ``python -m <module> <argv>`` once its go file
    exists (imports made before); the wrappers' launch counts, set to 0 just
    before the module runs, follow as a JSON line."""
    import importlib
    import runpy

    # the imports before the release (runpy runs the tool's module itself)
    for name in ("torch", "torch._dynamo", "temporalalignnet_torch.train.train_step",
                 "temporalalignnet_torch.train.end2end", "temporalalignnet_torch.train.cli",
                 "temporalalignnet_torch.data.prefetch", "temporalalignnet_torch.utils.profiling",
                 "temporalalignnet_torch.tools.convert_captions"):
        importlib.import_module(name)
    if not module.endswith("bench_loader"):  # the card's context; the loader runs on the host
        sys.modules["torch"].zeros(1, device="cuda")
    wait_for_release(go)
    reset_counts()
    sys.argv = [module, *argv]
    runpy.run_module(module, run_name="__main__", alter_sys=True)
    emit({"bench_counts": read_counts(), "bench_routes": read_routes()})
    # the tool has closed what it wrote; skip the interpreter's and the CUDA
    # context's teardown, which the parent would wait for before the next run
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def start_bench_tools():
    """Every BENCH_RUNS child, started now; each waits for its release."""
    return {name: start_gated("--bench-tool", f"temporalalignnet_torch.tools.{tool}", argv,
                              name=name)
            for name, tool, argv in BENCH_RUNS}


def bench_loader_lines(text):
    """The loader bench's printed lines, parsed."""
    import re

    num = lambda x: float(x.replace(",", ""))
    out = {"workers": {}, "stores": {}}
    for line in text.splitlines():
        if m := re.match(r"workers=(\d+): ([\d,.]+) samples/s .* feeding ([\d,.]+) samples/s "
                         r"needs ~([\d.]+)x", line):
            w, sps, target = int(m[1]), num(m[2]), num(m[3])
            out["target_samples_per_s"] = target
            out["workers"][w] = {"samples_per_s": sps, "times_this_rate": num(m[4]),
                                 "cores_at_this_rate": w * target / sps}
        elif m := re.match(r"(.+): init ([\d,.]+) s, peak RSS ([\d,.]+) MB \(\+(-?[\d,.]+) MB "
                           r"over the ([\d,.]+) MB", line):
            out["stores"][m[1]] = {"init_s": num(m[2]), "peak_rss_mb": num(m[3]),
                                   "rss_over_baseline_mb": num(m[4]),
                                   "import_baseline_mb": num(m[5])}
        elif m := re.match(r"build_vlen_table: (\d+) files in ([\d,.]+) s \(([\d.]+) ms/file",
                           line):
            out["vlen_files"], out["vlen_s"], out["ms_per_file"] = int(m[1]), num(m[2]), num(m[3])
        elif m := re.match(r"corpus: (\d+) samples", line):
            out["samples"] = int(m[1])
        elif m := re.match(r"convert_captions .*: ([\d,.]+) s", line):
            out["convert_s"] = num(m[1])
    return {k: v for k, v in out.items() if v != {}}


def trace_device_events(trace_dir):
    """(the trace file a bench run wrote under ``trace_dir``, {category:
    events} of its device events: kernels, copies and sets, and their
    summed device ms)."""
    files = [f for f in os.listdir(trace_dir) if f.startswith("trace_") and f.endswith(".json")]
    check(len(files) == 1, f"one trace file under {trace_dir}, found {files}")
    with open(os.path.join(trace_dir, files[0])) as f:
        events = json.load(f).get("traceEvents", [])
    cats, busy_ms = {}, 0.0
    for e in events:
        cat = e.get("cat", "")
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            cats[cat] = cats.get(cat, 0) + 1
            busy_ms += e.get("dur", 0) / 1e3
    return files[0], cats, busy_ms


def phase_bench_tools(children, step_lines, card):
    """The bench tools' runs (BENCH_RUNS), released one after another, each
    checked; returns the launches per step of the --stage 1 --fused 1 run."""
    device_ms = {l["metric"]: l.get("device_busy_ms_per_step") for l in step_lines
                 if "metric" in l}
    for _, tool, argv in BENCH_RUNS:
        if "--profile_dir" in argv:
            shutil.rmtree(argv[-1], ignore_errors=True)
    per_step = None
    for name, tool, argv in BENCH_RUNS:
        out, seconds = release(children[name], f"{tool} {' '.join(argv)}", timeout=600)
        line = {"phase": "bench_tool", "run": name, "card": card,
                "command": f"python -m temporalalignnet_torch.tools.{tool} {' '.join(argv)}",
                "process_seconds": seconds}
        if tool == "bench_loader":
            line["output"] = bench_loader_lines(out)
            emit(line)
            if name == "loader":
                check(len(line["output"]["workers"]) == 3, f"loader workers: {out}")
                check(line["output"]["target_samples_per_s"] == round(
                    58.67 * TRAIN["B"]), "the loader bench's --target_sps default")
            elif name == "loader_metadata":
                check(len(line["output"]["stores"]) == 2, f"loader stores: {out}")
            else:
                check(line["output"]["vlen_files"] == 2000, f"vlen files: {out}")
            continue
        jsons = [json.loads(l) for l in out.splitlines() if l.startswith("{")]
        result = next(j for j in jsons if "metric" in j)
        line["output"] = result
        if tool == "bench_train_step":
            counts = next(j for j in jsons if "bench_counts" in j)
            launches, routes, child = BENCH_LAUNCHES[name]
            d_ms = device_ms.get(child)
            line["check"] = {
                "steps": BENCH_TRAIN_STEPS, "launches": counts["bench_counts"],
                "launches_per_step": {k: v / BENCH_TRAIN_STEPS
                                      for k, v in counts["bench_counts"].items()},
                "routes": counts["bench_routes"], "step_time_child": child,
                "child_device_ms_per_step": d_ms,
                "rate_max": None if d_ms is None else BENCH_RATE_MAX * 1e3 / d_ms}
            emit(line)
            check(counts["bench_counts"] == {k: v * BENCH_TRAIN_STEPS
                                             for k, v in launches.items()},
                  f"{name} launched {counts['bench_counts']}, expected {launches} a step")
            check(counts["bench_routes"] == {k: {r: n * BENCH_TRAIN_STEPS for r, n in v.items()}
                                             for k, v in routes.items()},
                  f"{name} routes {counts['bench_routes']}")
            check(d_ms is not None, f"{child}: no device ms a step to bound {name}")
            check(result["value"] <= line["check"]["rate_max"],
                  f"{name}: {result['value']} steps/s over {line['check']['rate_max']}")
            if name == "train_stage1_fused":
                per_step = {k: v // BENCH_TRAIN_STEPS for k, v in counts["bench_counts"].items()}
        else:  # the e2e step, which launches none of the port's kernels
            counts = next(j for j in jsons if "bench_counts" in j)["bench_counts"]
            lo, hi = BENCH_E2E_RATE
            trace, events, busy_ms = trace_device_events(argv[-1])
            # e2e_b16: the e2e step-time child's step; the other modes: their own trace's
            d_ms = (device_ms.get("e2e_steps_per_s") if name == "e2e_b16"
                    else busy_ms / BENCH_TRACE_STEPS)
            bounded = result["dtype"] == "bfloat16"  # --f32: finite and printed
            line["check"] = {"device_ms_per_step": d_ms,
                             "device_ms_from": "e2e child" if name == "e2e_b16" else "trace",
                             "trace_device_ms_per_step": busy_ms / BENCH_TRACE_STEPS,
                             "rate_range": [lo * 1e3 / d_ms, hi * 1e3 / d_ms]
                             if d_ms and bounded else None,
                             "trace": trace, "device_events": events, "launches": counts}
            emit(line)
            check(not any(counts.values()), f"{name} launched the port's kernels: {counts}")
            check(bool(d_ms), f"{name}: no device ms a step")
            check(not bounded or lo * 1e3 / d_ms <= result["steps_per_sec"] <= hi * 1e3 / d_ms,
                  f"{name} at {result['steps_per_sec']} steps/s, {d_ms} device ms a step")
        check(np.isfinite(result["value"]) and result["value"] > 0, f"{name}: {result}")
    return per_step


def share_bytecode_cache() -> None:
    """Keep Python's bytecode under build/pycache, for this process and the
    ones it starts (the CLIs, the step-time runs).  Where the interpreter
    keeps no bytecode of its packages (a read-only or empty cache), each new
    process would compile torch's sources again before its first line."""
    prefix = os.path.join(REPO, "build", "pycache")
    sys.pycache_prefix = prefix
    os.environ["PYTHONPYCACHEPREFIX"] = prefix


def main(argv) -> int:
    share_bytecode_cache()
    if argv[:1] == ["--bench-tool"]:  # a child of phase_bench_tools, before any CUDA call
        return bench_tool_child(argv[1], argv[2], argv[3:])
    if argv[:1] == ["--spare"]:  # a spare child (make_spares)
        return spare_child(argv[2])
    if argv[:1] == ["--step-view"] and len(argv) > 2:  # the port of another tree
        sys.path.insert(0, os.path.abspath(argv[2]))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU", file=sys.stderr)
        return 2
    try:
        import temporalalignnet_torch  # noqa: F401
    except ImportError as e:  # the script alone, without the port beside it
        print(f"chip_smoke: {e}; run it from the repository's root", file=sys.stderr)
        return 1

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = torch.cuda.get_device_name(0)
    if argv[:1] == ["--dp-rank"]:  # a child of phase_dp_two_ranks
        dp_rank(torch, int(argv[1]), int(argv[2]), argv[3])
        return 0
    if argv[:1] == ["--tp-rank"]:  # a child of phase_tp_two_ranks
        tp_rank(torch, int(argv[1]), int(argv[2]), argv[3])
        return 0
    if argv[:1] == ["--step-view"]:
        step_view(torch, argv[1], card)
        return 0
    if argv[:1] == ["--step-time"]:  # a child of phase_step_times
        step_time(torch, argv[1], card, ready=lambda: wait_for_release(argv[2]))
        return 0
    emit({"python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda, "card": card})
    if argv[:1] == ["--step-times"]:
        # the step-time children alone (those named, else all), no result line
        phase_build()
        phase_step_times(start_step_times(tuple(argv[1:]) or STEP_TIME_CHILDREN + STEP_TIME_MORE))
        print(card_power(), flush=True)
        return 0
    if argv[:1] == ["--kernels-only"]:
        # the kernel phases alone (build, the checks against the plain
        # versions, the kernel rows, the f32 eval forward), no result line
        phase_build()
        phase_kernel_check(torch)
        phase_mha_bwd_check(torch)
        phase_milnce_check(torch)
        phase_times(torch, card)
        phase_train_times(torch, card)
        phase_eval_forward_f32_times(torch, card)
        print(card_power(), flush=True)
        return 0

    seconds = {}

    def timed(fn, *args):
        """fn(*args), its wall seconds kept under its name."""
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[fn.__name__] = time.perf_counter() - t0
        return out

    t_start = time.perf_counter()
    timed(phase_build)
    err_f32, err_bf16 = timed(phase_kernel_check, torch)
    bwd_err = timed(phase_mha_bwd_check, torch)
    milnce_err = timed(phase_milnce_check, torch)
    # the kernel rows' profiler sessions before any of thousands of kernels
    rows = timed(phase_times, torch, card)
    train_rows = timed(phase_train_times, torch, card)
    model, eval_launches = timed(phase_eval, torch)
    timed(phase_eval_forward_times, torch, model, card)
    timed(phase_eval_forward_f32_times, torch, card)
    decoder_launches, decoder_routes = timed(phase_decoder, torch, card)
    make_spares(8)  # for the CLIs up to cotrain_cli's
    eval_files = timed(phase_cli, torch, model)
    files = timed(make_train_files, os.path.join(REPO, "build", "chip_smoke_train"), 96, SEED)
    t128_files = make_train_files(os.path.join(REPO, "build", "chip_smoke_train_t128"),
                                  CLI_T128["videos"], SEED + 40, min_len=128)
    cli_t128 = start_cli_t128(t128_files)  # makes ready beside the train phase
    launches, stage1_state = timed(phase_train, torch, files)
    yc2_files = timed(make_yc2_files, os.path.join(REPO, "build", "chip_smoke_yc2"), SEED + 4)
    # phases of child processes that time nothing run in the background, beside the
    # phases of this process: the train CLI and its evals; the resume runs, then the
    # world-of-one CLIs; later the cotrain CLI and its eval
    torch.cuda.empty_cache()  # this process's cached blocks, for the children
    train_cli = in_background(timed, phase_train_cli, torch, files, eval_files, yc2_files,
                              cli_t128)
    resume = in_background(timed, phase_resume_and_world1, torch, yc2_files)
    t128_launches, f32_launches = timed(phase_train_t128, torch)
    make_spares(16)  # for the CLIs from grouped_dispatch's to the e2e CLI's
    cotrain_launches = timed(phase_cotrain, torch, files, stage1_state)
    stage1_ckpt, retrieval_cli, (t128_cli_launches, t128_cli_routes) = joined(
        train_cli, "phase_train_cli")
    retrieval_metrics, retrieval_launches = timed(phase_retrieval, torch, stage1_ckpt, yc2_files)
    timed(phase_retrieval_cli, retrieval_cli, retrieval_metrics)
    cotrain_cli = in_background(timed, phase_cotrain_cli, torch, files, stage1_ckpt, eval_files)
    export_cli = start_export_cli()  # untimed work, beside cotrain_cli's children
    try:
        export_launches = timed(phase_serving_export, torch, card, stage1_ckpt, export_cli)
    finally:
        stop([export_cli[0]])
    # slice 9: the two ranks run beside the phases up to dp_two_ranks; slice 10: the
    # tensor-parallel ranks beside those from make_bert_dir to tp_two_ranks (no timing)
    dp_ranks = timed(start_dp_two_ranks, torch, stage1_state, stage1_ckpt, eval_files,
                     yc2_files)
    tp_ranks = None
    try:
        grouped_launches = timed(phase_grouped_dispatch, torch, files, stage1_state)
        timed(phase_cache_videos, torch, files)
        # the --profile_dir child (untimed work) runs beside the next three phases
        profile_child = start_profile_dir(files)
        try:
            remat_launches = timed(phase_remat, torch)
            milnce_path, milnce_launches = timed(phase_milnce_ckpt, torch, files)
            timed(phase_baseline, torch, eval_files, yc2_files, milnce_path)
            timed(phase_profile_dir, profile_child)
        finally:
            stop([profile_child[0]])
        tp_ranks = timed(start_tp_two_ranks, torch, stage1_state)
        # the BERT CLIs (untimed) run beside the ranks
        bert_path = timed(make_bert_dir, torch, os.path.join(REPO, "build", "chip_smoke_bert"))
        bert_cli = start_bert_cli(files, bert_path, eval_files, yc2_files)
        dp_launches = timed(phase_dp_two_ranks, dp_ranks, eval_files, retrieval_cli)
        timed(phase_s3d, torch, card)
        e2e_launches = timed(phase_e2e_step, torch)
        tp_launches = timed(phase_tp_two_ranks, tp_ranks)
    finally:
        stop(dp_ranks[0])
        if tp_ranks is not None:
            stop(tp_ranks[0])
    # slice 11's children and the step-time ones make ready beside the last phases
    bench_children = start_bench_tools()
    step_children = start_step_times()
    try:
        htm_aa_launches, htm_aa_routes = timed(phase_htm_aa_pipeline, torch, card)
        bert_launches = timed(phase_bert, torch, files, bert_path)
        timed(finish_bert_cli, bert_cli)
        timed(phase_clip_baseline, torch)
        tower_launches = timed(phase_tower_extract, torch)
        punct_launches = timed(phase_punctuate, torch, card)
        dp_graph = joined(resume, "phase_resume_and_world1")
        joined(cotrain_cli, "phase_cotrain_cli")
        step_lines = timed(phase_step_times, step_children)
        bench_launches = timed(phase_bench_tools, bench_children, step_lines, card)
    finally:
        stop([proc for proc, _ in [*bench_children.values(), *step_children.values()]])
    emit({"phase_seconds": seconds, "total_seconds": time.perf_counter() - t_start,
          "in_the_background": ["phase_train_cli", "phase_resume_and_world1",
                                "phase_cotrain_cli"]})

    print(card_power(), flush=True)
    fwd_rows = {tuple(r["shape"]): r for r in rows if r["dtype"] == "bfloat16"}
    f32_rows = {tuple(r["shape"]): r for r in rows if r["dtype"] == "float32"}
    timed, glob = fwd_rows[MHA_BWD_SHAPES[1]], fwd_rows[KERNEL_SHAPES[3]]
    yc2_timed = [{"shape": list(sh), "route": fwd_rows[sh]["route"],
                  **{k: fwd_rows[sh][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                  "bound_by")}} for sh in YC2_TIMED_SHAPES]
    fields = ("ms", "timing", "plain_ms", "bound_ms", "bound_by", "library_ms")
    pallas = "temporalalignnet_tpu/ops/pallas_milnce.py"
    # launches: slice 2's path (TRAIN_STEPS Stage-1 train steps); beside it
    # slice 3's (COTRAIN_STEPS cotrain steps), and mha_fwd's on slice 1's
    # path (the eval phase) and on slice 4's (the retrieval phase)
    entries = [
        dict(name="mha_fwd", source="temporalalignnet_torch/csrc/mha_fwd.cu",
             cuda_kernels=["mha_fwd_wgmma_kernel", "mha_fwd_merge_kernel"],
             replaces="temporalalignnet_tpu/ops/pallas_attention.py:31 (_mha_kernel)",
             kernel_route="short (wgmma, TMA, warp specialised), bf16 S <= 128",
             launches_by_route=launches["routes"]["mha_fwd"],
             earlier_ms=timed["v1_ms"], earlier_version="v1 (mma.sync)",
             launches=launches["mha_fwd"], launches_eval_path=eval_launches,
             launches_cotrain_path=cotrain_launches["mha_fwd"],
             launches_by_route_cotrain=cotrain_launches["routes"]["mha_fwd"],
             launches_retrieval_path=retrieval_launches["launches"],
             launches_by_route_retrieval=retrieval_launches["by_route"],
             retrieval_forward_calls=retrieval_launches["forward_calls"],
             retrieval_shapes=yc2_timed,
             max_abs_err=err_bf16, max_err_f32=err_f32, max_err_bf16=err_bf16,
             shape=timed["shape"], **{k: timed[k] for k in fields},
             long_route={"shape": glob["shape"], "ms": glob["ms"], "earlier_ms": glob["v1_ms"],
                         "library_ms": glob["library_ms"], "bound_ms": glob["bound_ms"]}),
        dict(name="mha_bwd", source="temporalalignnet_torch/csrc/mha_bwd.cu",
             cuda_kernels=["mha_bwd_fused_kernel"],
             replaces="temporalalignnet_tpu/ops/pallas_attention.py:75 (_mha_bwd_kernel)",
             kernel_route="fused (wgmma, TMA), bf16 S <= 128",
             launches_by_route=launches["routes"]["mha_bwd"],
             launches=launches["mha_bwd"], max_abs_err=bwd_err["bfloat16"],
             launches_cotrain_path=cotrain_launches["mha_bwd"],
             launches_by_route_cotrain=cotrain_launches["routes"]["mha_bwd"],
             max_err_f32=bwd_err["float32"], max_err_bf16=bwd_err["bfloat16"],
             shape=train_rows[("mha_bwd", 80)]["shape"],
             **{k: train_rows[("mha_bwd", 80)][k] for k in fields}),
    ]
    replaces = {
        "milnce_fwd": f"{pallas}:82 (_milnce_fwd_kernel), {pallas}:224 (_milnce_fwd_tiled_kernel)",
        "milnce_dv": f"{pallas}:154 (_milnce_bwd_kernel), {pallas}:294 (_milnce_dv_kernel)",
        "milnce_dt": f"{pallas}:154 (_milnce_bwd_kernel), {pallas}:334 (_milnce_dt_kernel)",
    }
    for name, rep in replaces.items():
        row = train_rows[(name, 6, TRAIN["B"] * TRAIN["T"], TRAIN["B"] * TRAIN["N"], False)]
        earlier = "v1" if name == "milnce_fwd" else "v2"
        lse_err = ({"max_abs_err_lse_bf16": milnce_err[("milnce_fwd_lse", "bfloat16")]}
                   if name == "milnce_fwd" else {})
        entries.append(dict(**lse_err,
            name=name, source="temporalalignnet_torch/csrc/milnce_wgmma.cu", replaces=rep,
            cuda_kernels=(["milnce_fwd_wgmma_kernel", "milnce_colmerge_kernel"]
                          if name == "milnce_fwd" else
                          ["milnce_grad_wgmma_kernel", "milnce_reduce_kernel"]),
            kernel_route="wgmma (TMA, warp specialised), bf16",
            launches_by_route=launches["routes"][name], earlier_ms=row[earlier + "_ms"],
            earlier_version=f"{earlier} (mma.sync)",
            launches=launches[name], max_abs_err=milnce_err[(name, "bfloat16")],
            launches_cotrain_path=cotrain_launches[name],
            launches_by_route_cotrain=cotrain_launches["routes"][name],
            max_err_f32=milnce_err[(name, "float32")],
            max_err_bf16=milnce_err[(name, "bfloat16")],
            shape=[row["S"], row["R"], row["K"], row["C"]],
            library_note="no single PyTorch call computes the masked MIL-NCE logsumexps",
            **{k: row[k] for k in fields}))
    # slice 5's paths: the 2 remat steps of phase_remat, the two 3-step
    # --milnce_ckpt train CLI runs (init, cotrain)
    for e in entries:
        e["launches_remat_path"] = remat_launches[e["name"]]
        e["launches_milnce_ckpt_path"] = {m: n[e["name"]] for m, n in milnce_launches.items()}
        # slice 6: one full-width e2e step; generate_htm_aa over HTM_AA's videos
        e["launches_e2e_path"] = e2e_launches[e["name"]]
        e["launches_htm_aa_path"] = htm_aa_launches[e["name"]]
        # slice 7: BERT_STEPS Stage-1 steps and BERT_STEPS cotrain steps of the
        # BERT TAN; one bf16 call of each vision encoder
        e["launches_bert_path"] = bert_launches["init"][e["name"]]
        e["launches_bert_cotrain_path"] = bert_launches["cotrain"][e["name"]]
        e["launches_clip_path"] = tower_launches["clip"][e["name"]]
        e["launches_timesformer_path"] = tower_launches["timesformer"][e["name"]]
        # slice 8: one call of the loaded bf16 serving program; the kernels
        # that ran on the device in one group of GROUP_K replayed Stage-1
        # steps, and cotrain steps (profiled), and the wrappers' count at capture
        e["launches_export_path"] = export_launches[e["name"]]
        # (slice 12: also at --backprop_freq 3 and 2 and --skip_nonfinite 1)
        for case in grouped_launches:
            key = {"stage1": "grouped", "cotrain": "grouped_cotrain"}.get(case,
                                                                        f"grouped_{case}")
            e[f"launches_{key}_path"] = grouped_launches[case]["replayed"][e["name"]]
            e[f"launches_{key}_per_step_at_capture"] = \
                grouped_launches[case]["at_capture"][e["name"]]
    for e in entries:  # slice 9: each rank's launches over its bf16 Stage-1 and cotrain steps
        e["launches_dp_path"] = {r: n[e["name"]] for r, n in dp_launches.items()}
    # slice 10: the punctuator's pipeline over PUNCT's videos; each tensor-parallel rank
    # over its bf16 Stage-1 and cotrain steps (2 each), and per step; in the trace of the
    # world-of-one CLI with --steps_per_dispatch GROUP_K (phase_dp_world1), the kernel's
    # launches per step, NCCL's beside (milnce_grad_wgmma: milnce_dv's and milnce_dt's)
    for e in entries:
        e["launches_punct_path"] = punct_launches[e["name"]]
        e["launches_tp_path"] = {r: {"bf16_stage1_and_cotrain_steps": n["steps"][e["name"]],
                                     "per_stage1_step": n["stage1_step"][e["name"]],
                                     "per_cotrain_step": n["cotrain_step"][e["name"]]}
                                 for r, n in tp_launches.items()}
        symbol = DP_GRAPH_SYMBOLS[e["name"]]
        e["launches_dp_graph_path"] = {
            "trace_kernel": symbol, "per_step": dp_graph["port_kernels_per_step"][symbol],
            "nccl_per_step": dp_graph["nccl_kernels"] / dp_graph["steps"],
            "steps": dp_graph["steps"], "replayed_steps": dp_graph["replayed_steps"]}
        # slice 11: per step of the train-step bench tool, --stage 1 --fused 1
        e["launches_bench_path"] = bench_launches[e["name"]]
        # slice 13: one bf16 forward and one backward of the decoder stack; per
        # step of the train CLI at --seq_len 128
        e["launches_decoder_path"] = decoder_launches[e["name"]]
        e["launches_cli_t128_path"] = t128_cli_launches[e["name"]]
    entries[0]["launches_by_route_punct"] = punct_launches["routes"]["mha_fwd"]
    entries[0]["punct_shape"] = {"shape": list(PUNCT_SHAPE), **{k: f32_rows[PUNCT_SHAPE][k] for k in (
        "dtype", "route", "masked", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
        "peak_flops_per_s")}}
    # the f32 routes (split TF32) at their timed shapes, with both bounds
    f32_keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "bound_ms_f32_cores")
    entries[0]["f32_route"] = {
        "source": "temporalalignnet_torch/csrc/mha_fwd_f32.cu",
        "shapes": [{"shape": list(sh), **{k: f32_rows[sh][k] for k in f32_keys}}
                   for sh in F32_TIMED_SHAPES]}
    entries[1]["f32_route"] = {
        "source": "temporalalignnet_torch/csrc/mha_bwd_f32.cu",
        "shapes": [{"shape": list(sh), **{k: train_rows[("mha_bwd", "f32", sh[2])][k]
                                          for k in f32_keys}} for sh in MHA_BWD_SHAPES[:2]]}
    entries[0]["tp_shapes"] = [{"shape": list(sh), **{k: fwd_rows[sh][k] for k in (
        "route", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}} for sh in TP_SHAPES]
    entries[1]["tp_shapes"] = [{"shape": train_rows[("mha_bwd", "tp", sh[2])]["shape"], **{
        k: train_rows[("mha_bwd", "tp", sh[2])][k] for k in ("ms", "plain_ms", "library_ms",
                                                             "bound_ms", "bound_by")}}
        for sh in TP_SHAPES]
    entries[0]["launches_by_route_htm_aa"] = htm_aa_routes
    for e, part in zip(entries[:2], ("forward", "backward")):
        e["launches_by_route_decoder"] = {k: r[e["name"]] for k, r in decoder_routes.items()
                                          if k.endswith(part)}
        e["launches_by_route_cli_t128"] = t128_cli_routes[e["name"]]
    for e in entries[:2]:
        e["launches_by_route_bert"] = bert_launches["init"]["routes"][e["name"]]
    entries[0]["tower_shapes"] = [
        {"shape": list(sh), **{k: fwd_rows[sh][k] for k in ("route", "masked", "ms", "plain_ms",
                                                            "library_ms", "bound_ms", "bound_by")}}
        for sh in TOWER_SHAPES]
    bert_bwd = train_rows[("mha_bwd", BERT_SHAPE[2])]
    entries[1]["bert_shape"] = {"shape": bert_bwd["shape"],
                                **{k: bert_bwd[k] for k in ("ms", "plain_ms", "library_ms",
                                                            "bound_ms", "bound_by")}}
    # the kernels redesigned since: mha_bwd's long route (on the T = 128 Stage-1 path)
    # and the f32 MIL-NCE kernels (on the f32 Stage-1 path)
    long_rows = [train_rows[("mha_bwd", sh[2])] for sh in MHA_BWD_LONG_TIMED_SHAPES]
    entries.append(dict(
        name="mha_bwd_long", source="temporalalignnet_torch/csrc/mha_bwd.cu",
        cuda_kernels=["mha_bwd_long_dq_kernel", "mha_bwd_long_dkdv_kernel"],
        replaces="temporalalignnet_tpu/ops/pallas_attention.py:75 (_mha_bwd_kernel)",
        kernel_route="long (wgmma, TMA, producer warp), bf16 S > 128",
        launches=t128_launches["routes"]["mha_bwd"]["long"], steps=T128_STEPS,
        launches_by_route=t128_launches["routes"]["mha_bwd"], max_abs_err=bwd_err["long"],
        launches_cli_t128_path=t128_cli_routes["mha_bwd"]["long"],
        shape=long_rows[0]["shape"], **{k: long_rows[0][k] for k in fields},
        shapes=[{"shape": r["shape"], "kernels_ms": r["kernels_ms"],
                 **{k: r[k] for k in fields}} for r in long_rows]))
    for name, rep in replaces.items():
        rows = {text: train_rows[(name, "f32", 6, TRAIN["B"] * TRAIN["T"], TRAIN["B"] * TRAIN["N"],
                                  text == "shared")] for text in ("per-layer", "shared")}
        row = rows["per-layer"]
        fwd = name == "milnce_fwd"
        # the SIMT forward it replaced is deleted; its times are in PERF.md section 6
        fwd_extra = dict(max_lse_err=milnce_err[("milnce_fwd_lse_err", "float32")],
                         earlier_version="SIMT milnce_fwd_kernel<float> (f32 FMAs; deleted)"
                         ) if fwd else {}
        entries.append(dict(
            name=f"{name}_f32", **fwd_extra,
            source="temporalalignnet_torch/csrc/" + ("milnce_fwd.cu" if fwd else
                                                     "milnce_grad_f32.cu"),
            cuda_kernels=(["milnce_fwd_f32_kernel", "milnce_colmerge_kernel"] if fwd else
                          ["milnce_grad_f32_kernel", "milnce_reduce_f32_kernel"]), replaces=rep,
            kernel_route="f32 (split TF32 on mma.sync), f32 features",
            launches=f32_launches["routes"][name]["f32"], steps=2,
            launches_by_route=f32_launches["routes"][name],
            max_abs_err=milnce_err[(name, "float32")],
            shape=[row["S"], row["R"], row["K"], row["C"]],
            library_note="no single PyTorch call computes the masked MIL-NCE logsumexps",
            **{k: row[k] for k in fields}, bound_ms_f32_cores=row["bound_ms_f32_cores"],
            shared_text={k: rows["shared"][k] for k in fields + ("bound_ms_f32_cores",)}))
    emit({"kernels": [dict(route="cuda", **e) for e in entries]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": card,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        code = main(sys.argv[1:])
    finally:
        stop(STARTED)
    sys.exit(code)
