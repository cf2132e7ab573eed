#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100): builds every
kernel, holds each against its plain PyTorch version, drives the zero-shot
HTM-Align evaluation, the Stage-1 training and the Stage-2 co-training of
the full-width E6D6 TAN through the kernels, and times them.

    python3 chip_smoke.py

Phases, each printing JSON lines:
  1. build   nvcc builds temporalalignnet_torch/csrc/*.cu into build/torch_kernels/.
  2. kernel  mha_fwd against attention_reference on the card at the shapes the
             eval and train paths give it, ragged key masks, on each route:
             bf16 "short" (S = 64, 72, 80, 37), bf16 "long" (S = 200 and the
             global method's [1, 8, 1088, 64], with key splits), "f32" at all
             of them; the route each call took is checked, and a planted
             fault (padded keys left unmasked) must exceed the bf16 limit.
     kernel_bwd  mha_bwd (dq, dk, dv) against mha_bwd_reference, the plain
             version with the kernel's bf16 roundings, per element
             (GRAD_TOL); planted faults must exceed the limit.  Each route:
             bf16 "fused" at the training shapes and an odd S, bf16 "v2" at
             S = 200, "f32" at all four; the route each call took is checked.
     kernel_milnce  milnce_fwd against milnce_reference (the loss's
             elements) and its four logsumexps against milnce_lse_reference,
             milnce_dv and milnce_dt against milnce_grad_reference, at the
             B = 64 training shape (shared and per-layer text), at the shapes
             where the JAX package takes its column-tiled kernels (B = 128;
             K = 5120) and at a small one whose video gradient splits its
             column stream, f32 and bf16; planted faults as above (for the
             forward: padded columns left unmasked, the last row block left
             out of the column logsumexps); the routes of the three (bf16
             "wgmma", f32 "f32") are checked.
  3. eval    AlignmentEvaluator (overlap-seq and global) on a synthetic corpus,
             random E6D6 weights from a seed, bf16; every encoder forward call
             must launch the kernel 12 times, on the "short" route for
             overlap-seq and the "long" one for global.  Then the same
             evaluation in f32 on the card and on the CPU must agree.
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
     train_cli  python -m temporalalignnet_torch.train --max_steps on those
             files, then python -m temporalalignnet_torch.eval on the
             .pth.tar it wrote.
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
  4. times   per shape mha_fwd's, the plain version's and PyTorch's SDPA
             time beside the card's bound, and the same four times for each
             training kernel at its training shapes (MIL-NCE also at the
             tiled-kernel ones), with the earlier bf16 kernel timed beside
             each redesigned one (mha_fwd and milnce_fwd v1; mha_bwd,
             milnce_dv and milnce_dt v2); then eval-forward windows/s of the
             bench.py workload and train steps/s at B = 64, each with its
             device time and top kernels.
             Device times come from torch.profiler; a time whose sessions
             all recorded no device activity is taken with CUDA events and
             marked "timing": "cuda_events".
The card's name and power limit (nvidia-smi) and a ``kernels`` line come
before the last line, which is {"ok": true, "device": {...}}.  Any failed
phase raises and the script exits non-zero without that line.  Without CUDA
it exits 2 and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

SEED = 0
# f32: the kernel and the reference differ only in the order of the sums
# (f32 FMAs; TF32 off for the reference's matmuls).
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
# column term, padded columns left unmasked).  On an H100 80GB HBM3 the
# kernels read at most 1.2e-5 (f32) and 7.1e-3 (bf16); the faults 0.24 and up.
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# MIL-NCE values v_el, t_el (f32 from the exact products of the features),
# the same per-element measure: the order of the f32 sums only
MILNCE_VALUE_TOL = 1e-4
# f32 eval, card against CPU: canvases are logits / 0.07, summed over windows
CANVAS_TOL = 1e-3
AUC_TOL = 1e-3
# [B, H, S, D]: eval dual encoder; eval joint at N = 8; a long sentence bucket;
# global method (key splits)
KERNEL_SHAPES = [(192, 8, 64, 64), (192, 8, 72, 64), (64, 8, 200, 64), (1, 8, 1088, 64)]
MHA_FWD_CHECK_SHAPES = KERNEL_SHAPES + [(64, 8, 80, 64), (8, 8, 37, 64)]  # + train joint, odd S
BENCH = dict(B=192, T=64, C=1024, N=8, W=32)
TRAIN = dict(B=64, T=64, N=16, W=32)  # the train CLI's defaults
MHA_BWD_SHAPES = [(64, 8, 64, 64), (64, 8, 80, 64), (8, 8, 37, 64)]  # dual, joint, odd S
MHA_BWD_V2_SHAPE = (8, 8, 200, 64)  # bf16 past S = 128 takes the v2 route
# (S, B, T, N, C, shared text): R = B T rows, K = B N columns
MILNCE_SHAPES = [(6, 64, 64, 16, 512, True), (6, 64, 64, 16, 512, False),
                 (6, 128, 64, 16, 512, False), (2, 64, 64, 80, 512, False)]
MILNCE_SPLIT_SHAPE = (2, 8, 64, 16, 512, False)  # milnce_dv in two column splits
TRAIN_STEPS = 10
# expected launches per train step: 6 + 6 encoder blocks; the dual and joint MIL-NCE
STEP_LAUNCHES = {"mha_fwd": 12, "mha_bwd": 12, "milnce_fwd": 2, "milnce_dv": 2,
                 "milnce_dt": 2}
# ... and the routes they take (bf16, S = 64 and 80)
STEP_ROUTES = {"mha_fwd": {"short": 12, "long": 0, "f32": 0},
               "mha_bwd": {"fused": 12, "v2": 0, "f32": 0}, "milnce_fwd": {"wgmma": 2, "f32": 0},
               "milnce_dv": {"wgmma": 2, "f32": 0}, "milnce_dt": {"wgmma": 2, "f32": 0}}
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
# published dense peaks (NVIDIA data sheets): bytes/s, bf16 FLOP/s
CARD_PEAKS = {"H100 PCIe": (2.0e12, 756e12), "H100 NVL": (3.9e12, 835e12),
              "H100": (3.35e12, 989e12)}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def peaks(name: str):
    for key, val in CARD_PEAKS.items():  # most specific first
        if key in name:
            return val
    return CARD_PEAKS["H100"]


def ragged_mask(torch, B, S, gen, device):
    """Key padding [B, S]: random valid lengths; with B > 1 the last row is
    fully padded (the kernel must keep it finite)."""
    lengths = torch.randint(1, S + 1, (B,), generator=gen)
    mask = torch.arange(S)[None] >= lengths[:, None]
    if B > 1:
        mask[-1] = True
    return mask.to(device)


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


def device_profile(torch, fn, reps=20, warmup=3):
    """Run ``fn`` ``reps`` times under torch.profiler.  Returns (device ms per
    call summed over every kernel it launched, {kernel name: ms per call},
    {host op: self CPU ms per call}, timing).  Host issue time is not in the
    first; ``cuda_ms`` measures with that included.

    A profiler session now and then loses device activity (seen on an H100:
    a session of 20 calls that recorded no kernel at all, and sessions that
    recorded some of a kernel's 20 launches).  ``fn`` launches the same
    kernels on every call, so a session is whole only if every kernel's
    count is a multiple of ``reps``.  Any other is run again, up to
    PROFILER_TRIES times; if none is whole, the first value is the
    CUDA-event time of the same calls, the dicts are empty, and timing says
    "cuda_events" instead of "profiler"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(PROFILER_TRIES):
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
        if total > 0 and all(e.count % reps == 0 for e in kernels):
            host_ms = {e.key: e.self_cpu_time_total / 1e3 / reps for e in events
                       if e.device_type == DeviceType.CPU and e.self_cpu_time_total > 0}
            return total, per_kernel, host_ms, "profiler"
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
    for shape in MHA_FWD_CHECK_SHAPES:
        B, H, S, _ = shape
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            for masked in (False, True):
                q, k, v = (torch.randn(shape, generator=gen).to(dev, dtype) for _ in range(3))
                mask = ragged_mask(torch, B, S, gen, dev) if masked else None
                before = dict(mha_fwd.launches_by_route)
                out = mha_fwd(q, k, v, mask)
                taken = route_taken(mha_fwd, before)
                torch.cuda.synchronize()
                ref = attention_reference(q.float(), k.float(), v.float(), mask)
                info = {}
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


def norm_err(a, b) -> float:
    """|a - b| / |b| (Frobenius)."""
    a, b = a.float(), b.float()
    return (a - b).norm().item() / max(b.norm().item(), 1e-30)


def kernel_fns():
    from temporalalignnet_torch.ops import milnce
    from temporalalignnet_torch.ops.mha_bwd import mha_bwd
    from temporalalignnet_torch.ops.mha_fwd import mha_fwd

    return {"mha_fwd": mha_fwd, "mha_bwd": mha_bwd, "milnce_fwd": milnce.milnce_fwd,
            "milnce_dv": milnce.milnce_dv, "milnce_dt": milnce.milnce_dt}


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
    for shape in MHA_BWD_SHAPES + [MHA_BWD_V2_SHAPE]:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            tol = GRAD_TOL[name]
            expected = "f32" if dtype == torch.float32 else "fused" if shape[2] <= 128 else "v2"
            for masked in (False, True):
                q, k, v, g = (torch.randn(shape, generator=gen).to(dev, dtype) for _ in range(4))
                mask = ragged_mask(torch, shape[0], shape[2], gen, dev) if masked else None
                leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
                before = dict(mha_bwd.launches_by_route)
                multihead_attention(*leaves, mask).backward(g)
                taken = route_taken(mha_bwd, before)
                ours = [t.grad for t in leaves]
                plain = mha_bwd_reference(q, k, v, mask, g)
                faults = {"rowsum_dropped": mha_bwd_dropped_rowsum(torch, q, k, v, mask, g)}
                if masked:
                    faults["padded_keys_unmasked"] = mha_bwd_reference(q, k, v, None, g)
                torch.cuda.synchronize()
                errs = [elem_err(a, b) for a, b in zip(ours, plain)]
                abs_errs = [abs_err(a, b) for a, b in zip(ours, plain)]
                fault_errs = {f: max(elem_err(a, b) for a, b in zip(fg, plain))
                              for f, fg in faults.items()}
                worst[name] = max(worst.get(name, 0.0), *abs_errs)
                emit({"phase": "kernel_bwd", "name": "mha_bwd", "route": taken,
                      "shape": list(shape), "dtype": name, "masked": masked,
                      "elem_err_dq_dk_dv": errs,
                      "norm_err_dq_dk_dv": [norm_err(a, b) for a, b in zip(ours, plain)],
                      "abs_err_dq_dk_dv": abs_errs, "rms_dq_dk_dv": [rms(b) for b in plain],
                      "tol": tol, "planted_fault_elem_err": fault_errs})
                check(all(bool(torch.isfinite(t).all()) and t.dtype == dtype for t in ours),
                      f"mha_bwd output at {shape} {name}")
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
        TILE, _wave_splits, fused_milnce_elements, milnce_dt, milnce_dt_v2, milnce_dv,
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
            fwd_faults = milnce_fwd_faults(torch, v, t, pm, cv, lse, mv, inv_temp)
            if "padded_columns_unmasked" in fwd_faults:  # in the forward and the backward
                faults["padded_columns_unmasked"] = milnce_grad_reference(
                    v, t, pm, torch.ones_like(cv), fwd_faults["padded_columns_unmasked"], gv, gt,
                    inv_temp)
            # dv and dt against the plain version from the kernel's own
            # logsumexps (the ones the backward kernels got), the new and the
            # earlier kernels: without the ~1e-6 logsumexp difference, which
            # moves some dsim entries to the neighbouring bf16 value
            same_lse, v1_lse_err = {}, None
            if dtype == torch.bfloat16:
                v1_lse_err = max(elem_err(a, b) for a, b in zip(
                    milnce_fwd_v1(v, t, pm, cv, mv, inv_temp), lse))
                kdv, kdt = milnce_grad_reference(v, t, pm, cv, klse, gv, gt, inv_temp)
                kargs = (v, t, pm, cv, klse, gv, gt, inv_temp)
                same_lse = {"dv": {"milnce_dv": elem_err(ins[0].grad, kdv),
                                   "milnce_dv_v2": elem_err(milnce_dv_v2(*kargs), kdv)},
                            "dt": {"milnce_dt": elem_err(ins[1].grad, kdt),
                                   "milnce_dt_v2": elem_err(milnce_dt_v2(*kargs), kdt)}}
            torch.cuda.synchronize()
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
            dv_splits = _wave_splits(-(-B * T // TILE) * S, -(-B * N // TILE), _build.sm_count(dev))
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
                  "elem_err_fwd_lse_v1": v1_lse_err,
                  "elem_err_dv_vs_plain_from_kernel_lse": same_lse.get("dv", {}),
                  "elem_err_dt_vs_plain_from_kernel_lse": same_lse.get("dt", {})})
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


def make_train_files(root, num_videos, seed):
    """A HowTo100M-format feature dir ({vid}.mp4.npy, 1 fps S3D-width
    features), sentencified captions over the vocab 'w0'..'w66249', and that
    vocab as an s3d_dict-style .npy."""
    rng = np.random.RandomState(seed)
    feats = os.path.join(root, "features")
    os.makedirs(feats, exist_ok=True)
    vocab = os.path.join(root, "vocab.npy")
    np.save(vocab, np.array([f"w{i}" for i in range(66250)]))
    captions = {}
    for i in range(num_videos):
        vlen = int(rng.randint(80, 201))
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


def make_corpus(num_videos, min_len, max_len, seed):
    from temporalalignnet_torch.data.synthetic import synthetic_video_corpus

    corpus = synthetic_video_corpus(np.random.RandomState(seed), num_videos=num_videos,
                                    min_len=min_len, max_len=max_len, feature_dim=1024,
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
    calls = [0]
    inner = model.text_visual_sims

    def counted(*a, **kw):
        calls[0] += 1
        return inner(*a, **kw)

    model.text_visual_sims = counted
    return calls


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

    torch.cuda.synchronize()
    mha_fwd.launches = 0
    calls[0] = 0
    results, routes = {}, {}
    for method, ev in evaluators.items():
        mha_fwd.launches_by_route = dict.fromkeys(mha_fwd.launches_by_route, 0)
        t0 = time.perf_counter()
        per_video = ev.evaluate_corpus(corpus)
        metrics = alignment_metrics(corpus, per_video)
        torch.cuda.synchronize()
        results[method] = (per_video, metrics, time.perf_counter() - t0)
        routes[method] = dict(mha_fwd.launches_by_route)
    launches, forward_calls = mha_fwd.launches, calls[0]

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
    emit({"phase": "eval", "forward_calls": forward_calls, "mha_fwd_launches": launches,
          "mha_fwd_routes": routes})
    check(forward_calls > 0 and launches == 12 * forward_calls,
          f"{launches} kernel launches for {forward_calls} forward calls, expected 12 each")
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
    for method in ("overlap-seq", "global"):
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "temporalalignnet_torch.eval", "--task", "align",
             "--ckpt", ckpt, "--features", feats, "--anno", anno_path, "--vocab", vocab,
             "--method", method],
            cwd=REPO, capture_output=True, text=True, timeout=600,
        )
        check(run.returncode == 0, f"eval CLI {method} failed:\n{run.stderr[-4000:]}")
        cli = json.loads(run.stdout.strip().splitlines()[-1])
        direct = AlignmentEvaluator(model, EvalConfig(method=method)).evaluate(corpus)
        emit({"phase": "cli", "method": method, "cli": cli, "in_process": direct,
              "seconds": time.perf_counter() - t0})
        # same bf16 model and files; only the order of index_add_'s atomic sums differs
        check(abs(cli["Recall"] - direct["Recall"]) * n_aligned <= 1 + 1e-9,
              f"CLI {method} Recall {cli['Recall']} vs {direct['Recall']}")
        check(abs(cli["AUC"] - direct["AUC"]) <= AUC_TOL,
              f"CLI {method} AUC {cli['AUC']} vs {direct['AUC']}")
    return feats, anno_path, vocab


def train_setup(torch, device, fused, cfg_kw=None, state=None, compute=None, cotrain=False,
                train_kw=None):
    """A TANWithText with its optimizer, train step and, for ``cotrain`` (head
    on, agreement targets), its EMA twin; params f32 from the seed (or
    ``state``; for cotrain merged as ``--pretrain`` does, so a Stage-1 state
    without the head loads), compute bf16 on the card unless ``compute``
    says.  Returns (model, optimizer, step, twin or None)."""
    from temporalalignnet_torch.checkpoint import merge_state_dict
    from temporalalignnet_torch.core.config import LossConfig, ModelConfig, TrainConfig
    from temporalalignnet_torch.models.net import TANWithText
    from temporalalignnet_torch.train import EMATwin, Optimizer, make_train_step

    cfg = ModelConfig(fused_milnce=fused, use_alignability_head=cotrain, **(cfg_kw or {}))
    model = TANWithText(cfg, vocab_size=66251)
    model.init_weights(torch.Generator().manual_seed(SEED))
    if state is not None and cotrain:
        model.load_state_dict(merge_state_dict(model.state_dict(), state)[0])
    elif state is not None:
        model.load_state_dict(state)
    model.to(device)
    tcfg = TrainConfig(lr=TRAIN_LR, warmup_iterations=1, total_iterations=1000,
                       **(train_kw or {}))
    opt = Optimizer(model, tcfg)
    twin = EMATwin(model, tcfg) if cotrain else None
    if compute is None:
        compute = torch.bfloat16 if device.type == "cuda" else torch.float32
    loss_kw = dict(model="cotrain", learn_agreement=True, use_alignability_head=True) \
        if cotrain else {}
    step = make_train_step(model, opt, tcfg, LossConfig(use_fused_milnce=fused, **loss_kw),
                           compute_dtype=compute, twin=twin)
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

        def recorded(*args):
            tgt, metrics = self.inner(*args)
            self.calls.append(([a.detach().cpu() if hasattr(a, "detach") else a for a in args],
                               tgt.cpu()))
            return tgt, metrics

        tan_loss.agreement_self_labelling = recorded
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
    run = subprocess.run(
        [sys.executable, "-m", "temporalalignnet_torch.train", "--model", "cotrain",
         "--pretrain", stage1_ckpt, "--feature_dir", feats, "--captions", captions,
         "--vocab", vocab, "--max_steps", "4", "--epochs", "4", "--log_every", "2",
         "--prefix", prefix],
        cwd=REPO, capture_output=True, text=True, timeout=900,
    )
    check(run.returncode == 0, f"cotrain CLI failed:\n{run.stderr[-4000:]}")
    lines = [json.loads(l) for l in run.stdout.splitlines() if l.startswith("{")]
    report = [l for l in run.stdout.splitlines() if l.startswith("[pretrain]")]
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
    run = subprocess.run(
        [sys.executable, "-m", "temporalalignnet_torch.eval", "--task", "align",
         "--ckpt", final["checkpoint"], "--features", e_feats, "--anno", anno,
         "--vocab", e_vocab],
        cwd=REPO, capture_output=True, text=True, timeout=600,
    )
    check(run.returncode == 0, f"eval CLI on the twin checkpoint failed:\n{run.stderr[-4000:]}")
    metrics = json.loads(run.stdout.strip().splitlines()[-1])
    emit({"phase": "cotrain_cli_eval", "metrics": metrics, "seconds": time.perf_counter() - t0})
    check(0.0 <= metrics["Recall"] <= 1.0 and 0.0 <= metrics["AUC"] <= 1.0,
          f"eval of the twin checkpoint: {metrics}")


def phase_train_cli(torch, files, eval_files):
    """The user's entry point, ``python -m temporalalignnet_torch.train`` on the
    card (defaults: E6D6, B = 64, bf16, fused MIL-NCE), then the eval CLI on
    the .pth.tar it wrote."""
    feats, captions, vocab = files
    prefix = os.path.join(REPO, "build", "chip_smoke_train", "exp")
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "temporalalignnet_torch.train", "--feature_dir", feats,
         "--captions", captions, "--vocab", vocab, "--max_steps", "4", "--epochs", "4",
         "--log_every", "2", "--use_alignability_head", "1", "--prefix", prefix],
        cwd=REPO, capture_output=True, text=True, timeout=900,
    )
    check(run.returncode == 0, f"train CLI failed:\n{run.stderr[-4000:]}")
    lines = [json.loads(l) for l in run.stdout.splitlines() if l.startswith("{")]
    final = lines[-1]
    emit({"phase": "train_cli", "log": lines[:-1], "final": final,
          "seconds": time.perf_counter() - t0})
    check(final["final_step"] == 4 and final["loss_finite"], f"train CLI final line {final}")
    check(all(np.isfinite(l["loss"]) for l in lines[:-1]), "train CLI logged a non-finite loss")

    e_feats, anno, e_vocab = eval_files
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "temporalalignnet_torch.eval", "--task", "align",
         "--ckpt", final["checkpoint"], "--features", e_feats, "--anno", anno,
         "--vocab", e_vocab],
        cwd=REPO, capture_output=True, text=True, timeout=600,
    )
    check(run.returncode == 0, f"eval CLI on the trained checkpoint failed:\n{run.stderr[-4000:]}")
    metrics = json.loads(run.stdout.strip().splitlines()[-1])
    emit({"phase": "train_cli_eval", "metrics": metrics, "seconds": time.perf_counter() - t0})
    check(0.0 <= metrics["Recall"] <= 1.0 and 0.0 <= metrics["AUC"] <= 1.0,
          f"eval of the trained checkpoint: {metrics}")
    return final["checkpoint"]


def timed_row(torch, fns, nbytes, flops, bw, peak, **info):
    """Device ms (profiler) and CUDA-event ms of each of ``fns`` {prefix: fn},
    beside the bound max(bytes / bw, flops / peak); for the kernel's own call
    (prefix "") also the device ms of each kernel it launched."""
    row = dict(info)
    for prefix, fn in fns.items():
        row[prefix + "ms"], per_kernel, _, row[prefix + "timing"] = device_profile(torch, fn)
        if not prefix:
            row["kernels_ms"] = {k[:60]: v for k, v in per_kernel.items()}
        row[prefix + "wall_ms"] = cuda_ms(torch, fn)
    t_bytes, t_ops = nbytes / bw, flops / peak
    row.update(bound_ms=max(t_bytes, t_ops) * 1e3,
               bound_by="bytes" if t_bytes >= t_ops else "operations", bytes=nbytes, flops=flops)
    return row


def phase_train_times(torch, card):
    import torch.nn.functional as F

    from temporalalignnet_torch.ops import milnce
    from temporalalignnet_torch.ops.attention import attention_reference
    from temporalalignnet_torch.ops.mha_bwd import mha_bwd, mha_bwd_v2

    dev = torch.device("cuda")
    bw, peak = peaks(card)
    gen = torch.Generator().manual_seed(SEED + 7)
    rows = {}
    for shape in MHA_BWD_SHAPES[:2]:
        Bq, H, S, D = shape
        q, k, v, g = (torch.randn(shape, generator=gen).to(dev, torch.bfloat16) for _ in range(4))
        pad = ragged_mask(torch, Bq, S, gen, dev)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        plain_out = attention_reference(*leaves, pad)
        lib = [t.clone().requires_grad_() for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*lib, attn_mask=~pad[:, None, None, :])
        fns = {"": lambda: mha_bwd(q, k, v, pad, g),
               "v2_": lambda: mha_bwd_v2(q, k, v, pad, g),
               "plain_": lambda: torch.autograd.grad(plain_out, leaves, g, retain_graph=True),
               "library_": lambda: torch.autograd.grad(lib_out, lib, g, retain_graph=True)}
        row = timed_row(torch, fns, 7 * q.numel() * q.element_size() + pad.numel(),
                        10 * Bq * H * S * S * D, bw, peak, shape=list(shape), dtype="bfloat16")
        emit({"phase": "times", "kernel": "mha_bwd", "card": card, **row})
        rows[("mha_bwd", S)] = row

    inv_temp, mv = 1.0 / 0.07, -6.0e4
    for S_, Bm, Tm, Nm, C, shared in MILNCE_SHAPES:
        v, t, pm, cv, gv, gt = milnce_problem(torch, S_, Bm, Tm, Nm, C, shared, gen, dev)
        v, t = v.bfloat16(), t.bfloat16()
        lse = milnce.milnce_fwd(v, t, pm, cv, mv, inv_temp)
        vr, tr = v.clone().requires_grad_(), t.clone().requires_grad_()
        a, b = milnce.milnce_reference(vr, tr, pm, cv, mv, inv_temp)
        plain_loss = (a * gv).sum() + (b * gt).sum()
        R, K = Bm * Tm, Bm * Nm
        feat_bytes = (v.numel() + t.numel()) * 2 + pm.numel() + cv.numel()
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
                          feat_bytes + 2 * lse_bytes + v.numel() * 2, 4 * S_ * R * K * C),
            "milnce_dt": ({"": lambda: milnce.milnce_dt(v, t, pm, cv, lse, gv, gt, inv_temp),
                           "v2_": lambda: milnce.milnce_dt_v2(v, t, pm, cv, lse, gv, gt,
                                                              inv_temp),
                           "plain_": lambda: torch.autograd.grad(plain_loss, [tr],
                                                                 retain_graph=True)},
                          feat_bytes + 2 * lse_bytes + t.numel() * 2, 4 * S_ * R * K * C),
        }
        for name, (fns, nbytes, flops) in cases.items():
            with torch.no_grad() if name == "milnce_fwd" else torch.enable_grad():
                row = timed_row(torch, fns, nbytes, flops, bw, peak, S=S_, R=R, K=K, C=C,
                                text="shared" if shared else "per-layer", dtype="bfloat16",
                                library_ms=None)
            emit({"phase": "times", "kernel": name, "card": card, **row})
            rows[(name, S_, R, K, shared)] = row
    return rows


def phase_step_times(torch, model, card):
    """Eval-forward windows/s, the agreement self-labelling's device time, and
    Stage-1 and cotrain steps/s with their device time.  Run after every
    kernel's timing: on an H100, profiler sessions that followed the train
    step's (thousands of kernels) lost device activity."""
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
    emit({"phase": "times", "metric": "eval_forward_windows_per_s", "card": card,
          "value": B / (fwd_ms / 1e3), "ms_per_call": fwd_ms, "workload": BENCH,
          "model": "E6D6 width 512, bf16, head on", "device_busy_ms_per_call": busy_ms,
          "idle_share": None if busy_ms is None else max(0.0, 1.0 - busy_ms / fwd_ms),
          "top_kernels_ms_per_call": {k[:90]: v for k, v in top}})

    # the agreement self-labelling's and each step's times in a process of
    # its own: on an H100, profiler sessions after a train step's profile
    # (thousands of kernels) lost device activity, and the agreement's
    # after the eval forward's did
    for which in ("agreement", "init", "cotrain"):
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--step-time", which],
                             cwd=REPO, capture_output=True, text=True, timeout=900)
        check(run.returncode == 0, f"step times of {which} failed:\n{run.stderr[-4000:]}")
        emit(json.loads(run.stdout.strip().splitlines()[-1]))


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


def step_time(torch, which, card):
    """One JSON line of times at B = 64: ``which`` 'init' (a Stage-1 train
    step) or 'cotrain' (a Stage-2 one): steps/s with the device time, idle
    share, every kernel's device ms and the top host ops; 'agreement': the
    agreement self-labelling alone at the cotrain step's shapes.  Each also
    counts the call's host-device synchronisations."""
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
        busy_ms, per_kernel, host_ms, timing = device_profile(torch, run)
        emit({"phase": "times", "metric": "agreement_ms", "card": card, "shape": [B, S, T, N],
              "device_ms": busy_ms if timing == "profiler" else None, "timing": timing,
              "wall_ms": cuda_ms(torch, run), "kernels_per_call": len(per_kernel),
              "host_self_ms_under_profiler": sum(host_ms.values()),
              "host_syncs": host_syncs(torch, run),
              "kernels_ms": by_name(per_kernel)})
        return
    cotrain = which == "cotrain"
    _, _, step, _ = train_setup(torch, dev, fused=True, cotrain=cotrain)
    run = lambda: step(batch)
    step_ms = cuda_ms(torch, run, reps=10, warmup=3)
    busy_ms, per_kernel, host_ms, timing = device_profile(torch, run, reps=5, warmup=1)
    busy_ms = busy_ms if timing == "profiler" else None
    top_host = sorted(host_ms.items(), key=lambda kv: -kv[1])[:15]
    model = "E6D6 width 512, word2vec, fused MIL-NCE, bf16 compute, f32 params"
    emit({"phase": "times", "metric": "cotrain_steps_per_s" if cotrain else "train_steps_per_s",
          "card": card, "value": 1e3 / step_ms, "ms_per_step": step_ms, "batch": TRAIN,
          "model": model + (", EMA twin, agreement keep, head on" if cotrain else ""),
          "device_busy_ms_per_step": busy_ms, "timing": timing,
          "idle_share": None if busy_ms is None else max(0.0, 1.0 - busy_ms / step_ms),
          "host_syncs_per_step": host_syncs(torch, run),
          "kernels_ms_per_step": by_name(per_kernel),
          "host_self_ms_per_step_under_profiler": sum(host_ms.values()),
          "top_host_ops_self_ms_per_step": {k[:90]: v for k, v in top_host}})


def phase_times(torch, card):
    import torch.nn.functional as F

    from temporalalignnet_torch.ops.attention import attention_reference
    from temporalalignnet_torch.ops.mha_fwd import mha_fwd, mha_fwd_v1, route

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 2)
    bw, bf16_peak = peaks(card)
    rows = []
    for shape in KERNEL_SHAPES + MHA_BWD_SHAPES[:2]:  # the eval's, then the training's
        Bq, H, S, D = shape
        q, k, v = (torch.randn(shape, generator=gen).to(dev, torch.bfloat16) for _ in range(3))
        pad = ragged_mask(torch, Bq, S, gen, dev)
        keep = ~pad[:, None, None, :]
        fns = {
            "": lambda: mha_fwd(q, k, v, pad),
            "v1_": lambda: mha_fwd_v1(q, k, v, pad),
            "plain_": lambda: attention_reference(q, k, v, pad),
            "library_": lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keep),
        }
        # ms: device time of every kernel the call launched (profiler);
        # wall_ms: CUDA events around back-to-back calls, host issue included
        row = {"shape": list(shape), "dtype": "bfloat16", "route": route(q.dtype, S)}
        for prefix, fn in fns.items():
            row[prefix + "ms"], _, _, row[prefix + "timing"] = device_profile(torch, fn)
            row[prefix + "wall_ms"] = cuda_ms(torch, fn)
        nbytes = 4 * q.numel() * q.element_size() + pad.numel()
        flops = 4 * Bq * H * S * S * D
        t_bytes, t_ops = nbytes / bw, flops / bf16_peak
        row.update(bound_ms=max(t_bytes, t_ops) * 1e3,
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   bytes=nbytes, flops=flops)
        emit({"phase": "times", "kernel": "mha_fwd", "card": card, **row})
        rows.append(row)
    return rows


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU", file=sys.stderr)
        return 2
    import temporalalignnet_torch  # noqa: F401  (fails before any output without the port)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = torch.cuda.get_device_name(0)
    if argv[:1] == ["--step-time"]:  # a child of phase_step_times
        step_time(torch, argv[1], card)
        return 0
    emit({"python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda, "card": card})

    phase_build()
    err_f32, err_bf16 = phase_kernel_check(torch)
    bwd_err = phase_mha_bwd_check(torch)
    milnce_err = phase_milnce_check(torch)
    model, eval_launches = phase_eval(torch)
    eval_files = phase_cli(torch, model)
    files = make_train_files(os.path.join(REPO, "build", "chip_smoke_train"), 96, SEED)
    launches, stage1_state = phase_train(torch, files)
    stage1_ckpt = phase_train_cli(torch, files, eval_files)
    cotrain_launches = phase_cotrain(torch, files, stage1_state)
    phase_cotrain_cli(torch, files, stage1_ckpt, eval_files)
    rows = phase_times(torch, card)
    train_rows = phase_train_times(torch, card)
    phase_step_times(torch, model, card)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    fwd_rows = {tuple(r["shape"]): r for r in rows}
    timed, glob = fwd_rows[MHA_BWD_SHAPES[1]], fwd_rows[KERNEL_SHAPES[3]]
    fields = ("ms", "timing", "plain_ms", "bound_ms", "bound_by", "library_ms")
    pallas = "temporalalignnet_tpu/ops/pallas_milnce.py"
    # launches: slice 2's path (TRAIN_STEPS Stage-1 train steps); beside it
    # this slice's (COTRAIN_STEPS cotrain steps) and mha_fwd's on slice 1's
    # path (the eval phase)
    entries = [
        dict(name="mha_fwd", source="temporalalignnet_torch/csrc/mha_fwd.cu",
             replaces="temporalalignnet_tpu/ops/pallas_attention.py:31 (_mha_kernel)",
             kernel_route="short (wgmma, TMA, warp specialised), bf16 S <= 128",
             launches_by_route=launches["routes"]["mha_fwd"],
             earlier_ms=timed["v1_ms"], earlier_version="v1 (mma.sync)",
             launches=launches["mha_fwd"], launches_eval_path=eval_launches,
             launches_cotrain_path=cotrain_launches["mha_fwd"],
             launches_by_route_cotrain=cotrain_launches["routes"]["mha_fwd"],
             max_abs_err=err_bf16, max_err_f32=err_f32, max_err_bf16=err_bf16,
             shape=timed["shape"], **{k: timed[k] for k in fields},
             long_route={"shape": glob["shape"], "ms": glob["ms"], "earlier_ms": glob["v1_ms"],
                         "library_ms": glob["library_ms"], "bound_ms": glob["bound_ms"]}),
        dict(name="mha_bwd", source="temporalalignnet_torch/csrc/mha_bwd.cu",
             replaces="temporalalignnet_tpu/ops/pallas_attention.py:75 (_mha_bwd_kernel)",
             kernel_route="fused (wgmma, TMA), bf16 S <= 128",
             launches_by_route=launches["routes"]["mha_bwd"],
             earlier_ms=train_rows[("mha_bwd", 80)]["v2_ms"],
             earlier_version="v2 (mma.sync, two kernels)",
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
    emit({"kernels": [dict(route="cuda", **e) for e in entries]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": card,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
