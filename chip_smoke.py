#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100): builds every
kernel, holds each against its plain PyTorch version, drives the zero-shot
HTM-Align evaluation of the full-width E6D6 TAN through the kernels, and
times them.

    python3 chip_smoke.py

Phases, each printing JSON lines:
  1. build   nvcc builds temporalalignnet_torch/csrc/*.cu into build/torch_kernels/.
  2. kernel  mha_fwd against attention_reference on the card at the shapes the
             eval path gives it, ragged key masks, f32 and bf16.
  3. eval    AlignmentEvaluator (overlap-seq and global) on a synthetic corpus,
             random E6D6 weights from a seed, bf16; every encoder forward call
             must launch the kernel 12 times.  Then the same evaluation in f32
             on the card and on the CPU must agree.
     cli     python -m temporalalignnet_torch.eval on a .pth.tar of that model
             and a corpus written to build/chip_smoke_cli/, against the
             in-process evaluator.
  4. times   eval-forward windows/s of the bench.py workload, and per shape the
             kernel's, the plain version's and PyTorch's SDPA time beside the
             card's bound.
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
# f32 eval, card against CPU: canvases are logits / 0.07, summed over windows
CANVAS_TOL = 1e-3
AUC_TOL = 1e-3
# [B, H, S, D]: dual encoder; joint at N = 8; a long sentence bucket; global method
KERNEL_SHAPES = [(192, 8, 64, 64), (192, 8, 72, 64), (64, 8, 200, 64), (1, 8, 1088, 64)]
TIMED_SHAPE = (192, 8, 72, 64)  # the joint encoder of the bench.py workload
BENCH = dict(B=192, T=64, C=1024, N=8, W=32)
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


def device_profile(torch, fn, reps=20, warmup=3):
    """Run ``fn`` ``reps`` times under torch.profiler.  Returns (device ms per
    call summed over every kernel it launched, {kernel name: ms per call}).
    Host issue time is not in it; ``cuda_ms`` measures with that included."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per_kernel = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            per_kernel[e.key] = e.self_device_time_total / 1e3 / reps
    total = sum(per_kernel.values())
    if total <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return total, per_kernel


def phase_build():
    from temporalalignnet_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    ptxas = {n: [l for l in _build.build_log(n).splitlines() if "ptxas info" in l]
             for n in libs}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libs": {n: os.path.relpath(p, REPO) for n, p in libs.items()}, "ptxas": ptxas})


def phase_kernel_check(torch):
    from temporalalignnet_torch.ops.attention import attention_reference
    from temporalalignnet_torch.ops.mha_fwd import mha_fwd

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for shape in KERNEL_SHAPES:
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            for masked in (False, True):
                q, k, v = (torch.randn(shape, generator=gen).to(dev, dtype) for _ in range(3))
                mask = ragged_mask(torch, shape[0], shape[2], gen, dev) if masked else None
                out = mha_fwd(q, k, v, mask)
                torch.cuda.synchronize()
                ref = attention_reference(q.float(), k.float(), v.float(), mask)
                torch.cuda.synchronize()
                err = (out.float() - ref).abs().max().item()
                worst[dtype] = max(worst[dtype], err)
                emit({"phase": "kernel", "name": "mha_fwd", "shape": list(shape),
                      "dtype": str(dtype).split(".")[-1], "masked": masked,
                      "max_abs_err": err, "tol": tol})
                check(bool(torch.isfinite(out).all()), f"mha_fwd non-finite at {shape}")
                check(out.dtype == dtype, "mha_fwd output dtype")
                check(err <= tol, f"mha_fwd {dtype} {shape} masked={masked}: {err} > {tol}")
    q = torch.randn(2, 8, 64, 64, device=dev)
    try:
        mha_fwd(q.transpose(2, 3), q, q)
    except ValueError:
        pass
    else:
        raise RuntimeError("mha_fwd accepted a non-contiguous input")
    return worst[torch.float32], worst[torch.bfloat16]


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
    results = {}
    for method, ev in evaluators.items():
        t0 = time.perf_counter()
        per_video = ev.evaluate_corpus(corpus)
        metrics = alignment_metrics(corpus, per_video)
        torch.cuda.synchronize()
        results[method] = (per_video, metrics, time.perf_counter() - t0)
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
    emit({"phase": "eval", "forward_calls": forward_calls, "mha_fwd_launches": launches})
    check(forward_calls > 0 and launches == 12 * forward_calls,
          f"{launches} kernel launches for {forward_calls} forward calls, expected 12 each")

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


def phase_times(torch, model, card):
    import torch.nn.functional as F

    from temporalalignnet_torch.ops.attention import attention_reference
    from temporalalignnet_torch.ops.mha_fwd import mha_fwd

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
    busy_ms, per_kernel = device_profile(torch, forward)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]
    emit({"phase": "times", "metric": "eval_forward_windows_per_s", "card": card,
          "value": B / (fwd_ms / 1e3), "ms_per_call": fwd_ms, "workload": BENCH,
          "model": "E6D6 width 512, bf16, head on", "device_busy_ms_per_call": busy_ms,
          "idle_share": max(0.0, 1.0 - busy_ms / fwd_ms),
          "top_kernels_ms_per_call": {k[:90]: v for k, v in top}})

    bw, bf16_peak = peaks(card)
    rows = []
    for shape in KERNEL_SHAPES:
        Bq, H, S, D = shape
        q, k, v = (torch.randn(shape, generator=gen).to(dev, torch.bfloat16) for _ in range(3))
        pad = ragged_mask(torch, Bq, S, gen, dev)
        keep = ~pad[:, None, None, :]
        fns = {
            "": lambda: mha_fwd(q, k, v, pad),
            "plain_": lambda: attention_reference(q, k, v, pad),
            "library_": lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keep),
        }
        # ms: device time of every kernel the call launched (profiler);
        # wall_ms: CUDA events around back-to-back calls, host issue included
        row = {"shape": list(shape), "dtype": "bfloat16"}
        for prefix, fn in fns.items():
            row[prefix + "ms"] = device_profile(torch, fn)[0]
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU", file=sys.stderr)
        return 2
    import temporalalignnet_torch  # noqa: F401  (fails before any output without the port)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = torch.cuda.get_device_name(0)
    emit({"python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda, "card": card})

    phase_build()
    err_f32, err_bf16 = phase_kernel_check(torch)
    model, launches = phase_eval(torch)
    phase_cli(torch, model)
    rows = phase_times(torch, model, card)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    timed = next(r for r in rows if tuple(r["shape"]) == TIMED_SHAPE)
    emit({"kernels": [{
        "name": "mha_fwd",
        "route": "cuda",
        "source": "temporalalignnet_torch/csrc/mha_fwd.cu",
        "replaces": "temporalalignnet_tpu/ops/pallas_attention.py:31 (_mha_kernel)",
        "launches": launches,
        "max_abs_err": err_bf16,
        "max_err_f32": err_f32,
        "max_err_bf16": err_bf16,
        "shape": timed["shape"],
        "ms": timed["ms"],
        "plain_ms": timed["plain_ms"],
        "bound_ms": timed["bound_ms"],
        "bound_by": timed["bound_by"],
        "library_ms": timed["library_ms"],
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": card,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
