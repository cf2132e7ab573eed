"""Generate HTM-AA: auto-aligned (vid, text, timestamp) pairs from a trained
TAN (counterpart of temporalalignnet_tpu/tools/generate_htm_aa.py; the
output product the reference releases as a dataset, readme.md:20-28,
end2end/readme.md:1-14).

Per video:
  1. the overlap-seq aligner (``AlignmentEvaluator.evaluate_video``) gives
     the [N, vlen] similarity canvas and each sentence's alignability score;
  2. sentences whose score clears ``threshold`` are kept (by default the
     ``threshold_quantile`` of the corpus's scores);
  3. timestamp = the argmax over time of the stitched similarity row (its
     zeros masked to -6e4).

The csv (vid, text, timestamp, score) is what ``data/clips.py::
HTMClipDataset`` and the end-to-end trainer read.

  python -m temporalalignnet_torch.tools.generate_htm_aa \\
      --ckpt cotrain_...pth.tar --features <dir> --captions sentencified.json \\
      --vocab s3d_dict.npy --out htm_aa_v1.csv

``--ckpt`` is a reference-layout ``.pth.tar`` (plain or twin) or an
experiment directory of the port's trainer (its newest runtime or epoch
checkpoint, ``checkpoint.latest``); an orbax directory of the JAX trainer is
not read.  Runs on ``--device cuda`` (default) in bf16, or f32 with
``--f32``; ``--device cpu`` runs f32.  On the card the attention runs in the
``mha_fwd`` kernel, 12 launches per video.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

MASK_VALUE = -6.0e4


def align_corpus(evaluator, items: Sequence[Dict], threshold: Optional[float] = None,
                 threshold_quantile: Optional[float] = 0.5) -> List[Dict]:
    """``items``: AlignmentEvaluator corpus entries (sentences with 'text').
    Returns [{vid, text, timestamp, score}, ...] of the confident sentences."""
    per_video = [evaluator.evaluate_video(item) for item in items]
    flat = (np.concatenate([res["align_score"] for res in per_video]) if per_video
            else np.zeros(0))
    if threshold is None:
        threshold = float(np.quantile(flat, threshold_quantile)) if flat.size else 0.0
    rows = []
    for item, res in zip(items, per_video):
        masked = np.where(res["sim"] == 0, MASK_VALUE, res["sim"])  # [N, vlen]
        for i, sent in enumerate(item["sentences"]):
            score = float(res["align_score"][i])
            if score < threshold:
                continue
            rows.append({"vid": item["vid"], "text": sent.get("text", ""),
                         "timestamp": float(np.argmax(masked[i])), "score": score})
    return rows


def write_htm_aa_csv(rows: Sequence[Dict], path: str) -> None:
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["vid", "text", "timestamp", "score"])
        w.writeheader()
        for r in rows:
            w.writerow(r)


def captions_to_corpus(captions: Dict, feature_dir: str, tokenizer, max_words: int):
    """Unlabelled caption records -> evaluator corpus items; alignability is
    unknown (0), so every sentence's ASR time drives the active windows.
    Videos without a feature file are skipped."""
    from temporalalignnet_torch.data.htm import load_feature
    from temporalalignnet_torch.data.padding import pad_tokens

    for vid, rec in captions.items():
        try:
            video = load_feature(feature_dir, vid).astype(np.float32)
        except FileNotFoundError:
            continue
        sentences = []
        for text, s, e in zip(rec["text"], rec["start"], rec["end"]):
            ids = np.asarray(tokenizer(str(text))["input_ids"], np.int32).reshape(-1)
            sentences.append({"aligned": 0, "start": float(s), "end": float(e),
                              "text": str(text), "input_ids": pad_tokens(ids, max_words)})
        if sentences:
            yield {"vid": vid, "video": video, "sentences": sentences}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("generate HTM-AA from a trained TAN")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--features", required=True)
    p.add_argument("--captions", required=True)
    p.add_argument("--vocab", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--seq_len", type=int, default=64)
    p.add_argument("--max_words", type=int, default=32)
    p.add_argument("--video_embed_dim", type=int, default=1024)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--num_encoder_layers", type=int, default=6)
    p.add_argument("--num_joint_layers", type=int, default=6)
    p.add_argument("--use_alignability_head", type=int, default=1)
    p.add_argument("--threshold", type=float, default=None)
    p.add_argument("--threshold_quantile", type=float, default=0.5)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--f32", action="store_true",
                   help="float32 compute on the card (the CPU always runs f32)")
    return p


def main(argv: Optional[list] = None) -> List[Dict]:
    args = build_parser().parse_args(argv)

    import torch

    from temporalalignnet_torch.checkpoint import latest, load_reference_checkpoint
    from temporalalignnet_torch.core.config import EvalConfig, ModelConfig, Precision
    from temporalalignnet_torch.data.htm import load_captions
    from temporalalignnet_torch.eval.align import AlignmentEvaluator
    from temporalalignnet_torch.models.net import TANWithText
    from temporalalignnet_torch.models.word2vec import Word2VecTokenizer

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device here (pass --device cpu for the CPU path)")
    dtype = torch.float32 if args.f32 or device.type == "cpu" else Precision().compute

    tokenizer = Word2VecTokenizer(args.vocab, max_words=args.max_words)
    mcfg = ModelConfig(width=args.width, heads=args.heads,
                       num_encoder_layers=args.num_encoder_layers,
                       num_joint_layers=args.num_joint_layers,
                       video_embed_dim=args.video_embed_dim,
                       use_alignability_head=bool(args.use_alignability_head),
                       random_pos_start=False)
    model = TANWithText(mcfg, vocab_size=tokenizer.vocab_size)
    ckpt = args.ckpt
    if os.path.isdir(ckpt):  # an experiment directory of the port's trainer
        found = latest(ckpt)
        if found is None:
            raise SystemExit(f"--ckpt {ckpt}: no checkpoint of the port's trainer in it")
        ckpt = found[1]
    load_reference_checkpoint(ckpt, model)
    model.to(device=device, dtype=dtype)

    corpus = list(captions_to_corpus(load_captions(args.captions), args.features, tokenizer,
                                     args.max_words))
    ev = AlignmentEvaluator(model, EvalConfig(seq_len=args.seq_len))
    rows = align_corpus(ev, corpus, args.threshold, args.threshold_quantile)
    write_htm_aa_csv(rows, args.out)
    print(json.dumps({"videos": len(corpus), "pairs": len(rows), "out": args.out}))
    return rows


if __name__ == "__main__":
    main()
