"""Zero-shot evaluation of a TAN checkpoint (temporalalignnet_tpu/eval/cli.py;
reference eval/eval_zeroshot_align.py:255 and eval_zeroshot_retrieval.py:259):
HTM-Align alignment, or YouCook2 text->video retrieval on the validation split.

  python -m temporalalignnet_torch.eval --task align \\
      --ckpt model.pth.tar --features <dir> --anno htm_align.json --vocab s3d_dict.npy
  python -m temporalalignnet_torch.eval --task retrieval \\
      --ckpt model.pth.tar --features <yc2 dir> \\
      --anno youcookii_annotations_trainval.json --vocab s3d_dict.npy

Runs on ``--device cuda`` (the default) in bf16, or in f32 with ``--f32``;
``--device cpu`` runs the plain PyTorch path in f32.  On the card every
attention goes through the Hopper kernel.  Prints one JSON line of metrics.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("temporalalignnet_torch zero-shot eval")
    p.add_argument("--task", required=True, choices=["align", "retrieval"])
    p.add_argument("--ckpt", required=True, help="reference-format .pth.tar")
    p.add_argument("--features", required=True)
    p.add_argument("--anno", required=True)
    p.add_argument("--vocab", required=True, help="s3d_dict.npy word list")
    p.add_argument("--language_model", default="word2vec", choices=["word2vec"])
    p.add_argument("--method", default="overlap-seq", choices=["overlap-seq", "global"])
    p.add_argument("--global_buckets", type=int, default=3,
                   help="method=global: max padded-length buckets the corpus splits into")
    p.add_argument("--seq_len", type=int, default=64)
    p.add_argument("--max_words", type=int, default=32)
    p.add_argument("--video_embed_dim", type=int, default=1024)
    p.add_argument("--num_encoder_layers", type=int, default=6)
    p.add_argument("--num_joint_layers", type=int, default=6)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--use_alignability_head", type=int, default=1)
    p.add_argument("--batch_windows", type=int, default=256,
                   help="windows per forward call (bounds device memory)")
    p.add_argument("--num_clips", type=int, default=10,
                   help="task=retrieval: staggered windows per clip")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--f32", action="store_true",
                   help="float32 compute on the card (the CPU always runs f32)")
    return p


def main(argv: Optional[list] = None) -> dict:
    args = build_parser().parse_args(argv)

    import torch

    from temporalalignnet_torch.checkpoint import load_reference_checkpoint
    from temporalalignnet_torch.core.config import EvalConfig, ModelConfig, Precision
    from temporalalignnet_torch.data import HTMAlignDataset, YC2RetrievalDataset
    from temporalalignnet_torch.eval.align import AlignmentEvaluator
    from temporalalignnet_torch.eval.retrieval import RetrievalEvaluator
    from temporalalignnet_torch.models.net import TANWithText
    from temporalalignnet_torch.models.word2vec import Word2VecTokenizer

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device here (pass --device cpu for the CPU path)")
    dtype = torch.float32 if args.f32 or device.type == "cpu" else Precision().compute

    tokenizer = Word2VecTokenizer(args.vocab, max_words=args.max_words)
    mcfg = ModelConfig(
        width=args.width,
        heads=args.heads,
        num_encoder_layers=args.num_encoder_layers,
        num_joint_layers=args.num_joint_layers,
        video_embed_dim=args.video_embed_dim,
        language_model=args.language_model,
        use_alignability_head=bool(args.use_alignability_head),
        random_pos_start=False,
    )
    model = TANWithText(mcfg, vocab_size=tokenizer.vocab_size)
    load_reference_checkpoint(args.ckpt, model)
    model.to(device=device, dtype=dtype)

    cfg = EvalConfig(
        seq_len=args.seq_len,
        method=args.method,
        batch_windows=args.batch_windows,
        global_buckets=args.global_buckets,
        num_clips=args.num_clips,
    )
    if args.task == "align":
        ds = HTMAlignDataset(args.features, args.anno, tokenizer, args.max_words)
        out = AlignmentEvaluator(model, cfg).evaluate(list(ds))
    else:
        ds = YC2RetrievalDataset(args.features, args.anno, "val", tokenizer, args.max_words)
        out = RetrievalEvaluator(model, cfg).evaluate(list(ds))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
