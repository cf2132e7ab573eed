"""Zero-shot evaluation of a TAN checkpoint (temporalalignnet_tpu/eval/cli.py;
reference eval/eval_zeroshot_align.py:255 and eval_zeroshot_retrieval.py:259):
HTM-Align alignment, or YouCook2 text->video retrieval on the validation split.

  python -m temporalalignnet_torch.eval --task align \\
      --ckpt model.pth.tar --features <dir> --anno htm_align.json --vocab s3d_dict.npy
  python -m temporalalignnet_torch.eval --task retrieval \\
      --ckpt model.pth.tar --features <yc2 dir> \\
      --anno youcookii_annotations_trainval.json --vocab s3d_dict.npy

Without ``--ckpt`` it scores the raw features with ``RawFeatureBaseline``,
the reference's MIL-NCE baseline (eval_zeroshot_align.py:262-291):
``--milnce_ckpt s3d_howto100m.pth`` loads its word2vec text tower and the
1024 -> 512 ``fc``, and ``--baseline_sim`` (dot, the MIL-NCE default, or
cos) sets the similarity.  Without ``--milnce_ckpt`` the baseline has no
projection and a text tower of random weights, as in JAX.

Runs on ``--device cuda`` (the default) in bf16, or in f32 with ``--f32``;
``--device cpu`` runs the plain PyTorch path in f32.  On the card every
attention goes through the Hopper kernel (the baseline runs none).  Prints
one JSON line of metrics.  Flags of the JAX eval CLI that later work brings
(the CLIP and BERT towers, multi-GPU eval) exit with a message naming it.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

# flag -> (the value that means "not used", the work that brings it)
_LATER = {
    "clip_text_ckpt": (None, "the CLIP text tower (ROADMAP Queue A 8)"),
    "clip_vocab": (None, "the CLIP text tower (ROADMAP Queue A 8)"),
    "clip_bpe": (None, "the CLIP text tower (ROADMAP Queue A 8)"),
    "bert_dir": (None, "the BERT tower (ROADMAP Queue A 8)"),
    "shard_eval": (False, "multi-GPU eval (ROADMAP Queue A 6)"),
    "multihost": (False, "multi-GPU eval (ROADMAP Queue A 6)"),
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("temporalalignnet_torch zero-shot eval")
    p.add_argument("--task", required=True, choices=["align", "retrieval"])
    p.add_argument("--ckpt", default=None,
                   help="reference-format .pth.tar; omit for the raw-feature baseline")
    p.add_argument("--milnce_ckpt", default=None,
                   help="baseline mode: s3d_howto100m.pth for the word2vec text tower and "
                        "the 1024->512 fc (eval_zeroshot_align.py:264-291)")
    p.add_argument("--baseline_sim", default="dot", choices=["dot", "cos"],
                   help="baseline similarity: dot for MIL-NCE, cos")
    p.add_argument("--features", required=True)
    p.add_argument("--anno", required=True)
    p.add_argument("--vocab", required=True, help="s3d_dict.npy word list")
    p.add_argument("--language_model", default="word2vec", choices=["word2vec", "bert"])
    p.add_argument("--bert_dir", default=None)
    p.add_argument("--clip_text_ckpt", default=None)
    p.add_argument("--clip_vocab", default=None)
    p.add_argument("--clip_bpe", default=None)
    p.add_argument("--shard_eval", action="store_true")
    p.add_argument("--multihost", action="store_true")
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


def _refuse_later_flags(args) -> None:
    if args.language_model == "bert":
        raise SystemExit("--language_model bert: not in the port yet; it comes with the BERT "
                         "tower (ROADMAP Queue A 8)")
    for flag, (unused, work) in _LATER.items():
        if getattr(args, flag) != unused:
            raise SystemExit(f"--{flag}: not in the port yet; it comes with {work}")


def build_baseline(args, vocab_size: int):
    """The raw-feature baseline of the flags (JAX eval/cli.py:148-232, MIL-NCE
    mode), its MIL-NCE weights loaded and the merge printed as ``[baseline]``
    lines."""
    from temporalalignnet_torch.checkpoint import load_milnce_checkpoint
    from temporalalignnet_torch.core.config import ModelConfig
    from temporalalignnet_torch.models.baseline import RawFeatureBaseline

    mcfg = ModelConfig(num_encoder_layers=0, num_joint_layers=1,
                       video_embed_dim=args.video_embed_dim, sim=args.baseline_sim,
                       use_alignability_head=False, random_pos_start=False)
    model = RawFeatureBaseline(mcfg, vocab_size=vocab_size,
                               use_visual_proj=args.milnce_ckpt is not None)
    if args.milnce_ckpt:
        for line in model.load_milnce(load_milnce_checkpoint(args.milnce_ckpt)):
            print(f"[baseline] {line}", flush=True)
    return model


def main(argv: Optional[list] = None) -> dict:
    args = build_parser().parse_args(argv)
    _refuse_later_flags(args)

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
    if args.ckpt is None:
        model = build_baseline(args, tokenizer.vocab_size)
    else:
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
