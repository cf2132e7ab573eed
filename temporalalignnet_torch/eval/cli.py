"""Zero-shot evaluation of a TAN checkpoint (temporalalignnet_tpu/eval/cli.py;
reference eval/eval_zeroshot_align.py:255 and eval_zeroshot_retrieval.py:259):
HTM-Align alignment, or YouCook2 text->video retrieval on the validation split.

  python -m temporalalignnet_torch.eval --task align \\
      --ckpt model.pth.tar --features <dir> --anno htm_align.json --vocab s3d_dict.npy
  python -m temporalalignnet_torch.eval --task retrieval \\
      --ckpt model.pth.tar --features <yc2 dir> \\
      --anno youcookii_annotations_trainval.json --vocab s3d_dict.npy

``--language_model bert --bert_dir <dir>`` evaluates a BERT TAN: the
directory's config.json and vocab.txt give the tower and the tokenizer
(``models/bert.py``), the checkpoint its weights.

Without ``--ckpt`` it scores the raw features with ``RawFeatureBaseline``,
the reference's MIL-NCE baseline (eval_zeroshot_align.py:262-291):
``--milnce_ckpt s3d_howto100m.pth`` loads its word2vec text tower and the
1024 -> 512 ``fc``, and ``--baseline_sim`` (dot, the MIL-NCE default, or
cos) sets the similarity.  Without ``--milnce_ckpt`` the baseline has no
projection and a text tower of random weights, as in JAX.  The CLIP
baseline (:294-330): ``--clip_text_ckpt`` (an HF CLIP text state_dict),
``--clip_vocab`` with ``--clip_merges`` or ``--clip_bpe`` for the tokenizer
at ``--clip_context`` tokens, ``--clip_text_heads`` and
``--clip_hidden_act`` (the state_dict holds neither); the tower's other
sizes come from the checkpoint.  Use it with CLIP features,
``--baseline_sim cos`` and ``--video_embed_dim`` the CLIP embed dim.

Runs on ``--device cuda`` (the default) in bf16, or in f32 with ``--f32``;
``--device cpu`` runs the plain PyTorch path in f32.  On the card every
attention goes through the Hopper kernel, except the CLIP text tower's
causal one, which is plain PyTorch as in JAX.  Prints one JSON line of
metrics.

Multi-GPU (JAX eval/cli.py:83-109, 280-293): ``--multihost`` joins the
processes (one per card: ``--coordinator host:port --num_processes N
--process_id i`` in each, or torchrun's environment; ``parallel/
distributed.py``), and ``--shard_eval`` splits every forward call's windows
or clips over them; each process prints the same metrics, those of one
process.  Without a process group ``--shard_eval`` changes nothing (JAX
builds its mesh only over more than one device).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional



def build_parser() -> argparse.ArgumentParser:
    from temporalalignnet_torch.parallel import distributed

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
    p.add_argument("--vocab", default=None, help="s3d_dict.npy word list (word2vec)")
    p.add_argument("--language_model", default="word2vec", choices=["word2vec", "bert"])
    p.add_argument("--bert_dir", default=None,
                   help="HF BERT directory (config.json, vocab.txt) for --language_model bert")
    p.add_argument("--clip_text_ckpt", default=None,
                   help="baseline mode: an HF CLIPTextModel(/WithProjection or CLIPModel) "
                        "state_dict; the CLIP text tower encodes the captions")
    p.add_argument("--clip_vocab", default=None, help="HF-style CLIP vocab.json (with "
                                                       "--clip_merges)")
    p.add_argument("--clip_merges", default=None, help="HF-style merges.txt")
    p.add_argument("--clip_bpe", default=None,
                   help="alternative: OpenAI bpe_simple_vocab_16e6.txt.gz")
    p.add_argument("--clip_context", type=int, default=77, help="CLIP tokenizer context")
    p.add_argument("--clip_text_heads", type=int, default=8,
                   help="text-tower heads (8 for B/32 and B/16, 12 for L/14)")
    p.add_argument("--clip_hidden_act", default="quick_gelu", choices=["quick_gelu", "gelu"],
                   help="the checkpoint config's hidden_act")
    p.add_argument("--shard_eval", action="store_true",
                   help="split the forward calls over the processes of --multihost")
    distributed.add_multihost_flags(p)
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


def build_tokenizer(args):
    """BERT's, CLIP's or word2vec's tokenizer, as JAX eval/cli.py:123-147
    chooses; for BERT also its config."""
    if args.language_model == "bert":
        if not args.bert_dir:
            raise SystemExit("--language_model bert requires --bert_dir")
        from temporalalignnet_torch.models.bert import BertConfig, BertTokenizer

        return (BertTokenizer.from_dir(args.bert_dir),
                BertConfig.from_json_file(os.path.join(args.bert_dir, "config.json")))
    if args.clip_vocab or args.clip_bpe:
        from temporalalignnet_torch.models.clip_text import CLIPTokenizer

        if args.clip_bpe:
            return CLIPTokenizer.from_openai_bpe(args.clip_bpe, args.clip_context), None
        if not args.clip_merges:
            raise SystemExit("--clip_vocab requires --clip_merges")
        return CLIPTokenizer(args.clip_vocab, args.clip_merges, args.clip_context), None
    if not args.vocab:
        raise SystemExit("--vocab is required for --language_model word2vec")
    from temporalalignnet_torch.models.word2vec import Word2VecTokenizer

    return Word2VecTokenizer(args.vocab, max_words=args.max_words), None


def build_baseline(args, vocab_size: int):
    """The raw-feature baseline of the flags (JAX eval/cli.py:148-232): the
    MIL-NCE weights or the CLIP text tower loaded and each merge printed as
    ``[baseline]`` lines."""
    import torch

    from temporalalignnet_torch.checkpoint import load_milnce_checkpoint, merge_into
    from temporalalignnet_torch.core.config import ModelConfig
    from temporalalignnet_torch.models.baseline import RawFeatureBaseline

    mcfg = ModelConfig(num_encoder_layers=0, num_joint_layers=1,
                       video_embed_dim=args.video_embed_dim, sim=args.baseline_sim,
                       use_alignability_head=False, random_pos_start=False)
    text_tower = clip_text = None
    if args.clip_text_ckpt:
        from temporalalignnet_torch.checkpoint.clip_convert import (clip_text_geometry,
                                                                    clip_text_state_dict)
        from temporalalignnet_torch.models.clip_text import CLIPTextEncoder

        sd = torch.load(args.clip_text_ckpt, map_location="cpu", weights_only=True)
        clip_text = clip_text_state_dict(sd.get("state_dict", sd))
        # the geometry comes from the weights; heads and activation are flags
        text_tower = lambda: CLIPTextEncoder(**clip_text_geometry(clip_text),
                                             heads=args.clip_text_heads,
                                             hidden_act=args.clip_hidden_act)
    model = RawFeatureBaseline(mcfg, vocab_size=vocab_size,
                               use_visual_proj=args.milnce_ckpt is not None,
                               text_tower=text_tower)
    if clip_text is not None:
        for line in merge_into(model.lang_model, clip_text, "lang_model"):
            print(f"[baseline] {line}", flush=True)
    if args.milnce_ckpt:
        for line in model.load_milnce(load_milnce_checkpoint(args.milnce_ckpt)):
            print(f"[baseline] {line}", flush=True)
    return model


def main(argv: Optional[list] = None) -> dict:
    args = build_parser().parse_args(argv)
    import torch

    from temporalalignnet_torch.parallel import distributed

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device here (pass --device cpu for the CPU path)")
    started = distributed.start_multihost(args)
    try:
        return _evaluate(args, distributed.default_group() if args.shard_eval else None)
    finally:
        if started:
            distributed.destroy()


def _evaluate(args, group) -> dict:
    import torch

    from temporalalignnet_torch.checkpoint import load_reference_checkpoint
    from temporalalignnet_torch.core.config import EvalConfig, ModelConfig, Precision
    from temporalalignnet_torch.data import HTMAlignDataset, YC2RetrievalDataset
    from temporalalignnet_torch.eval.align import AlignmentEvaluator
    from temporalalignnet_torch.eval.retrieval import RetrievalEvaluator
    from temporalalignnet_torch.models.net import TANWithText

    from temporalalignnet_torch.parallel.distributed import process_device

    device = process_device(args.device)
    dtype = torch.float32 if args.f32 or device.type == "cpu" else Precision().compute

    tokenizer, bert_config = build_tokenizer(args)
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
        model = TANWithText(mcfg, vocab_size=tokenizer.vocab_size, bert_config=bert_config)
        load_reference_checkpoint(args.ckpt, model)
    model.to(device=device, dtype=dtype)

    cfg = EvalConfig(
        seq_len=args.seq_len,
        method=args.method,
        batch_windows=args.batch_windows,
        global_buckets=args.global_buckets,
        num_clips=args.num_clips,
    )
    # the CLIP tokenizer's rows are its context wide, not --max_words
    words = getattr(tokenizer, "max_words", args.max_words)
    if args.task == "align":
        ds = HTMAlignDataset(args.features, args.anno, tokenizer, words)
        out = AlignmentEvaluator(model, cfg, group).evaluate(list(ds))
    else:
        ds = YC2RetrievalDataset(args.features, args.anno, "val", tokenizer, words)
        out = RetrievalEvaluator(model, cfg, group).evaluate(list(ds))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
