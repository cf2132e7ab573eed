"""Ahead-of-time export of the zero-shot eval forward for serving
(torch.export; counterpart of temporalalignnet_tpu/tools/export_eval.py).

The eval forward (text encoding -> dual and joint encoders -> per-layer sims
and the alignability head, the ``bench.py`` workload) is traced once into a
``torch.export`` artifact (``.pt2``).  A serving process then needs only

    import temporalalignnet_torch.ops  # registers temporalalignnet::mha_fwd
    program = torch.export.load(path).module()
    out = program(params, video, input_ids)

- no model classes and no tracing.  ``params`` is a dict in the port's
state_dict key space (``TANWithText.state_dict()``, which a reference
``.pth.tar`` loads into), so one artifact serves every checkpoint of the
architecture; ``video`` is [B, T, C] float32, ``input_ids`` [B, N, W] int64
(0 = pad).  On the card every attention is one node of the custom op
``temporalalignnet::mha_fwd`` (``ops/mha_fwd.py``), the hand-written kernel;
on the CPU the plain attention is traced instead.  An artifact is traced
for the device of its example inputs, so JAX's ``--platforms`` has no
counterpart.

Batch: by default the artifact is specialised to ``--batch`` windows (serving
pads the tail batch); ``--poly_batch`` gives it a symbolic batch dimension
(``torch.export.Dim('b', min=2)``: torch.export specialises the sizes 0 and 1).

    python -m temporalalignnet_torch.tools.export_eval \\
        --ckpt cotrain_word2vec_htm-370k_len64_e6d6.pth.tar \\
        --out tan_eval.pt2 --batch 192 [--poly_batch] [--device cpu] [--f32]

The card exports bf16 weights (``--f32``: float32), as the eval CLI runs.
The round trip (save, load, run, compare against the live model on seeded
inputs) runs before the file is written.
"""

from __future__ import annotations

import argparse
import io
import json
from typing import Any, Dict, Optional

import numpy as np
import torch


class _Sims(torch.nn.Module):
    """encode_text + text_visual_sims of ``tan`` as one forward."""

    def __init__(self, tan: torch.nn.Module):
        super().__init__()
        self.tan = tan

    def forward(self, video: torch.Tensor, input_ids: torch.Tensor) -> Dict[str, torch.Tensor]:
        text = self.tan.encode_text(input_ids, (input_ids != 0).int())
        return self.tan.text_visual_sims(video, text)


class EvalForward(torch.nn.Module):
    """``(params, video, input_ids) -> sims`` of a TANWithText, its weights an
    argument (``torch.func.functional_call``): the module holds none, so an
    export of it holds none either."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.__dict__["_sims"] = _Sims(model)  # outside the module tree

    def forward(self, params: Dict[str, torch.Tensor], video: torch.Tensor,
                input_ids: torch.Tensor) -> Dict[str, torch.Tensor]:
        named = {f"tan.{k}": v for k, v in params.items()}
        return torch.func.functional_call(self._sims, named, (video, input_ids))


def eval_params(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The serving argument of ``model``: its state_dict, detached."""
    return {k: v.detach() for k, v in model.state_dict().items()}


def export_eval_forward(
    model: torch.nn.Module,
    params: Dict[str, torch.Tensor],
    batch: int,
    seq_len: int = 64,
    feature_dim: int = 1024,
    sentences: int = 8,
    words: int = 32,
    poly_batch: bool = False,
) -> torch.export.ExportedProgram:
    """Trace the eval forward into a ``torch.export.ExportedProgram`` on the
    device of ``params`` (``torch.export.save`` writes it).  The program is
    encode_text + text_visual_sims, the per-window work of the reference's
    overlap-seq eval (eval/eval_zeroshot_align.py:127-205)."""
    ref = next(iter(params.values()))  # the example inputs like it (fake ones too)
    b = max(batch, 2) if poly_batch else batch
    video = ref.new_zeros((b, seq_len, feature_dim), dtype=torch.float32)
    ids = ref.new_ones((b, sentences, words), dtype=torch.long)
    dynamic = None
    if poly_batch:
        dim = torch.export.Dim("b", min=2)
        dynamic = ({k: None for k in params}, {0: dim}, {0: dim})
    return torch.export.export(EvalForward(model), (params, video, ids),
                               dynamic_shapes=dynamic, strict=False)


def serialize(exported: torch.export.ExportedProgram) -> bytes:
    """The artifact's bytes, without the example inputs (the weights among
    them) that ``torch.export.save`` would otherwise keep."""
    exported.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    return buf.getvalue()


def deserialize(blob: bytes) -> torch.export.ExportedProgram:
    import temporalalignnet_torch.ops  # noqa: F401  (registers temporalalignnet::mha_fwd)

    return torch.export.load(io.BytesIO(blob))


def mha_fwd_nodes(exported: torch.export.ExportedProgram) -> int:
    """The program's calls of the custom op ``temporalalignnet::mha_fwd``."""
    op = torch.ops.temporalalignnet.mha_fwd.default
    return sum(1 for n in exported.graph.nodes if n.op == "call_function" and n.target is op)


def seeded_inputs(batch: int, seq_len: int, feature_dim: int, sentences: int, words: int,
                  device) -> tuple:
    """JAX's round-trip inputs: video N(0, 1), ids in [1, 50), from numpy seed 0."""
    rng = np.random.RandomState(0)
    video = torch.from_numpy(rng.randn(batch, seq_len, feature_dim).astype(np.float32))
    ids = torch.from_numpy(rng.randint(1, 50, (batch, sentences, words)).astype(np.int64))
    return video.to(device), ids.to(device)


def roundtrip_check(
    blob: bytes,
    model: torch.nn.Module,
    params: Dict[str, torch.Tensor],
    batch: int,
    seq_len: int,
    feature_dim: int,
    sentences: int,
    words: int,
    atol: float = 0.0,
) -> Dict[str, float]:
    """Load ``blob``, run it on seeded inputs and compare with the live model
    run eagerly on the same ``params``; returns ``max_abs_diff/<key>`` and
    raises past ``atol``."""
    dev = next(iter(params.values())).device
    video, ids = seeded_inputs(batch, seq_len, feature_dim, sentences, words, dev)
    program = deserialize(blob).module()
    with torch.no_grad():
        got = program(params, video, ids)
        want = EvalForward(model)(params, video, ids)
    diffs = {}
    for key in want:
        d = (got[key].float() - want[key].float()).abs().max().item()
        diffs[f"max_abs_diff/{key}"] = d
        if not d <= atol:
            raise AssertionError(f"round-trip mismatch on {key}: {d} > {atol}")
    return diffs


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ckpt", default=None,
                   help="reference .pth.tar to load (strict); omit for a random-init E6D6 "
                        "(the artifact's structure is the same)")
    p.add_argument("--out", required=True, help="output artifact path (.pt2)")
    p.add_argument("--batch", type=int, default=192,
                   help="window batch the artifact is specialised to (the example batch "
                        "with --poly_batch)")
    p.add_argument("--poly_batch", action="store_true",
                   help="export with a symbolic batch dimension (b >= 2)")
    p.add_argument("--seq_len", type=int, default=64)
    p.add_argument("--video_embed_dim", type=int, default=1024)
    p.add_argument("--sentences", type=int, default=8)
    p.add_argument("--words", type=int, default=32)
    p.add_argument("--platforms", default=None,
                   help="refused: a torch.export artifact is traced for one device "
                        "(--device)")
    p.add_argument("--verify_batch", type=int, default=4,
                   help="round-trip check batch (poly artifacts verify at this size; "
                        "fixed artifacts at --batch)")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--layers", type=int, default=6)
    p.add_argument("--vocab_size", type=int, default=66251)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--f32", action="store_true",
                   help="float32 weights on the card (default bf16; the CPU is float32)")
    return p


def main(argv: Optional[list] = None) -> Dict[str, Any]:
    args = build_parser().parse_args(argv)
    if args.platforms:
        raise SystemExit("--platforms: a torch.export artifact is traced for one device; "
                         "export on each with --device (ROADMAP Queue C)")

    from temporalalignnet_torch.checkpoint import load_reference_checkpoint
    from temporalalignnet_torch.core.config import ModelConfig, Precision
    from temporalalignnet_torch.models.net import TANWithText

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device here (pass --device cpu for the CPU path)")
    dtype = torch.float32 if args.f32 or device.type == "cpu" else Precision().compute
    cfg = ModelConfig(use_alignability_head=True, video_embed_dim=args.video_embed_dim,
                      width=args.width, heads=args.heads, num_encoder_layers=args.layers,
                      num_joint_layers=args.layers, random_pos_start=False)
    model = TANWithText(cfg, vocab_size=args.vocab_size)
    model.init_weights(torch.Generator().manual_seed(0))
    if args.ckpt:
        for line in load_reference_checkpoint(args.ckpt, model, verbose=False):
            print(f"[export] {line}")
    model.to(device=device, dtype=dtype).eval()
    params = eval_params(model)

    exported = export_eval_forward(model, params, args.batch, args.seq_len,
                                   args.video_embed_dim, args.sentences, args.words,
                                   poly_batch=args.poly_batch)
    blob = serialize(exported)
    vb = args.verify_batch if args.poly_batch else args.batch
    diffs = roundtrip_check(blob, model, params, vb, args.seq_len, args.video_embed_dim,
                            args.sentences, args.words)
    with open(args.out, "wb") as f:
        f.write(blob)
    out = {"path": args.out, "bytes": len(blob),
           "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "dtype": str(dtype).replace("torch.", ""), "poly_batch": bool(args.poly_batch),
           "mha_fwd_nodes": mha_fwd_nodes(exported), **diffs}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
