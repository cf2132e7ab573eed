"""The MIL-NCE checkpoint (``s3d_howto100m.pth``) -> the port's word2vec text
tower, the S3D ``fc`` and the S3D backbone (counterpart of
temporalalignnet_tpu/checkpoint/s3d_convert.py:39-108).

- ``text_module.{word_embd,fc1,fc2}`` (Sentence_Embedding, reference
  model/s3d_milnce/s3dg.py:186-247) -> a state_dict of ``Word2VecEncoder``
  (``word_embd.weight``, ``fc{1,2}.{weight,bias}``); torch layouts, so no
  transpose;
- ``fc.{weight,bias}`` (the 1024 -> 512 video projection) -> the state_dict
  of ``RawFeatureBaseline.visual_proj``;
- the S3D conv, BatchNorm and gating keys are read, classified as the JAX
  converter classifies them (its report lines for keys it does not
  recognise are returned word for word) and kept under ``"s3d"``;
  ``s3d_state_dict`` joins them, ``fc`` and the text tower into the
  ``models/s3d.py`` key space (the reference's, so no transpose), which
  ``S3D`` and ``S3DWithText`` load with ``strict=True``.  The end-to-end
  trainer's ``params_latest.pth`` is in the same key space.
The ``module.``, ``backbone.`` and ``s3d.`` prefixes of wrapped checkpoints
are stripped; ``num_batches_tracked`` is dropped.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch


def split_milnce_state_dict(state_dict: Dict[str, Any], report: Optional[List[str]] = None
                            ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{'text': Word2VecEncoder state_dict, 'fc': Linear state_dict, 's3d':
    the backbone's recognised conv and BN tensors under their stripped keys}."""
    out: Dict[str, Dict[str, torch.Tensor]] = {"text": {}, "fc": {}, "s3d": {}}
    for key, value in state_dict.items():
        if key.endswith("num_batches_tracked"):
            continue
        v = torch.as_tensor(value).detach().cpu()
        parts = key.split(".")
        while parts and parts[0] in ("module", "backbone", "s3d"):
            parts = parts[1:]

        if parts[0] == "text_module":
            sub, leaf = parts[1], parts[2]
            if sub == "word_embd" or sub in ("fc1", "fc2"):
                # the JAX converter keeps any leaf of word_embd as the table
                name = "weight" if sub == "word_embd" else leaf
                out["text"][f"{sub}.{name}"] = v
            elif report is not None:
                report.append(f"unrecognized text key: {key}")
            continue

        leaf, mod = parts[-1], parts[-2]
        if mod.startswith("conv") and leaf == "weight":
            out["s3d"][".".join(parts)] = v
        elif mod.startswith("bn"):
            if leaf in ("weight", "scale", "bias", "running_mean", "running_var"):
                out["s3d"][".".join(parts)] = v
            elif report is not None:
                report.append(f"unrecognized bn key: {key}")
        elif mod == "fc" and leaf in ("weight", "bias"):
            if len(parts) == 2:
                out["fc"][leaf] = v
            else:
                out["s3d"][".".join(parts)] = v  # a gating fc inside a block
        elif report is not None:
            report.append(f"unrecognized key: {key}")
    return out


def load_milnce_checkpoint(path: str, verbose: bool = True) -> Dict[str, Any]:
    """Read an ``s3d_howto100m.pth``-format file (its state_dict, or one under
    ``"state_dict"``).  Returns ``split_milnce_state_dict``'s dict, with
    ``text`` and ``fc`` None when the file has none, and the report under
    ``"report"`` (printed with the JAX converter's ``[s3d_convert]`` tag)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    report: List[str] = []
    out: Dict[str, Any] = split_milnce_state_dict(ckpt.get("state_dict", ckpt), report)
    out["text"] = out["text"] or None
    out["fc"] = out["fc"] or None
    if verbose and report:
        print("[s3d_convert] " + "\n[s3d_convert] ".join(report))
    out["report"] = report
    return out


def s3d_state_dict(loaded: Dict[str, Any], text: bool = True) -> Dict[str, torch.Tensor]:
    """``load_milnce_checkpoint``'s parts -> one state_dict of ``S3D`` (with
    ``text``, of ``S3DWithText``): the backbone's keys (a FrozenBN
    checkpoint's ``.scale`` read as ``.weight``, as the JAX converter reads
    it), ``fc.*`` and ``text_module.*``."""
    out = {}
    for key, v in loaded["s3d"].items():
        parts = key.split(".")
        if parts[-2].startswith("bn") and parts[-1] == "scale":
            parts[-1] = "weight"
        out[".".join(parts)] = v
    out.update({f"fc.{k}": v for k, v in (loaded["fc"] or {}).items()})
    if text:
        out.update({f"text_module.{k}": v for k, v in (loaded["text"] or {}).items()})
    return out
