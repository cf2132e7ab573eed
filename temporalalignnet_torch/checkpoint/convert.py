"""Weights into the port, in the reference state_dict key space.

- ``state_dict_from_jax(params)``: the JAX package's TANWithText param tree
  (numpy leaves) -> tensors under the reference keys.  The port's own copy of
  ``temporalalignnet_tpu/checkpoint/torch_convert.py::params_to_torch``:
  Dense kernels [in, out] transpose to ``weight [out, in]``, LayerNorm
  ``scale`` becomes ``weight``, and the separate q/k/v projections pack into
  ``attn.in_proj_weight [3D, D]`` rows [q; k; v] as nn.MultiheadAttention
  stores them (``_block_state_dict``, which ``decoder_state_dict_from_jax``
  shares for the cross-attention decoder's blocks).  A BERT language model
  (FlaxBertModule's tree under ``lang_model/bert``) goes to HF's
  ``bert.embeddings/encoder/pooler.*`` keys, the inverse of JAX ``torch_convert.py:62-88``: ``kernel`` transposed
  to ``weight``, ``scale`` and ``embedding`` to ``weight``.
- ``s3d_state_dict_from_jax(variables)``: JAX S3D variables (the output of
  ``temporalalignnet_tpu/checkpoint/s3d_convert.py::s3d_torch_to_variables``)
  -> the ``models/s3d.py`` / ``s3d_howto100m.pth`` key space, its inverse:
  conv kernels [kT, kH, kW, I, O] -> ``weight [O, I, kT, kH, kW]``, BN
  ``scale``/``bias`` and ``mean``/``var`` -> ``weight``/``bias`` and
  ``running_mean``/``running_var``, Dense kernels transposed, the text tower
  under ``text_module.``.
- ``load_reference_checkpoint(path, model)``: a reference ``.pth.tar``
  (``{epoch, state_dict, best_acc, optimizer, iteration}``) read natively and
  loaded with ``strict=True``.
- ``save_reference_checkpoint(path, model, optimizer, epoch, iteration,
  target=None)``: writes that layout (``reference_checkpoint``) with
  ``torch.save`` (train/main.py's save_checkpoint), the real optimizer state
  included, through a temporary file and a rename (``atomic_save``); with
  the Stage-2 ``target`` it writes the
  TwinTemporalAligner key space (tan_model.py:315-323), as
  ``temporalalignnet_tpu/checkpoint/torch_convert.py::flax_to_torch_state``
  does with ``ema_params``.
- ``merge_state_dict(base, loaded)``: the non-strict load of a ``--pretrain``
  checkpoint (JAX ``neq_merge``; reference utils/utils.py:302-312).  The
  EMA target then starts as ``train.EMATwin``'s copy of the online model
  that holds the merged weights (train/main.py:463-484).
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

_MODEL_LN = ("ln_text_init", "ln_video_init", "ln_position_init",
             "ln_video_post_enc", "ln_joint_post_enc")

# keys of the reference checkpoint that never enter its forward (tan_model.py:68)
_DROPPED = re.compile(r"^(mlp\.(weight|bias)|logit_scale|entropy_scale)$")


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def bert_state_dict_from_jax(tree: Dict[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    """A FlaxBertModule param tree -> HF torch BERT keys (under ``prefix``)."""
    out = {}
    for path, v in _leaves(tree):
        pre, leaf = prefix + ".".join(path[:-1]), path[-1]
        if leaf == "kernel":
            out[f"{pre}.weight"] = _t(v).T.contiguous()
        elif leaf in ("scale", "embedding"):
            out[f"{pre}.weight"] = _t(v)
        else:
            out[f"{pre}.{leaf}"] = _t(v)
    return out


def state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX TANWithText params -> the reference state_dict, f32 tensors."""
    out: Dict[str, torch.Tensor] = {}
    lang = params.get("lang_model", {})
    if "bert" in lang:
        out.update(bert_state_dict_from_jax(lang["bert"], "bert."))
    elif lang:
        out["bert.word_embd.weight"] = _t(lang["word_embd"]["embedding"])
        for fc in ("fc1", "fc2"):
            out[f"bert.{fc}.weight"] = _t(lang[fc]["kernel"]).T.contiguous()
            out[f"bert.{fc}.bias"] = _t(lang[fc]["bias"])

    al = params.get("aligner", {})
    for proj in ("video_pre_proj", "text_pre_proj"):
        if proj in al:
            out[f"{proj}.weight"] = _t(al[proj]["kernel"]).T.contiguous()
    if "binary_head" in al:
        out["binary_head.weight"] = _t(al["binary_head"]["kernel"]).T.contiguous()
        out["binary_head.bias"] = _t(al["binary_head"]["bias"])
    for ln in _MODEL_LN:
        if ln in al:
            out[f"{ln}.weight"] = _t(al[ln]["scale"])
            out[f"{ln}.bias"] = _t(al[ln]["bias"])
    for tbl in ("temporal_pos_embed", "text_temporal_pos_embed"):
        if tbl in al:
            out[tbl] = _t(al[tbl])

    for enc in ("video_temporal_encoder", "joint_temporal_encoder"):
        blocks = sorted((k for k in al.get(enc, {}) if k.startswith("resblocks_")),
                        key=lambda s: int(s.split("_")[1]))
        for bname in blocks:
            out.update(_block_state_dict(al[enc][bname], f"{enc}.resblocks.{bname.split('_')[1]}",
                                         ("attn",), ("ln_1", "ln_2")))
    return out


def decoder_state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX TemporalDecoder params (``resblocks_{i}`` with ``self_attn``,
    ``attn``, ``ln_1``-``ln_3``, ``mlp``) -> the port's TemporalDecoder
    state_dict (``resblocks.{i}.*``), f32 tensors."""
    out: Dict[str, torch.Tensor] = {}
    for bname, blk in params.items():
        out.update(_block_state_dict(blk, f"resblocks.{bname.split('_')[1]}",
                                     ("self_attn", "attn"), ("ln_1", "ln_2", "ln_3")))
    return out


def _block_state_dict(blk: Dict[str, Any], pre: str, attns, lns) -> Dict[str, torch.Tensor]:
    """One pre-LN block: each attention's separate q/k/v Dense layers packed
    into ``in_proj_weight [3D, D]`` rows [q; k; v] and ``in_proj_bias``,
    its ``out_proj``; the LayerNorms; the MLP's ``c_fc`` and ``c_proj``."""
    out: Dict[str, torch.Tensor] = {}
    qkv = ("q_proj", "k_proj", "v_proj")
    for name in attns:
        attn = blk[name]
        out[f"{pre}.{name}.in_proj_weight"] = torch.cat(
            [_t(attn[p]["kernel"]).T for p in qkv]).contiguous()
        out[f"{pre}.{name}.in_proj_bias"] = torch.cat([_t(attn[p]["bias"]) for p in qkv])
        out[f"{pre}.{name}.out_proj.weight"] = _t(attn["out_proj"]["kernel"]).T.contiguous()
        out[f"{pre}.{name}.out_proj.bias"] = _t(attn["out_proj"]["bias"])
    for ln in lns:
        out[f"{pre}.{ln}.weight"] = _t(blk[ln]["scale"])
        out[f"{pre}.{ln}.bias"] = _t(blk[ln]["bias"])
    for fc in ("c_fc", "c_proj"):
        out[f"{pre}.mlp.{fc}.weight"] = _t(blk["mlp"][fc]["kernel"]).T.contiguous()
        out[f"{pre}.mlp.{fc}.bias"] = _t(blk["mlp"][fc]["bias"])
    return out


def _leaves(tree: Dict[str, Any], path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def s3d_state_dict_from_jax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """{'params', 'batch_stats'[, 'text_params']} of a JAX S3D (numpy leaves)
    -> f32 tensors under the reference S3D keys; raises on a leaf it does not
    know."""
    out: Dict[str, torch.Tensor] = {}
    for path, v in _leaves(variables["params"]):
        pre, mod, leaf = ".".join(path[:-1]), path[-2], path[-1]
        if mod.startswith("conv") and leaf == "kernel":
            out[f"{pre}.weight"] = _t(v).permute(4, 3, 0, 1, 2).contiguous()
        elif mod.startswith("bn") and leaf in ("scale", "bias"):
            out[f"{pre}.{'weight' if leaf == 'scale' else 'bias'}"] = _t(v)
        elif mod == "fc" and leaf in ("kernel", "bias"):
            out[f"{pre}.{'weight' if leaf == 'kernel' else 'bias'}"] = (
                _t(v).T.contiguous() if leaf == "kernel" else _t(v))
        else:
            raise KeyError(f"unknown S3D param {'/'.join(path)}")
    stat = {"mean": "running_mean", "var": "running_var"}
    for path, v in _leaves(variables.get("batch_stats") or {}):
        out[".".join(path[:-1]) + "." + stat[path[-1]]] = _t(v)
    text = variables.get("text_params") or {}
    if text:
        out["text_module.word_embd.weight"] = _t(text["word_embd"]["embedding"])
        for fc in ("fc1", "fc2"):
            out[f"text_module.{fc}.weight"] = _t(text[fc]["kernel"]).T.contiguous()
            out[f"text_module.{fc}.bias"] = _t(text[fc]["bias"])
    return out


def reference_state_dict(state_dict: Dict[str, Any]) -> Tuple[Dict[str, Any], List[str]]:
    """Normalize a reference checkpoint's state_dict to the port's key space.

    Keeps the ``online.`` half of a Stage-2 twin checkpoint (tan_model.py:
    315-351) and drops its ``target.`` (EMA) half; maps the ``lang_model.``
    spelling of the language model to ``bert.``; drops the keys that never
    enter the forward.  Returns (state_dict, report of what was dropped).
    """
    out: Dict[str, Any] = {}
    report: List[str] = []
    n_target = 0
    for key, value in state_dict.items():
        if key.startswith("target."):
            n_target += 1
            continue
        if key.startswith("online."):
            key = key[len("online."):]
        if key.startswith("lang_model."):
            key = "bert." + key[len("lang_model."):]
        if _DROPPED.match(key):
            report.append(f"dropped (unused in reference forward): {key}")
            continue
        out[key] = value
    if n_target:
        report.append(f"dropped the {n_target} target (EMA) keys of a twin checkpoint")
    return out, report


def load_reference_checkpoint(path: str, model: torch.nn.Module, verbose: bool = True
                              ) -> List[str]:
    """Load a reference ``.pth.tar`` into ``model`` with ``strict=True``.
    Returns the report of dropped keys."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd, report = reference_state_dict(ckpt.get("state_dict", ckpt))
    model.load_state_dict(sd, strict=True)
    if verbose and report:
        print("[checkpoint] " + "\n[checkpoint] ".join(report))
    return report


def twin_state_dict(online: Dict[str, Any], target: Dict[str, Any]) -> Dict[str, Any]:
    """The TwinTemporalAligner key space: ``online.*``, ``target.*``, and the
    ``bert.*`` keys of the online language model once more at the top level,
    because the twin registers ``self.bert = self.online.bert``
    (tan_model.py:323) and torch's state_dict lists a module under each name
    it has.  The reference names its language model ``bert`` for word2vec
    too (tan_model.py:38-40), so a strict load into the reference twin needs
    them (the JAX package's ``flax_to_torch_state`` emits the same keys)."""
    out = {f"online.{k}": v for k, v in online.items()}
    out.update({f"target.{k}": v for k, v in target.items()})
    out.update({k: v for k, v in online.items() if k.startswith("bert.")})
    return out


def reference_checkpoint(model: torch.nn.Module, optimizer=None, epoch: int = 0,
                         iteration: int = 0, best_acc: float = 0.0,
                         target: Optional[torch.nn.Module] = None) -> Dict[str, Any]:
    """``{epoch, state_dict, best_acc, optimizer, iteration}`` in the reference
    layout; the weights on the CPU in their own dtype.  With ``target`` (the
    EMA twin's model) the state_dict is ``twin_state_dict``'s.  A
    tensor-parallel model's weights (and its optimizer's state) are gathered
    to the full shapes, the key space of tp = 1 (a collective over its tp
    ranks, which call this together)."""
    from temporalalignnet_torch.parallel.tensor import model_tp_group, tp_gather_state_dict

    def cpu(m):
        sd = tp_gather_state_dict(m.state_dict(), model_tp_group(m))
        return {k: v.detach().cpu() for k, v in sd.items()}

    return {
        "epoch": epoch,
        "state_dict": cpu(model) if target is None else twin_state_dict(cpu(model), cpu(target)),
        "best_acc": best_acc,
        "optimizer": optimizer.state_dict() if optimizer is not None else {},
        "iteration": iteration,
    }


def atomic_save(obj: Any, path: str) -> None:
    """``torch.save`` to a temporary file beside ``path``, then a rename: a
    reader (or a kill at any point) sees the old file or the new, never part."""
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_reference_checkpoint(path: str, model: torch.nn.Module, optimizer=None, epoch: int = 0,
                              iteration: int = 0, best_acc: float = 0.0,
                              target: Optional[torch.nn.Module] = None) -> None:
    """``reference_checkpoint``'s dict, written with ``atomic_save``."""
    atomic_save(reference_checkpoint(model, optimizer, epoch, iteration, best_acc, target), path)


def merge_state_dict(base: Dict[str, torch.Tensor], loaded: Dict[str, Any]
                     ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """Non-strict load (JAX ``neq_merge``; reference utils/utils.py:302-312 and
    train/main.py:458-484): the value of every key of ``base`` that
    ``loaded`` holds, ``base``'s own (a fresh init) for the keys it lacks,
    such as the alignability head of a Stage-1 run without one; keys of
    ``loaded`` that ``base`` lacks are dropped.  ``loaded`` is normalized by
    ``reference_state_dict`` first (a twin's online half).  Returns (merged,
    report); a key whose shape differs raises."""
    loaded, report = reference_state_dict(loaded)
    merged = {}
    for k, v in base.items():
        if k not in loaded:
            report.append(f"missing in checkpoint (kept init): {k}")
            merged[k] = v
            continue
        new = torch.as_tensor(loaded[k])
        if new.shape != v.shape:
            raise ValueError(f"{k}: checkpoint shape {tuple(new.shape)}, model {tuple(v.shape)}")
        merged[k] = new.to(v.dtype)
    report += [f"unexpected in checkpoint (dropped): {k}" for k in loaded if k not in base]
    return merged, report


def merge_into(module: torch.nn.Module, part: Dict[str, Any], name: str) -> List[str]:
    """``part`` (a state_dict of ``module``'s own keys) merged non-strictly
    into ``module`` by ``merge_state_dict`` and loaded; returns the report,
    each key under ``name.``."""
    merged, report = merge_state_dict(module.state_dict(), part)
    module.load_state_dict(merged, strict=True)
    return [line.replace(": ", f": {name}.", 1) for line in report]
