"""HF CLIP checkpoints -> the port's CLIP towers (counterpart of
temporalalignnet_tpu/checkpoint/clip_convert.py).  Both sides are torch, so
this is a key map; the weights keep their layout:

- ``vision_model.*`` (CLIPVisionModel / WithProjection, or a whole CLIPModel):
  ``embeddings.patch_embedding`` -> ``patch_embed``, ``class_embedding``,
  ``position_embedding.weight`` -> ``position_embedding``,
  ``pre_layrnorm`` (HF's spelling) / ``post_layernorm`` -> ``ln_pre`` /
  ``ln_post``, ``visual_projection`` -> ``proj``;
- ``text_model.*`` (CLIPTextModel / WithProjection, or a whole CLIPModel):
  ``token_embedding``, ``position_embedding.weight`` ->
  ``positional_embedding``, ``final_layer_norm`` -> ``ln_final``,
  ``text_projection`` -> ``proj``;
- each ``encoder.layers.{i}``: ``self_attn.{q,k,v}_proj`` -> the rows
  [q; k; v] of ``resblocks.{i}.attn.in_proj_weight`` / ``in_proj_bias``,
  ``self_attn.out_proj`` -> ``attn.out_proj``, ``layer_norm1/2`` ->
  ``ln_1/2``, ``mlp.fc1/fc2`` -> ``mlp.c_fc/c_proj``.
The other tower's keys and ``logit_scale`` are skipped, the ``position_ids``
buffers dropped, and every other key is named in ``report``.  The state_dict
holds no activation, head count or pooling: set ``hidden_act`` (and the
text tower's ``eos_token_id``) from the checkpoint's config.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

_LAYER = {"layer_norm1": "ln_1", "layer_norm2": "ln_2", "mlp.fc1": "mlp.c_fc",
          "mlp.fc2": "mlp.c_proj", "self_attn.out_proj": "attn.out_proj"}
_VISION = {"embeddings.patch_embedding.weight": "patch_embed.weight",
           "embeddings.class_embedding": "class_embedding",
           "embeddings.position_embedding.weight": "position_embedding",
           "pre_layrnorm.weight": "ln_pre.weight", "pre_layrnorm.bias": "ln_pre.bias",
           "pre_layernorm.weight": "ln_pre.weight", "pre_layernorm.bias": "ln_pre.bias",
           "post_layernorm.weight": "ln_post.weight", "post_layernorm.bias": "ln_post.bias"}
_TEXT = {"embeddings.token_embedding.weight": "token_embedding.weight",
         "embeddings.position_embedding.weight": "positional_embedding",
         "final_layer_norm.weight": "ln_final.weight", "final_layer_norm.bias": "ln_final.bias"}


def _convert(sd: Dict[str, Any], tower: str, other: str, projection: str,
             names: Dict[str, str], report: Optional[List[str]]) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    qkv: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, value in sd.items():
        v = torch.as_tensor(value).float()
        if key == "logit_scale" or (key.startswith(
                (other + ".", "visual_projection.", "text_projection."))
                and not key.startswith(projection + ".")):
            continue  # the other tower of a whole CLIPModel
        if key == f"{projection}.weight":
            out["proj.weight"] = v
            continue
        sub = key[len(tower) + 1:] if key.startswith(tower + ".") else key
        parts = sub.split(".")
        if sub in names:
            out[names[sub]] = v
        elif parts[-1] == "position_ids":
            pass  # a registered buffer
        elif parts[:2] == ["encoder", "layers"] and len(parts) >= 5:
            i, rest, leaf = parts[2], ".".join(parts[3:-1]), parts[-1]
            if rest in ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj"):
                qkv.setdefault(f"resblocks.{i}.attn.in_proj_{leaf}", {})[rest[-6]] = v
            elif rest in _LAYER:
                out[f"resblocks.{i}.{_LAYER[rest]}.{leaf}"] = v
            elif report is not None:
                report.append(f"unrecognized clip key: {key}")
        elif report is not None:
            report.append(f"unrecognized clip key: {key}")
    for name, parts in qkv.items():
        if set(parts) != {"q", "k", "v"}:
            raise KeyError(f"{name}: the checkpoint holds {sorted(parts)} of q, k, v")
        out[name] = torch.cat([parts["q"], parts["k"], parts["v"]])
    return out


def clip_vision_state_dict(sd: Dict[str, Any], report: Optional[List[str]] = None
                           ) -> Dict[str, torch.Tensor]:
    """HF CLIP vision weights -> ``models/clip_vit.py::CLIPImageEncoder``'s keys."""
    return _convert(sd, "vision_model", "text_model", "visual_projection", _VISION, report)


def clip_text_state_dict(sd: Dict[str, Any], report: Optional[List[str]] = None
                         ) -> Dict[str, torch.Tensor]:
    """HF CLIP text weights -> ``models/clip_text.py::CLIPTextEncoder``'s keys."""
    return _convert(sd, "text_model", "vision_model", "text_projection", _TEXT, report)


def clip_text_geometry(sd: Dict[str, torch.Tensor]) -> Dict[str, int]:
    """The text tower's sizes read off its converted weights (JAX
    eval/cli.py:170-196): vocab rows, context, width, layers, projection
    (0 without one)."""
    vocab, width = sd["token_embedding.weight"].shape
    return dict(vocab_size=vocab, context_length=sd["positional_embedding"].shape[0],
                width=width,
                layers=len({k.split(".")[1] for k in sd if k.startswith("resblocks.")}),
                embed_dim=sd["proj.weight"].shape[0] if "proj.weight" in sd else 0)
