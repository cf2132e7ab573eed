"""HF TimeSformer checkpoints -> ``models/timesformer.py::TimeSformerEncoder``
(counterpart of temporalalignnet_tpu/checkpoint/timesformer_convert.py).
Both sides are torch, so this is a key map; the weights keep their layout
except the tables, which lose their leading 1:

- the ``timesformer.`` prefix of a TimesformerForVideoClassification is
  stripped and its ``classifier`` skipped;
- ``embeddings.patch_embeddings.projection`` -> ``patch_embed``;
  ``embeddings.cls_token`` [1, 1, D] / ``position_embeddings`` [1, P+1, D] /
  ``time_embeddings`` [1, T, D] -> ``cls_token`` [D] / ``position_embedding``
  / ``time_embedding``;
- each ``encoder.layer.{i}``: ``temporal_layernorm`` -> ``temporal_ln``,
  ``temporal_attention.attention.qkv`` / ``.output.dense`` ->
  ``temporal_attn.qkv`` / ``.proj``, ``temporal_dense``,
  ``layernorm_before`` / ``attention.*`` / ``layernorm_after`` ->
  ``ln_before`` / ``attn.*`` / ``ln_after``, ``intermediate.dense`` /
  ``output.dense`` -> ``c_fc`` / ``c_proj``;
- the final ``layernorm`` -> ``ln_post``.
Every other key is named in ``report``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

_EMBED = {"cls_token": "cls_token", "position_embeddings": "position_embedding",
          "time_embeddings": "time_embedding"}
_LAYER = {"temporal_layernorm": "temporal_ln", "temporal_attention.attention.qkv":
          "temporal_attn.qkv", "temporal_attention.output.dense": "temporal_attn.proj",
          "temporal_dense": "temporal_dense", "layernorm_before": "ln_before",
          "attention.attention.qkv": "attn.qkv", "attention.output.dense": "attn.proj",
          "layernorm_after": "ln_after", "intermediate.dense": "c_fc", "output.dense": "c_proj"}


def timesformer_state_dict(sd: Dict[str, Any], report: Optional[List[str]] = None
                           ) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for key, value in sd.items():
        v = torch.as_tensor(value).float()
        sub = key[len("timesformer."):] if key.startswith("timesformer.") else key
        parts = sub.split(".")
        if parts[0] == "classifier":
            continue
        if sub.startswith("embeddings.patch_embeddings.projection."):
            out[f"patch_embed.{parts[-1]}"] = v
        elif parts[0] == "embeddings" and len(parts) == 2 and parts[1] in _EMBED:
            out[_EMBED[parts[1]]] = (v.reshape(-1) if parts[1] == "cls_token"
                                     else v.reshape(v.shape[-2:]))
        elif parts[:2] == ["encoder", "layer"] and ".".join(parts[3:-1]) in _LAYER:
            out[f"layers.{parts[2]}.{_LAYER['.'.join(parts[3:-1])]}.{parts[-1]}"] = v
        elif parts[0] == "layernorm" and len(parts) == 2:
            out[f"ln_post.{parts[1]}"] = v
        elif report is not None:
            report.append(f"unrecognized timesformer key: {key}")
    return out
