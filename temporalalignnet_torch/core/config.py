"""Frozen dataclass configs (counterpart of temporalalignnet_tpu/core/config.py).

Only the configs and fields this slice reads are here: the model
architecture, the eval options and the precision policy.  Dtypes are torch
dtypes.  Whether the alignability head is read comes from the model's
ModelConfig, as in the JAX evaluator.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Precision:
    """Mixed-precision policy: f32 params, bf16 compute, f32 logits and loss."""

    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    loss_dtype: str = "float32"

    @property
    def param(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def compute(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def loss(self) -> torch.dtype:
        return getattr(torch, self.loss_dtype)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """TemporalAligner architecture (reference: model/tan_model.py:13-73).

    Width is 512 with 8 heads; the released E6D6 model uses
    num_encoder_layers=6, num_joint_layers=6.
    """

    width: int = 512
    heads: int = 8
    num_encoder_layers: int = 6
    num_joint_layers: int = 6  # the reference calls this "decoder"; it is an encoder
    video_embed_dim: int = 1024
    language_model: str = "word2vec"
    pos_enc: str = "learned"  # 'learned' or 'sine'
    num_pos_embeds: int = 1024
    use_text_pos_enc: bool = False
    random_pos_start: bool = True  # random window offset in training
    use_alignability_head: bool = False
    mlp_ratio: int = 4

    @property
    def text_embed_dim(self) -> int:
        return {"bert": 768, "word2vec": 512}[self.language_model]


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """Zero-shot eval options (reference: eval/eval_zeroshot_align.py:97-252)."""

    seq_len: int = 64
    method: str = "overlap-seq"  # 'overlap-seq' or 'global'
    alignability_layer: int = 2  # "3rd layer works the best" (eval_zeroshot_align.py:186)
    # windows per forward call of the overlap-seq canvas; the global method
    # batches videos up to the same token count (batch_windows * seq_len)
    batch_windows: int = 256
    global_buckets: int = 3  # method='global': videos split into <= this many length buckets
