"""Frozen dataclass configs (counterpart of temporalalignnet_tpu/core/config.py).

The model architecture, the loss of both stages, data and optimization
options, the eval options and the precision policy.  Dtypes are torch dtypes.
Whether the alignability head is read at eval comes from the model's
ModelConfig, as in the JAX evaluator.  Fields of the JAX configs that only
later slices read (the mesh sizes) come with them.
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
    sim: str = "cos"  # 'cos' or 'dot' (tan_model.py:116-119; the raw-feature baseline reads it)
    pos_enc: str = "learned"  # 'learned' or 'sine'
    num_pos_embeds: int = 1024
    use_text_pos_enc: bool = False
    random_pos_start: bool = True  # random window offset in training
    use_alignability_head: bool = False
    return_dual_feature: bool = True
    mlp_ratio: int = 4
    # training forward returns the per-layer normalized features instead of
    # the [B,S,T,B,N] cross-batch logits, for the fused MIL-NCE kernels
    # (ops/milnce.py); pair with LossConfig.use_fused_milnce
    fused_milnce: bool = False
    # recompute each encoder block in the backward (torch.utils.checkpoint):
    # its activations are not kept between forward and backward; the param
    # tree and the numerics are unchanged (JAX: TANWithText(remat=True))
    remat: bool = False

    @property
    def text_embed_dim(self) -> int:
        return {"bert": 768, "word2vec": 512}[self.language_model]


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Loss options (reference train/loss.py:55-373)."""

    model: str = "init"  # 'init' (Stage 1) or 'cotrain' (Stage 2, the EMA twin's targets)
    sim: str = "cos"
    temperature: float = 0.07
    learn_agreement: bool = False  # Stage-2 agreement self-labelling (losses/agreement.py)
    temporal_agreement_type: str = "keep"  # 'i' | 'u' | 'keep' | 'keep-joint'
    iou_threshold: float = 0.5
    confidence_quantile: float = 0.3
    loss_threshold: float = 0.0
    use_alignability_head: bool = False
    optim_policy: str = "default"  # 'default' | 'bce' (head-only finetune)
    alignability_layer: int = 2  # the joint head trains on this layer (loss.py:341)
    mask_value: float = -6.0e4  # fp16/bf16-safe -inf substitute (loss.py:98-100)
    # MIL-NCE logsumexps from the feature outputs (ModelConfig.fused_milnce)
    # through ops/milnce.py; the [B,S,T,B,N] logits then never exist
    use_fused_milnce: bool = False


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Fixed-shape data options: sentences pad to ``max_sentences`` and tokens
    to ``max_words`` (reference default 32, model/word2vec_model.py:28)."""

    seq_len: int = 64  # training window (train/config.py:12)
    max_sentences: int = 16
    max_words: int = 32


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization (reference train/config.py:6-53, train/main.py:330-356,486-499)."""

    lr: float = 1.0e-4
    wd: float = 1.0e-5
    warmup_iterations: int = 1000
    total_iterations: int = 100_000
    backprop_freq: int = 1  # gradient accumulation
    clip_grad_norm: float = 0.0  # 0 = off
    clip_mode: str = "per_param"  # 'per_param' (utils/train_utils.py:3-13) or 'global'
    skip_nonfinite_updates: bool = False  # optax.apply_if_finite semantics
    ema_momentum: float = 0.999  # the Stage-2 target's m (tan_model.py:340-344)
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """Zero-shot eval options (reference: eval/eval_zeroshot_align.py:97-252)."""

    seq_len: int = 64
    method: str = "overlap-seq"  # 'overlap-seq' or 'global'
    alignability_layer: int = 2  # "3rd layer works the best" (eval_zeroshot_align.py:186)
    # windows per forward call of the overlap-seq canvas and of the retrieval
    # (whole clips of num_clips windows); the global method batches videos up
    # to the same token count (batch_windows * seq_len)
    batch_windows: int = 256
    global_buckets: int = 3  # method='global': videos split into <= this many length buckets
    num_clips: int = 10  # YC2 retrieval: staggered windows per clip (eval_zeroshot_retrieval.py)
