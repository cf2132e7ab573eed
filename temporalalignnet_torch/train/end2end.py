"""End-to-end S3D fine-tuning on HTM-AA (counterpart of
temporalalignnet_tpu/train/end2end.py; reference end2end/main_nce.py):

- ``S3DWithText``: the S3D video tower with the word2vec text tower inside
  it as ``text_module``, as the reference's S3D holds its
  Sentence_Embedding (s3dg.py:186-305), so the module's state_dict is the
  ``s3d_howto100m.pth`` key space;
- ``nce_loss``: the symmetric InfoNCE over in-batch negatives and its top-1
  accuracies (main_nce.py:30-47), in f32;
- ``make_e2e_train_step``: clips [B, n, T, H, W, 3] and ids [B, n, W]
  flattened to B·n (main_nce.py:75-77), the forward under autocast to the
  compute dtype (bf16 on the card, f32 on the CPU, as JAX picks bf16 on a
  TPU and f32 elsewhere), the loss in f32, backward, the optimizer; with
  ``train_bn_stats`` the BN running statistics move in the forward;
  ``grad_norm`` is the global norm of every gradient, the zeros of the
  frozen params included (``optax.global_norm``);
- ``make_e2e_optimizer``: AdamW under the ``e2e`` policy of
  ``train/optimizer.py`` (no decay for biases and BN, decay for the frozen
  params too), the ``lr_at`` warm-up + cosine schedule, and the
  ``backprop_freq`` accumulator (``optax.MultiSteps``).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from temporalalignnet_torch.core.config import TrainConfig
from temporalalignnet_torch.models.s3d import S3D
from temporalalignnet_torch.models.word2vec import Word2VecEncoder
from temporalalignnet_torch.train.optimizer import Optimizer, global_norm


def nce_loss(video_emb: torch.Tensor, text_emb: torch.Tensor, temperature: float = 0.07
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """[B, C] x [B, C] -> (loss, {'loss', 'top1/v2t', 'top1/t2v'}), f32."""
    logits = video_emb.float() @ text_emb.float().T / temperature
    labels = torch.arange(logits.shape[0], device=logits.device)
    loss = (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels)) / 2.0
    metrics = {
        "loss": loss.detach(),
        "top1/v2t": (logits.argmax(-1) == labels).float().mean(),
        "top1/t2v": (logits.argmax(0) == labels).float().mean(),
    }
    return loss, metrics


class S3DWithText(S3D):
    """S3D plus ``text_module``; ``forward(x)`` is the video embedding
    [B, num_classes], ``text_embed(ids)`` the sentence embedding;
    ``init_weights`` draws the text tower's matrices as the Linear ones
    (LeCun normal)."""

    def __init__(self, num_classes: int = 512, vocab_size: int = 66251,
                 freeze_early: bool = False, train_bn_stats: bool = False,
                 fold_s2d: bool = True):
        super().__init__(num_classes, freeze_early=freeze_early,
                         train_bn_stats=train_bn_stats, fold_s2d=fold_s2d)
        self.text_module = Word2VecEncoder(vocab_size=vocab_size, output_dim=num_classes)

    def text_embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.text_module(input_ids, (input_ids != 0).int())


def make_e2e_optimizer(model: S3DWithText, cfg: TrainConfig) -> Optimizer:
    """AdamW over every param of ``model`` under the ``e2e`` rules.  Not
    ``capturable`` on the card: the e2e step has no grouped dispatch, and its
    update stays the host-side AdamW's, bias corrections in double (the
    card-vs-CPU update check holds it to 1e-6, past which the capturable
    one's float32 corrections reach at the first step)."""
    return Optimizer(model, cfg, policy="e2e", capturable=False)


def make_e2e_train_step(model: S3DWithText, optimizer: Optimizer, temperature: float = 0.07,
                        compute_dtype: torch.dtype = torch.float32
                        ) -> Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]:
    """``step(batch) -> metrics`` (0-d tensors on the device)."""
    device = model.fc.weight.device
    autocast = compute_dtype != torch.float32

    def step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        clips = batch["clips"].to(device, non_blocking=True)
        ids = batch["input_ids"].to(device, non_blocking=True)
        clips = clips.reshape((-1,) + tuple(clips.shape[2:]))  # [B·n, T, H, W, 3]
        ids = ids.reshape(-1, ids.shape[-1]).long()
        model.train()
        with torch.autocast(device.type, dtype=compute_dtype, enabled=autocast):
            video = model(clips.permute(0, 4, 1, 2, 3))  # channels_last_3d, no copy
            text = model.text_embed(ids)
        loss, metrics = nce_loss(video, text, temperature)
        optimizer.zero_grad()
        loss.backward()
        metrics["grad_norm"] = global_norm(
            [p.grad for p in optimizer.grad_params if p.grad is not None])
        optimizer.step()
        return metrics

    return step
