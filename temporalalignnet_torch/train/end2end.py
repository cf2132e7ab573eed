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
- data parallelism (``group``): each rank steps on its videos of the global
  batch; ``nce_loss`` takes every rank's embeddings as the negatives
  (gathered with their gradients) and returns the rank's share of the
  global loss (``losses/tan_loss.py`` derives the shares), the BNs of
  ``train_bn_stats`` normalise with the global batch statistics, the rank
  backprops world · share and the gradients are averaged over the ranks
  before the optimizer (``train_step.average_gradients``);
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
from temporalalignnet_torch.parallel.distributed import (all_gather, all_reduce_sum, rank,
                                                         world_size)
from temporalalignnet_torch.train.optimizer import Optimizer, global_norm
from temporalalignnet_torch.train.train_step import average_gradients


def nce_loss(video_emb: torch.Tensor, text_emb: torch.Tensor, temperature: float = 0.07,
             group=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """[B, C] x [B, C] -> (loss, {'loss', 'top1/v2t', 'top1/t2v'}), f32.

    With ``group`` the rows are this rank's B of the global batch: v2t over
    its videos and t2v over its texts, each against every rank's other
    modality; the loss carries the global value and the gradient of this
    rank's share, and the metrics are the global batch's."""
    if group is None:
        logits = video_emb.float() @ text_emb.float().T / temperature
        labels = torch.arange(logits.shape[0], device=logits.device)
        loss = (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels)) / 2.0
        metrics = {
            "loss": loss.detach(),
            "top1/v2t": (logits.argmax(-1) == labels).float().mean(),
            "top1/t2v": (logits.argmax(0) == labels).float().mean(),
        }
        return loss, metrics
    video, text = video_emb.float(), text_emb.float()
    B = video.shape[0]
    total = B * world_size(group)
    labels = rank(group) * B + torch.arange(B, device=video.device)
    v2t = video @ all_gather(text, 0, group).T / temperature  # [B, B_all]
    t2v = text @ all_gather(video, 0, group).T / temperature
    share = (F.cross_entropy(v2t, labels, reduction="sum")
             + F.cross_entropy(t2v, labels, reduction="sum")) / (2.0 * total)
    sums = all_reduce_sum(torch.stack([
        share.detach(), (v2t.argmax(-1) == labels).float().sum() / total,
        (t2v.argmax(-1) == labels).float().sum() / total]), group)
    loss = share + (sums[0] - share.detach())
    return loss, {"loss": sums[0], "top1/v2t": sums[1], "top1/t2v": sums[2]}


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
                        compute_dtype: torch.dtype = torch.float32, group=None
                        ) -> Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]:
    """``step(batch) -> metrics`` (0-d tensors on the device); with ``group``
    the batch is this rank's videos of the global batch."""
    device = model.fc.weight.device
    autocast = compute_dtype != torch.float32
    model.sync_batch_stats(group)
    world = world_size(group) if group is not None else 1

    def step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        clips = batch["clips"].to(device, non_blocking=True)
        ids = batch["input_ids"].to(device, non_blocking=True)
        clips = clips.reshape((-1,) + tuple(clips.shape[2:]))  # [B·n, T, H, W, 3]
        ids = ids.reshape(-1, ids.shape[-1]).long()
        model.train()
        with torch.autocast(device.type, dtype=compute_dtype, enabled=autocast):
            video = model(clips.permute(0, 4, 1, 2, 3))  # channels_last_3d, no copy
            text = model.text_embed(ids)
        loss, metrics = nce_loss(video, text, temperature, group)
        optimizer.zero_grad()
        (loss * world if group is not None else loss).backward()
        grads = [p.grad for p in optimizer.grad_params if p.grad is not None]
        average_gradients(grads, group)
        metrics["grad_norm"] = global_norm(grads)
        optimizer.step()
        return metrics

    return step
