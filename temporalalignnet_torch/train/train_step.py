"""The Stage-1 train step: forward, loss, backward and update (counterpart of
temporalalignnet_tpu/train/train_step.py:102-169).

The forward runs under the compute dtype (``torch.autocast`` to bf16 on the
card, nothing on the CPU), the loss in f32 from the f32 logits or the
kernels' f32 logsumexps, and the update on the f32 params.  Every attention
and, with the fused loss, every MIL-NCE logsumexp goes through the Hopper
kernels forward and backward.  Metrics stay on the device as 0-d tensors;
``grad_norm`` is the global norm of the raw gradients (``optax.global_norm``
of the JAX step).  The EMA twin of Stage 2 comes with slice 3.

Batch dict (fixed shapes): video [B, T, Cv] f32, video_padding_mask [B, T]
bool, input_ids [B, N, W] int, text_padding_mask [B, N] bool, start, end
[B, N] f32, abs_text_pos [B, N, 2] f32.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from temporalalignnet_torch.core.config import LossConfig, TrainConfig
from temporalalignnet_torch.losses.tan_loss import get_loss
from temporalalignnet_torch.models.net import TANWithText
from temporalalignnet_torch.train.optimizer import Optimizer, global_norm


def make_train_step(
    model: TANWithText,
    optimizer: Optimizer,
    train_cfg: TrainConfig,
    loss_cfg: LossConfig,
    compute_dtype: torch.dtype = torch.float32,
) -> Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]:
    """``step(batch) -> metrics``; the random pos starts draw from a CPU
    ``torch.Generator`` seeded with ``train_cfg.seed``."""
    if loss_cfg.use_fused_milnce != model.cfg.fused_milnce:
        raise ValueError("LossConfig.use_fused_milnce and ModelConfig.fused_milnce must agree")
    device = model.video_pre_proj.weight.device
    generator = torch.Generator().manual_seed(train_cfg.seed)
    autocast = compute_dtype != torch.float32

    def step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        batch = {k: v.to(device, non_blocking=True) for k, v in batch.items()}
        model.train()
        with torch.autocast(device.type, dtype=compute_dtype, enabled=autocast):
            outputs = model(
                batch["video"], batch["input_ids"].long(),
                video_padding_mask=batch["video_padding_mask"].bool(),
                lang_padding_mask=batch["text_padding_mask"].bool(),
                deterministic=False, generator=generator,
            )
        loss, metrics = get_loss(outputs, batch, loss_cfg)
        optimizer.zero_grad()
        loss.backward()
        grads = [p.grad for p in optimizer.grad_params if p.grad is not None]
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = global_norm(grads)
        optimizer.step()
        return metrics

    return step

