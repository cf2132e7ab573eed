"""The train step: forward, loss, backward, update and, for Stage 2, the EMA
twin (counterpart of temporalalignnet_tpu/train/train_step.py:85-89,102-169).

The forward runs under the compute dtype (``torch.autocast`` to bf16 on the
card, nothing on the CPU), the loss in f32 from the f32 logits or the
kernels' f32 logsumexps, and the update on the f32 params.  Every attention
and, with the fused loss, every MIL-NCE logsumexp goes through the Hopper
kernels forward and backward.  Metrics stay on the device as 0-d tensors;
``grad_norm`` is the global norm of the raw gradients (``optax.global_norm``
of the JAX step).

Stage 2 (``LossConfig.model == 'cotrain'``) adds ``EMATwin``, the target of
the reference's TwinTemporalAligner (tan_model.py:315-351): a second
TANWithText whose no-grad, deterministic forward feeds ``get_loss`` under
``ema-<key>`` and whose params follow the online ones by momentum after
every optimizer step (train/main.py:112-122).

Batch dict (fixed shapes): video [B, T, Cv] f32, video_padding_mask [B, T]
bool, input_ids [B, N, W] int, text_padding_mask [B, N] bool, start, end
[B, N] f32, abs_text_pos [B, N, 2] f32.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Optional

import numpy as np
import torch

from temporalalignnet_torch.core.config import LossConfig, TrainConfig
from temporalalignnet_torch.losses.tan_loss import get_loss
from temporalalignnet_torch.models.net import TANWithText
from temporalalignnet_torch.train.optimizer import Optimizer, global_norm


class EMATwin:
    """The Stage-2 target: a copy of the online model that no gradient
    reaches, moved after each train step by t <- t·m + o·(1 - m).

    ``model`` starts as a true copy of the online weights (tan_model.py:
    335-338), sharing no storage with them; its params do not require grad
    and it stays in ``eval()``.  ``update`` counts micro-steps as the JAX
    step counts ``state.step + 1``: with ``backprop_freq = k`` the momentum
    applies every k-th call and the other calls leave the target bit-equal
    (m = 1).  It moves on every such call, also where the optimizer skipped
    a non-finite update, as in JAX.  Buffers are copied, not averaged."""

    def __init__(self, online: TANWithText, train_cfg: TrainConfig):
        self.model = copy.deepcopy(online).eval().requires_grad_(False)
        for p in self.model.parameters():
            p.grad = None
        self.momentum = train_cfg.ema_momentum
        self.backprop_freq = train_cfg.backprop_freq
        self.micro_steps = 0

    def __call__(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The deterministic forward (no random pos start, tan_model.py:333),
        under the caller's autocast; draws nothing from any generator."""
        with torch.no_grad():
            return self.model(
                batch["video"], batch["input_ids"].long(),
                video_padding_mask=batch["video_padding_mask"].bool(),
                lang_padding_mask=batch["text_padding_mask"].bool(), deterministic=True)

    @torch.no_grad()
    def update(self, online: TANWithText) -> None:
        """The momentum update from the online model's post-update params, in
        f32 as the JAX step (m and 1 - m rounded to f32 first)."""
        self.micro_steps += 1
        if self.micro_steps % self.backprop_freq:
            return
        m = np.float32(self.momentum)
        target = list(self.model.parameters())
        torch._foreach_mul_(target, float(m))
        torch._foreach_add_(target, [p.detach() for p in online.parameters()],
                            alpha=float(np.float32(1.0) - m))
        for t, o in zip(self.model.buffers(), online.buffers()):
            t.copy_(o)


def make_train_step(
    model: TANWithText,
    optimizer: Optimizer,
    train_cfg: TrainConfig,
    loss_cfg: LossConfig,
    compute_dtype: torch.dtype = torch.float32,
    twin: Optional[EMATwin] = None,
) -> Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]:
    """``step(batch) -> metrics``; the random pos starts draw from a CPU
    ``torch.Generator`` seeded with ``train_cfg.seed``.  ``twin`` (an
    ``EMATwin`` of ``model``) is required for ``loss_cfg.model == 'cotrain'``
    and refused otherwise; the caller keeps it to save its weights."""
    if loss_cfg.use_fused_milnce != model.cfg.fused_milnce:
        raise ValueError("LossConfig.use_fused_milnce and ModelConfig.fused_milnce must agree")
    if (twin is not None) != (loss_cfg.model == "cotrain"):
        raise ValueError("an EMATwin goes with LossConfig.model='cotrain', and only with it")
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
            if twin is not None:
                outputs.update({f"ema-{k}": v for k, v in twin(batch).items()})
        loss, metrics = get_loss(outputs, batch, loss_cfg)
        optimizer.zero_grad()
        loss.backward()
        grads = [p.grad for p in optimizer.grad_params if p.grad is not None]
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = global_norm(grads)
        optimizer.step()
        if twin is not None:
            twin.update(model)
        return metrics

    return step

