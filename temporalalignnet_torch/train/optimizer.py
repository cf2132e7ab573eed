"""AdamW with the reference's param groups, warmup + cosine schedule, clipping,
non-finite skipping and gradient accumulation (counterpart of
temporalalignnet_tpu/train/optimizer.py, whose optax chain is
``MultiSteps(apply_if_finite(multi_transform(chain(clip, adamw))))``).

- No weight decay for biases and the ``ln_*`` LayerNorm params
  (train/main.py:330-356); the frozen word2vec ``word_embd`` gets no update;
  the ``bce`` policy trains only ``binary_head`` (main.py:345-352).
- lr: linear warmup from 0, then cosine decay to 0 (main.py:486-499).  It
  counts optimizer updates, not micro-steps, so the first update has lr 0,
  as optax evaluates the schedule at its update count.
- Clipping of the (averaged) gradient: per parameter,
  ``coef = min(max / (‖g‖ + 1e-6), 1)`` (utils/train_utils.py:3-13), or by the
  global norm as ``optax.clip_by_global_norm``.
- ``skip_nonfinite_updates``: ``optax.apply_if_finite(max_consecutive_errors=100)``:
  a non-finite gradient skips the update and leaves the moments and the
  schedule alone, until 100 consecutive ones let the update through.
- ``backprop_freq = k``: ``optax.MultiSteps``: the k micro-step gradients are
  averaged (Welford mean, as optax) and one update is applied every k.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from temporalalignnet_torch.core.config import TrainConfig

MAX_CONSECUTIVE_ERRORS = 100


def no_decay(name: str) -> bool:
    """Biases and LayerNorm params skip weight decay (main.py:332)."""
    parts = name.split(".")
    return (parts[-1].endswith("bias") or any(p.startswith("ln_") for p in parts)
            or "logit_scale" in parts or "entropy_scale" in parts)


def trainable(name: str, policy: str) -> bool:
    if "word_embd" in name:  # frozen word2vec embedding
        return False
    return "binary_head" in name if policy == "bce" else True


def lr_at(cfg: TrainConfig, update: int) -> float:
    """lr · (update / warmup) during warmup, then lr · ½(1 + cos(π · progress)),
    in float32 as the JAX schedule computes it."""
    f = np.float32
    step = f(update)
    if update < cfg.warmup_iterations:
        return float(f(cfg.lr) * (step / f(cfg.warmup_iterations)))
    progress = (step - f(cfg.warmup_iterations)) / f(
        max(cfg.total_iterations - cfg.warmup_iterations, 1))
    return float(f(cfg.lr) * (f(0.5) * (f(1.0) + np.cos(f(np.pi) * progress))))


class Optimizer:
    """Call ``step()`` after every backward (micro-step); it applies an update
    every ``backprop_freq`` calls.  ``updates`` counts applied updates."""

    def __init__(self, model: torch.nn.Module, cfg: TrainConfig, policy: str = "default"):
        self.cfg = cfg
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        self.grad_params: List[torch.nn.Parameter] = [p for _, p in named]
        self.params = [p for n, p in named if trainable(n, policy)]
        decay = [p for n, p in named if trainable(n, policy) and not no_decay(n)]
        rest = [p for n, p in named if trainable(n, policy) and no_decay(n)]
        groups = [g for g in ({"params": decay, "weight_decay": cfg.wd},
                              {"params": rest, "weight_decay": 0.0}) if g["params"]]
        self.adamw = torch.optim.AdamW(groups, lr=0.0, betas=(0.9, 0.999), eps=1e-8)
        self.updates = 0
        self.micro = 0
        self.notfinite = 0
        self._acc = None

    def zero_grad(self) -> None:
        for p in self.grad_params:
            p.grad = None

    def state_dict(self) -> dict:
        return {"adamw": self.adamw.state_dict(), "updates": self.updates, "micro": self.micro,
                "notfinite": self.notfinite}

    @torch.no_grad()
    def step(self) -> bool:
        """Returns whether an update was applied."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.grad_params]
        k = self.cfg.backprop_freq
        if k > 1:
            if self._acc is None:
                self._acc = [torch.zeros_like(g) for g in grads]
            for a, g in zip(self._acc, grads):
                a.add_((g - a) / (self.micro + 1))
            self.micro += 1
            if self.micro < k:
                return False
            grads, self._acc, self.micro = self._acc, None, 0
        if self.cfg.skip_nonfinite_updates:
            finite = bool(torch.stack([torch.isfinite(g).all() for g in grads]).all())
            self.notfinite = 0 if finite else self.notfinite + 1
            if not finite and self.notfinite <= MAX_CONSECUTIVE_ERRORS:
                return False
        by_param = dict(zip(map(id, self.grad_params), grads))
        train = [by_param[id(p)] for p in self.params]
        if self.cfg.clip_grad_norm > 0:
            mx = self.cfg.clip_grad_norm
            if self.cfg.clip_mode == "per_param":
                train = [g * torch.clamp(mx / (torch.linalg.vector_norm(g.float()) + 1e-6),
                                         max=1.0) for g in train]
            else:
                norm = global_norm(train)
                train = [torch.where(norm < mx, g, g / norm * mx) for g in train]
        for p, g in zip(self.params, train):
            p.grad = g
        for group in self.adamw.param_groups:
            group["lr"] = lr_at(self.cfg, self.updates)
        self.adamw.step()
        self.updates += 1
        return True


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors]))
