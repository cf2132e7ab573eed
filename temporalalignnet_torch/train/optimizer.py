"""AdamW with the reference's param groups, warmup + cosine schedule, clipping,
non-finite skipping and gradient accumulation (counterpart of
temporalalignnet_tpu/train/optimizer.py, whose optax chain is
``MultiSteps(apply_if_finite(multi_transform(chain(clip, adamw))))``).

- No weight decay for biases and the ``ln_*`` LayerNorm params
  (train/main.py:330-356); the frozen word2vec ``word_embd`` gets no update;
  the ``bce`` policy trains only ``binary_head`` (main.py:345-352).  The
  ``e2e`` policy is the end-to-end S3D fine-tune's (JAX
  train/end2end.py:168-185): no decay for biases and ``bn*`` params, and
  every param in the update, frozen ones too (the word embedding, the
  ``freeze_early`` stages): they get a zero gradient, so AdamW's decoupled
  decay still shrinks them, as optax's ``adamw`` does.
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

Under tensor parallelism (a model that holds its shard,
``parallel/tensor.py``) clipping sees whole parameters, as JAX clips its
global arrays: a sharded parameter's squared norm is summed over the tp
ranks, a replicated one counts once; AdamW's moments are sharded like their
parameters, and ``state_dict`` / ``load_state_dict`` gather them and the
``backprop_freq`` accumulator to the full shapes and shard them again (a
collective over the tp ranks).

On the card (``capturable``, the default where the params lie on a CUDA
device) an update issues device work only, so a CUDA graph can hold it
(``train_step.make_multi_train_step``): AdamW runs with ``capturable=True``
and its lr is a device scalar, filled with ``lr_at`` per update, or, once
``lr_from_table`` was called (before a capture), read from a device table
of ``lr_at`` at a device update count.  Capturable AdamW computes its bias
corrections on the device in float32 where the other computes them on the
host in double, so every card run of the trainer, grouped or not, takes
this one mode, and differs from the CPU's update by float32 rounding.  The
Python counters ``updates``, ``micro`` and ``notfinite`` go on counting on
the host.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from temporalalignnet_torch.core.config import TrainConfig
from temporalalignnet_torch.parallel import tensor as tp_ops
from temporalalignnet_torch.parallel.distributed import _all_reduce, rank, world_size

MAX_CONSECUTIVE_ERRORS = 100


def no_decay(name: str, policy: str = "default") -> bool:
    """Biases and LayerNorm params skip weight decay (main.py:332); under
    ``e2e`` biases and BN params (main_nce.py:252-272)."""
    parts = name.split(".")
    if policy == "e2e":
        return parts[-1] == "bias" or any(p.startswith("bn") for p in parts)
    return (parts[-1].endswith("bias") or any(p.startswith("ln_") for p in parts)
            or "logit_scale" in parts or "entropy_scale" in parts)


def trainable(name: str, policy: str) -> bool:
    if policy == "e2e":
        return True
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


def lr_table(cfg: TrainConfig, device) -> torch.Tensor:
    """[total_iterations + 1] float32 on ``device``: ``lr_at(cfg, u)`` of
    every update u a run of ``cfg`` makes."""
    return torch.tensor([lr_at(cfg, u) for u in range(cfg.total_iterations + 1)],
                        dtype=torch.float32, device=device)


class Optimizer:
    """Call ``step()`` after every backward (micro-step); it applies an update
    every ``backprop_freq`` calls.  ``updates`` counts applied updates.
    ``capturable`` (None: where the params lie on a CUDA device) issues an
    update as device work only (the module's docstring)."""

    def __init__(self, model: torch.nn.Module, cfg: TrainConfig, policy: str = "default",
                 capturable: Optional[bool] = None):
        self.cfg = cfg
        named = [(n, p) for n, p in model.named_parameters()
                 if p.requires_grad or policy == "e2e"]
        self.grad_params: List[torch.nn.Parameter] = [p for _, p in named]
        self.params = [p for n, p in named if trainable(n, policy)]
        decay = [(n, p) for n, p in named if trainable(n, policy) and not no_decay(n, policy)]
        rest = [(n, p) for n, p in named if trainable(n, policy) and no_decay(n, policy)]
        groups = [g for g in ({"params": [p for _, p in decay], "weight_decay": cfg.wd},
                              {"params": [p for _, p in rest], "weight_decay": 0.0})
                  if g["params"]]
        # the names of AdamW's param indices and of the accumulator's entries
        self._names = [n for n, _ in decay + rest]
        self._grad_names = [n for n, _ in named]
        self.tp_group = tp_ops.model_tp_group(model)
        self._sharded = [tp_ops.is_sharded(p) for p in self.params]
        device = self.grad_params[0].device if self.grad_params else torch.device("cpu")
        self.capturable = device.type == "cuda" if capturable is None else capturable
        if self.capturable:
            self._lr = torch.zeros((), dtype=torch.float32, device=device)
        self._lr_table = self._u = None  # lr_from_table's
        self.adamw = torch.optim.AdamW(groups, lr=self._lr if self.capturable else 0.0,
                                       betas=(0.9, 0.999), eps=1e-8,
                                       capturable=self.capturable)
        self.updates = 0
        self.micro = 0
        self.notfinite = 0
        self._acc = None

    def lr_from_table(self) -> None:
        """From now on read each update's lr from a device table of ``lr_at``
        at a device update count, so that a CUDA graph of ``step`` reads
        every replay's own.  The table is computed on the host (a device
        cosine would differ from NumPy's float32 in the last bit) and ends
        at ``total_iterations`` (``check_lr_table``)."""
        self._lr_table = lr_table(self.cfg, self._lr.device)
        self._u = torch.full((1,), self.updates, dtype=torch.long, device=self._lr.device)

    def check_lr_table(self, updates: int) -> None:
        """Raise where ``updates`` more updates would read past the device lr
        table (a replayed graph reads it unchecked)."""
        if self.updates + updates > self._lr_table.numel():
            raise ValueError(
                f"updates {self.updates} + {updates} run past the lr table of total_iterations "
                f"{self.cfg.total_iterations}: a graphed run stops at total_iterations")

    def zero_grad(self) -> None:
        for p in self.grad_params:
            p.grad = None

    def _map_shards(self, state: dict, fn) -> dict:
        """``state`` with ``fn(name, tensor)`` applied to AdamW's moments and
        the accumulator's entries (the counters as they are)."""
        adamw = state["adamw"]
        moments = {i: {k: fn(self._names[i], v) if torch.is_tensor(v) and v.dim() else v
                       for k, v in s.items()} for i, s in adamw["state"].items()}
        acc = state["acc"]
        return dict(state, adamw=dict(adamw, state=moments),
                    acc=None if acc is None else [fn(n, a) for n, a in zip(self._grad_names, acc)])

    def state_dict(self) -> dict:
        """Everything an exact resume needs: AdamW's moments, the counters,
        and the accumulator of a part-done ``backprop_freq`` cycle; under
        tensor parallelism gathered to the full shapes."""
        state = {"adamw": self.adamw.state_dict(), "updates": self.updates, "micro": self.micro,
                 "notfinite": self.notfinite, "acc": self._acc}
        if self.tp_group is None:
            return state
        return self._map_shards(state, lambda n, x: tp_ops.gather_tensor(n, x, self.tp_group))

    def load_state_dict(self, state: dict) -> None:
        if self.tp_group is not None:  # a full state: this rank's shard of it
            r, tp = rank(self.tp_group), world_size(self.tp_group)
            state = self._map_shards(state, lambda n, x: tp_ops.shard_tensor(n, x, r, tp))
        adamw = state["adamw"]  # this optimizer's mode, whichever device wrote the state
        adamw = dict(adamw, param_groups=[dict(g, capturable=self.capturable)
                                          for g in adamw["param_groups"]])
        self.adamw.load_state_dict(adamw)
        self.updates, self.micro, self.notfinite = (
            int(state["updates"]), int(state["micro"]), int(state["notfinite"]))
        if self._u is not None:
            self._u.fill_(self.updates)
        acc = state["acc"]
        self._acc = None if acc is None else [
            a.to(p.device, p.dtype, copy=True) for a, p in zip(acc, self.grad_params)]

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
                norms = [torch.linalg.vector_norm(g.float()) for g in train]
                if self.tp_group is not None:  # a sharded parameter's whole norm
                    norms = whole_norms(norms, self._sharded, self.tp_group).unbind()
                train = [g * torch.clamp(mx / (n + 1e-6), max=1.0)
                         for g, n in zip(train, norms)]
            else:
                norm = global_norm(train, self._sharded, self.tp_group)
                train = [torch.where(norm < mx, g, g / norm * mx) for g in train]
        for p, g in zip(self.params, train):
            p.grad = g
        if self._lr_table is not None:
            self.check_lr_table(1)
            self._lr.copy_(self._lr_table.index_select(0, self._u)[0])
            self._u += 1
        elif self.capturable:
            self._lr.fill_(lr_at(self.cfg, self.updates))
        lr = self._lr if self.capturable else lr_at(self.cfg, self.updates)
        for group in self.adamw.param_groups:
            group["lr"] = lr
        self.adamw.step()
        self.updates += 1
        return True


def whole_norms(norms, sharded, tp_group) -> torch.Tensor:
    """[n]: each norm of a shard made its whole parameter's (the squares
    summed over the tp ranks, one all-reduce); a replicated one as it is."""
    norms = torch.stack(list(norms))
    mask = torch.tensor(sharded, device=norms.device)
    summed = _all_reduce(torch.where(mask, norms.square(), 0.0), dist.ReduceOp.SUM, tp_group)
    return torch.where(mask, summed.sqrt(), norms)


def global_norm(tensors, sharded=None, tp_group=None) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm); under
    tensor parallelism (``tp_group``, with ``sharded`` per tensor) of the
    whole parameters."""
    norms = torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors])
    if tp_group is None:
        return torch.linalg.vector_norm(norms)
    return torch.linalg.vector_norm(whole_norms(norms.unbind(), sharded, tp_group))
