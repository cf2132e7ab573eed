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
device) a micro-step issues device work only and makes no host
synchronisation, so a CUDA graph can hold it
(``train_step.make_multi_train_step``), with either flag:
- AdamW runs with ``capturable=True``; its lr is a device scalar read from
  a device table of ``lr_at`` (computed on the host: a device cosine would
  differ from NumPy's float32 in the last bit) at the device count of
  applied updates, ``_u``.  The table ends at ``total_iterations``: the host
  counts the emit steps, a bound of ``_u``, and refuses to read past it
  (``check_lr_table``).  Capturable AdamW computes its bias corrections on
  the device in float32 where the other computes them on the host in
  double, so every card run of the trainer, grouped or not, takes this one
  mode.
- ``updates`` and ``notfinite`` are device counters (reading them is a host
  sync); ``micro`` stays on the host, since whether a micro-step emits an
  update depends on the step count only (``emits_next``, ``next_micro``).
- The accumulator is a static buffer, zeroed in place at the emit step; the
  Welford divisor is read from a device micro-step count.
- The non-finite check is a device flag; the update runs whatever it says
  and is then undone by selection (``torch.where``) where it says skip:
  the params, AdamW's moments and its step count, and ``_u`` stay as they
  were, bit for bit.  AdamW's state is made (zero, as its first step makes
  it) at construction, so that a skipped first update leaves it zero too.
This form also runs on the CPU (``capturable=True``), with AdamW's own
host-side mode, so that the tests hold it against optax.
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
    ``capturable`` (None: where the params lie on a CUDA device) issues a
    micro-step as device work only (the module's docstring)."""

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
        self.micro = 0
        self._acc = None
        if not self.capturable:
            self.adamw = torch.optim.AdamW(groups, lr=0.0, betas=(0.9, 0.999), eps=1e-8)
            self._u = self._notfinite = 0
            return
        self._lr = torch.zeros((), dtype=torch.float32, device=device)
        self.adamw = torch.optim.AdamW(groups, lr=self._lr, betas=(0.9, 0.999), eps=1e-8,
                                       capturable=device.type == "cuda")
        self._ordered = [p for g in self.adamw.param_groups for p in g["params"]]
        self._lr_table = lr_table(cfg, device)
        self._u = torch.zeros(1, dtype=torch.long, device=device)  # the lr table's index
        self._notfinite = torch.zeros((), dtype=torch.long, device=device)
        self._bound = 0  # the host's count of emit steps: the most _u can hold
        if cfg.backprop_freq > 1:
            self._acc = [torch.zeros_like(p) for p in self.grad_params]
            self._micro_d = torch.zeros((), dtype=torch.long, device=device)
        self._fill_state()
        self._keep = ([torch.empty_like(t) for t in self._guarded()]
                      if cfg.skip_nonfinite_updates else None)

    @property
    def updates(self) -> int:
        """Applied updates (in the device form a read of the device count)."""
        return int(self._u)

    @updates.setter
    def updates(self, n: int) -> None:
        if self.capturable:
            self._u.fill_(n)
            self._bound = n
        else:
            self._u = n

    @property
    def notfinite(self) -> int:
        """Consecutive non-finite updates (``optax.apply_if_finite``'s count)."""
        return int(self._notfinite)

    @notfinite.setter
    def notfinite(self, n: int) -> None:
        if self.capturable:
            self._notfinite.fill_(n)
        else:
            self._notfinite = n

    def emits_next(self) -> bool:
        """Whether the next micro-step ends a ``backprop_freq`` cycle."""
        return self.micro + 1 == self.cfg.backprop_freq

    def emits_in(self, steps: int) -> int:
        """How many of the next ``steps`` micro-steps end a cycle."""
        return (self.micro + steps) // self.cfg.backprop_freq

    def next_micro(self) -> bool:
        """The host's count of one micro-step (``step`` makes it; a replayed
        CUDA graph of a step makes it in its place); returns whether the
        micro-step ended a cycle."""
        emits = self.emits_next()
        self.micro = 0 if emits else self.micro + 1
        if emits and self.capturable:
            self.check_lr_table(1)
            self._bound += 1
        return emits

    def check_lr_table(self, updates: int) -> None:
        """Raise where ``updates`` more updates could read past the device lr
        table (a replayed graph reads it unchecked)."""
        if self._bound + updates > self._lr_table.numel():
            raise ValueError(
                f"updates {self._bound} + {updates} run past the lr table of total_iterations "
                f"{self.cfg.total_iterations}: a run on the card stops at total_iterations")

    def zero_grad(self) -> None:
        for p in self.grad_params:
            p.grad = None

    def _guarded(self) -> List[torch.Tensor]:
        """What an update moves besides AdamW's step counts: the params, then
        their first and second moments."""
        state = self.adamw.state
        return (self._ordered + [state[p]["exp_avg"] for p in self._ordered]
                + [state[p]["exp_avg_sq"] for p in self._ordered])

    def _fill_state(self) -> None:
        """AdamW's state of every param that has none, made as its first step
        makes it (zero moments, step 0) through ``load_state_dict``, which
        puts each tensor where AdamW's mode wants it."""
        sd = self.adamw.state_dict()
        missing = {i: {"step": torch.tensor(0.0), "exp_avg": torch.zeros_like(p),
                       "exp_avg_sq": torch.zeros_like(p)}
                   for i, p in enumerate(self._ordered) if i not in sd["state"]}
        if missing:
            self.adamw.load_state_dict(dict(sd, state={**sd["state"], **missing}))

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
        and the accumulator of a part-done ``backprop_freq`` cycle (None at a
        cycle's end); under tensor parallelism gathered to the full shapes."""
        state = {"adamw": self.adamw.state_dict(), "updates": self.updates, "micro": self.micro,
                 "notfinite": self.notfinite,
                 "acc": None if self.micro == 0 else [a.clone() for a in self._acc]}
        if self.tp_group is None:
            return state
        return self._map_shards(state, lambda n, x: tp_ops.gather_tensor(n, x, self.tp_group))

    def load_state_dict(self, state: dict) -> None:
        """Before the first step of a CUDA graph: the device form's AdamW
        state is replaced."""
        if self.tp_group is not None:  # a full state: this rank's shard of it
            r, tp = rank(self.tp_group), world_size(self.tp_group)
            state = self._map_shards(state, lambda n, x: tp_ops.shard_tensor(n, x, r, tp))
        adamw = state["adamw"]  # this optimizer's mode, whichever device wrote the state
        capturable = self.adamw.defaults["capturable"]
        adamw = dict(adamw, param_groups=[dict(g, capturable=capturable)
                                          for g in adamw["param_groups"]])
        self.adamw.load_state_dict(adamw)
        self.micro = int(state["micro"])
        self.updates, self.notfinite = int(state["updates"]), int(state["notfinite"])
        acc = state["acc"]
        if not self.capturable:
            self._acc = None if acc is None else [
                a.to(p.device, p.dtype, copy=True) for a, p in zip(acc, self.grad_params)]
            return
        self._fill_state()
        if self._acc is not None:
            for i, a in enumerate(self._acc):
                a.zero_() if acc is None else a.copy_(acc[i])
            self._micro_d.fill_(self.micro)

    @torch.no_grad()
    def step(self) -> bool:
        """Returns whether an update was applied; in the device form whether
        the micro-step ended a cycle (the device decides whether its update
        applies)."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.grad_params]
        if self.capturable:
            return self._device_step(grads)
        if self.cfg.backprop_freq > 1:
            if self._acc is None:
                self._acc = [torch.zeros_like(g) for g in grads]
            for a, g in zip(self._acc, grads):
                a.add_((g - a) / (self.micro + 1))
            if not self.next_micro():
                return False
            grads, self._acc = self._acc, None
        if self.cfg.skip_nonfinite_updates:
            finite = bool(torch.stack([torch.isfinite(g).all() for g in grads]).all())
            self.notfinite = 0 if finite else self.notfinite + 1
            if not finite and self.notfinite <= MAX_CONSECUTIVE_ERRORS:
                return False
        self._update(grads, lr_at(self.cfg, self.updates))
        self.updates += 1
        return True

    def _device_step(self, grads: List[torch.Tensor]) -> bool:
        """``step`` as device work: the Welford mean over a static
        accumulator, the lr from the table, and under
        ``skip_nonfinite_updates`` the update undone where the device flag
        says skip (the module's docstring)."""
        emits = self.next_micro()
        if self._acc is not None:
            diff = torch._foreach_sub(grads, self._acc)
            torch._foreach_div_(diff, (self._micro_d + 1).float())
            torch._foreach_add_(self._acc, diff)
            if not emits:
                self._micro_d += 1
                return False
            self._micro_d.zero_()
            grads = self._acc
        self._lr.copy_(self._lr_table.index_select(0, self._u)[0])
        if self._keep is None:
            self._update(grads, self._lr)
            self._u += 1
        else:
            # x·0 is NaN exactly where x is not finite
            zeros = torch._foreach_mul(grads, 0.0)
            finite = torch.isfinite(torch.stack(torch._foreach_norm(zeros))).all()
            self._notfinite.copy_(torch.where(finite, 0, self._notfinite + 1))
            apply = finite | (self._notfinite > MAX_CONSECUTIVE_ERRORS)
            moved = self._guarded()
            torch._foreach_copy_(self._keep, moved)
            self._update(grads, self._lr)
            self._undo_unless(apply, moved)
            self._u += apply
        if self._acc is not None:
            torch._foreach_zero_(self._acc)
        return True

    def _undo_unless(self, apply: torch.Tensor, moved: List[torch.Tensor]) -> None:
        """Where the device flag ``apply`` is false, ``moved`` (``_guarded``)
        back to the copy in ``_keep`` and AdamW's step counts back by one.
        A select, not a product with the flag: a NaN that the update made
        goes too."""
        for t, kept in zip(moved, self._keep):
            torch.where(apply, t, kept, out=t)
        steps = [self.adamw.state[p]["step"] for p in self._ordered]
        torch._foreach_sub_(steps, [(~apply).float()] * len(steps))

    def _update(self, grads: List[torch.Tensor], lr) -> None:
        """Clip the (averaged) gradients and take AdamW's step at ``lr``."""
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
        for group in self.adamw.param_groups:
            group["lr"] = lr
        self.adamw.step()


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
