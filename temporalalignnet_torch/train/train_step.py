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

Data parallelism (``group``, a process group): each rank runs the step on
its rows of the global batch, backprops ``world · l_r`` (its share of the
global loss, ``losses/tan_loss.py``) and averages the gradients over the
ranks with one all-reduce of a flat buffer (``average_gradients``) before
the optimizer, so every rank holds the same params, optimizer state and
EMA twin.  The reduction runs with any group, one rank included.  The
explicit all-reduce stands in for ``DistributedDataParallel``: the twin's
params never get a gradient and DDP's hooks reorder the reductions.

Batch dict (fixed shapes): video [B, T, Cv] f32, video_padding_mask [B, T]
bool, input_ids [B, N, W] int, text_padding_mask [B, N] bool, start, end
[B, N] f32, abs_text_pos [B, N, 2] f32.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from temporalalignnet_torch.core.config import LossConfig, TrainConfig
from temporalalignnet_torch.losses.tan_loss import get_loss
from temporalalignnet_torch.models.net import TANWithText
from temporalalignnet_torch.ops import kernels
from temporalalignnet_torch.parallel.distributed import average_, world_size
from temporalalignnet_torch.train.optimizer import Optimizer, global_norm

GRAPH_WORK = "grouped dispatch under a process group (ROADMAP Queue A 6)"


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

    def __call__(self, batch: Dict[str, torch.Tensor], group=None) -> Dict[str, torch.Tensor]:
        """The deterministic forward (no random pos start, tan_model.py:333),
        under the caller's autocast; draws nothing from any generator."""
        with torch.no_grad():
            return self.model(
                batch["video"], batch["input_ids"].long(),
                video_padding_mask=batch["video_padding_mask"].bool(),
                lang_padding_mask=batch["text_padding_mask"].bool(), deterministic=True,
                group=group)

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

    def state_dict(self) -> dict:
        """The micro-step count; the weights go with the checkpoint's
        ``target.*`` keys."""
        return {"micro_steps": self.micro_steps}

    def load_state_dict(self, state: dict) -> None:
        self.micro_steps = int(state["micro_steps"])


def average_gradients(grads: List[torch.Tensor], group) -> None:
    """The gradients averaged over the ranks of ``group`` in place, through
    one all-reduce of a flat buffer (every rank passes the same tensors)."""
    if group is None or not grads:
        return
    flat = average_(torch.cat([g.reshape(-1) for g in grads]), group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def make_train_step(
    model: TANWithText,
    optimizer: Optimizer,
    train_cfg: TrainConfig,
    loss_cfg: LossConfig,
    compute_dtype: torch.dtype = torch.float32,
    twin: Optional[EMATwin] = None,
    group=None,
) -> Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]:
    """``step(batch) -> metrics``; the random pos starts draw from a CPU
    ``torch.Generator`` seeded with ``train_cfg.seed``, which the step keeps
    as ``step.generator`` (a resume restores its state).  ``twin`` (an
    ``EMATwin`` of ``model``) is required for ``loss_cfg.model == 'cotrain'``
    and refused otherwise; the caller keeps it to save its weights.

    The step is the host's draw of the pos starts (``step.draw(batch)``:
    three ints or None, ``TemporalAligner.draw_pos_starts``) and the device
    work (``step.run(batch, pos_starts)`` on a batch on the device), which
    issues no host synchronisation and, given the starts as a device
    tensor, no copy from the host: ``make_multi_train_step`` captures it in
    a CUDA graph.

    With ``group`` the batch is this rank's rows of the global batch and
    the step is the data-parallel one (the module docstring); the metrics
    are the global batch's on every rank."""
    if loss_cfg.use_fused_milnce != model.cfg.fused_milnce:
        raise ValueError("LossConfig.use_fused_milnce and ModelConfig.fused_milnce must agree")
    if (twin is not None) != (loss_cfg.model == "cotrain"):
        raise ValueError("an EMATwin goes with LossConfig.model='cotrain', and only with it")
    device = model.video_pre_proj.weight.device
    generator = torch.Generator().manual_seed(train_cfg.seed)
    autocast = compute_dtype != torch.float32
    world = world_size(group) if group is not None else 1

    def draw(batch: Dict[str, torch.Tensor]) -> Optional[torch.Tensor]:
        return model.draw_pos_starts(batch["video"].shape[1], batch["input_ids"].shape[1],
                                     generator)

    def run(batch: Dict[str, torch.Tensor], pos_starts) -> Dict[str, torch.Tensor]:
        model.train()
        with torch.autocast(device.type, dtype=compute_dtype, enabled=autocast):
            outputs = model(
                batch["video"], batch["input_ids"].long(),
                video_padding_mask=batch["video_padding_mask"].bool(),
                lang_padding_mask=batch["text_padding_mask"].bool(),
                deterministic=False, pos_starts=pos_starts, group=group,
            )
            if twin is not None:
                outputs.update({f"ema-{k}": v for k, v in twin(batch, group).items()})
        loss, metrics = get_loss(outputs, batch, loss_cfg, group)
        optimizer.zero_grad()
        (loss * world if group is not None else loss).backward()
        grads = [p.grad for p in optimizer.grad_params if p.grad is not None]
        average_gradients(grads, group)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = global_norm(grads)
        optimizer.step()
        if twin is not None:
            twin.update(model)
        return metrics

    def step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        batch = {k: v.to(device, non_blocking=True) for k, v in batch.items()}
        return run(batch, draw(batch))

    step.generator = generator
    step.draw, step.run = draw, run
    step.model, step.optimizer, step.twin, step.device = model, optimizer, twin, device
    step.group = group
    return step


def make_multi_train_step(
    model: TANWithText,
    optimizer: Optimizer,
    train_cfg: TrainConfig,
    loss_cfg: LossConfig,
    compute_dtype: torch.dtype = torch.float32,
    twin: Optional[EMATwin] = None,
    group=None,
) -> Callable[[List[Dict[str, torch.Tensor]]], Dict[str, torch.Tensor]]:
    """``multi(batches) -> metrics``, each a [len(batches)] tensor on the
    device: the train steps of a group (``--steps_per_dispatch``), equal to
    as many ``make_train_step`` steps in order (counterpart of JAX
    train/train_step.py::make_multi_train_step, a ``lax.scan`` over the
    group).  ``multi.generator`` is the step's; ``multi.updates_after``
    lists ``optimizer.updates`` after each step of the last group.

    On the CPU a group is that many eager steps.  On the card
    (``GraphedStep``) the first ``GraphedStep.WARMUP`` batches are eager
    steps; then one whole step (``step.run``: forward, loss, backward,
    update and, in Stage 2, the EMA) is captured in a CUDA graph on static
    input buffers, and each later batch is one replay.  A shorter tail
    group is fewer replays.  A failed capture raises; the card never falls
    back to eager steps.  The graph holds device work only, so what the host
    does per step runs per replay outside it: the pos-start draws (all of a
    group's, in step order, copied in one pinned transfer) and the training
    counters that a step advances in Python (``optimizer.updates``,
    ``EMATwin.micro_steps``).  A replay passes no kernel wrapper, so the
    wrappers' launch counts hold the eager steps' launches and the
    capture's, once.  ``--backprop_freq > 1`` and ``--skip_nonfinite``
    branch on the host per step and are refused on the card, and so is a
    group that would run past ``total_iterations``, where the device lr
    table ends (``Optimizer.lr_from_table``).  Under a process group the
    card refuses grouped dispatch (capturing the collectives is later work);
    the CPU runs its eager steps, data-parallel."""
    step = make_train_step(model, optimizer, train_cfg, loss_cfg, compute_dtype, twin, group)
    if step.device.type == "cuda":
        if group is not None:
            raise ValueError(f"grouped dispatch on the card under a process group comes with "
                             f"{GRAPH_WORK}")
        if train_cfg.backprop_freq != 1 or train_cfg.skip_nonfinite_updates:
            raise ValueError(
                "grouped dispatch on the card captures one update per step: --backprop_freq "
                "> 1 and --skip_nonfinite branch on the host per step (they come with "
                "ROADMAP 'Kernel and card work' item 2)")
        multi = GraphedStep(step)
    else:
        def multi(batches):
            rows = []
            multi.updates_after = []
            for b in batches:
                rows.append(step(b))
                multi.updates_after.append(optimizer.updates)
            return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
    multi.generator = step.generator
    return multi


def _read_counts() -> Dict[str, Dict[str, int]]:
    """Every kernel's launch count (under "") and its counts by route."""
    return {name: {"": fn.launches, **fn.launches_by_route} for name, fn in kernels().items()}


class GraphedStep:
    """One train step (``make_train_step``'s) captured in a CUDA graph and
    replayed per batch.

    The first WARMUP batches are eager steps on a side stream, which train
    as any step does and leave made what a capture must not make (cuBLAS's
    handles, the kernels' libraries, AdamW's state).  The next batch's
    shapes fix the static buffers, on which ``step.run`` is captured once;
    that batch and every later one is a replay.  The capture trains
    nothing, so the counters it advanced in Python are set back.
    ``launches_per_step`` is what the wrappers counted at capture (they
    count no replay)."""

    WARMUP = 2

    def __init__(self, step):
        self.step = step
        self.graph = None
        self.warm = 0

    def _warm_up(self, batches: List[Dict[str, torch.Tensor]]) -> List[torch.Tensor]:
        step, dev = self.step, self.step.device
        main, side = torch.cuda.current_stream(dev), torch.cuda.Stream(dev)
        side.wait_stream(main)
        rows = []
        with torch.cuda.stream(side):
            for b in batches:
                metrics = step(b)
                rows.append(torch.stack([v.float() for v in metrics.values()]))
                self.updates_after.append(step.optimizer.updates)
        main.wait_stream(side)
        for r in rows:
            r.record_stream(main)
        self.names = list(metrics)
        self.warm += len(batches)
        return rows

    def _capture(self, batch: Dict[str, torch.Tensor], random_starts: bool) -> None:
        step, dev = self.step, self.step.device
        opt, twin = step.optimizer, step.twin
        self.static = {k: v.to(dev, copy=True) for k, v in batch.items()}
        self.pos = torch.zeros(3, dtype=torch.long, device=dev) if random_starts else None
        opt.lr_from_table()
        opt.zero_grad()
        counters = (opt.updates, twin.micro_steps if twin is not None else 0)
        before = _read_counts()
        graph = torch.cuda.CUDAGraph()
        # thread_local: the loader's threads may pin host memory meanwhile
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            metrics = step.run(self.static, self.pos)
            self.row = torch.stack([v.float() for v in metrics.values()])
        after = _read_counts()
        self.launches_per_step = {n: {r: after[n][r] - before[n][r] for r in after[n]}
                                  for n in after}
        opt.updates = counters[0]
        if twin is not None:
            twin.micro_steps = counters[1]
        self.graph = graph

    def __call__(self, batches: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
        step, dev = self.step, self.step.device
        self.updates_after = []
        rows = []
        n = min(self.WARMUP - self.warm, len(batches))
        if n > 0:
            rows = self._warm_up(batches[:n])
            batches = batches[n:]
        if batches:
            starts = [step.draw(b) for b in batches]  # on the host, in step order
            if self.graph is None:
                self._capture(batches[0], starts[0] is not None)
            for b in batches:
                if b.keys() != self.static.keys() or any(
                        b[k].shape != v.shape or b[k].dtype != v.dtype
                        for k, v in self.static.items()):
                    raise ValueError("a graphed train step takes batches of one shape and dtype")
            step.optimizer.check_lr_table(len(batches))
            if self.pos is not None:
                starts = torch.tensor(starts).pin_memory().to(dev, non_blocking=True)
            for i, b in enumerate(batches):
                for k, v in self.static.items():
                    v.copy_(b[k], non_blocking=True)
                if self.pos is not None:
                    self.pos.copy_(starts[i])
                self.graph.replay()
                rows.append(self.row.clone())
                step.optimizer.updates += 1
                self.updates_after.append(step.optimizer.updates)
                if step.twin is not None:
                    step.twin.micro_steps += 1
        rows = torch.stack(rows)
        return {k: rows[:, j] for j, k in enumerate(self.names)}
