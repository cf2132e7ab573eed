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

Tensor parallelism (a model that holds its shard, ``parallel/tensor.py``):
``group`` is the dp group (the loss's global batch, the gradient average);
the tp ranks of a replica run the same rows, each its shard of the encoder
blocks.  The replicated params' gradients, equal on the tp ranks up to the
order of a kernel's sums, are averaged over the tp group too, so that those
params stay bit-equal there; the EMA twin is a copy of the sharded model,
sharded alike; ``grad_norm`` is the whole params' norm.

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
from temporalalignnet_torch.parallel import tensor as tp_ops
from temporalalignnet_torch.parallel.distributed import average_, world_size
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
    tp_group = tp_ops.model_tp_group(model)

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
        with_grad = [p for p in optimizer.grad_params if p.grad is not None]
        grads = [p.grad for p in with_grad]
        average_gradients(grads, group)
        sharded = [tp_ops.is_sharded(p) for p in with_grad]
        if tp_group is not None:  # the replicated params stay equal on the tp ranks
            average_gradients([g for g, s in zip(grads, sharded) if not s], tp_group)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = global_norm(grads, sharded, tp_group)
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


def check_graphable(model: TANWithText, group=None) -> None:
    """Raise where a CUDA graph cannot hold the train step: a process group
    that is not NCCL's (a gloo collective is host code, by design: gloo is
    the port's host-collective stand-in) and a tensor-parallel model (its
    graph would hold NCCL collectives over two or more ranks, one a card,
    and no such run has been made).  ``--backprop_freq > 1`` and
    ``--skip_nonfinite`` pass: no step branches on data on the host (the
    optimizer counts on the device, and which kind of step comes next is
    the host's count of steps, ``GraphedStep``)."""
    if group is not None:
        import torch.distributed as dist

        backend = dist.get_backend(group)
        if backend != "nccl":
            raise ValueError(
                f"grouped dispatch on the card captures the step's collectives in a CUDA "
                f"graph: a {backend} collective is host code, which a graph cannot hold (use "
                "NCCL, or --steps_per_dispatch 1)")
    if tp_ops.model_tp_group(model) is not None:
        raise ValueError("grouped dispatch on the card takes no tensor-parallel model (--tp "
                         "> 1): its graph would hold NCCL collectives over two or more "
                         "ranks, one a card, which no run has checked; its steps run one at "
                         "a time (--steps_per_dispatch 1)")


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
    group).  ``multi.generator`` is the step's; ``multi.updates_after`` is
    ``optimizer.updates`` after each step of the last group, a [len(batches)]
    tensor on the device (``fetch_group`` reads both in one copy).

    On the CPU a group is that many eager steps.  On the card
    (``GraphedStep``) the first batches are eager steps, at least
    ``GraphedStep.WARMUP`` and at least one ``backprop_freq`` cycle; then
    the whole step (``step.run``: forward, loss, backward, the optimizer's
    micro-step and, in Stage 2, the EMA) is captured in a CUDA graph on
    static input buffers, once per kind of step: with ``backprop_freq`` k >
    1 an accumulate-only step and an accumulate-and-emit step (two graphs
    in one memory pool), else one.  Each later batch is one replay of its
    kind's graph; a shorter tail group is fewer replays.  Whether a step
    emits is the host's count of steps, not data; the optimizer's counters
    that depend on data (applied updates, consecutive non-finite updates)
    and the Welford divisor live on the device (``Optimizer``, the device
    form), so ``--backprop_freq > 1`` and ``--skip_nonfinite`` replay as
    any step does.  A failed capture raises; the card never falls back to
    eager steps.  The graph holds device work only, so what the host does
    per step runs per replay outside it: the pos-start draws (all of a
    group's, in step order, copied in one pinned transfer) and the
    counts of steps (``Optimizer.next_micro``, ``EMATwin.micro_steps``).  A
    replay passes no kernel wrapper, so the wrappers' launch counts hold
    the eager steps' launches and the captures'.  A group that could run
    past ``total_iterations``, where the device lr table ends, is refused.
    Under an NCCL process group the graph holds the step's collectives too
    (the text all-gather, the column-logsumexp merges, the ``milnce_dt``
    reduce-scatter, the loss statistics, the gradient average), each on
    buffers of the graph's pool, the same on every replay.  The card
    refuses a gloo group and a tensor-parallel model
    (``check_graphable``); the CPU runs its eager steps under any group."""
    step = make_train_step(model, optimizer, train_cfg, loss_cfg, compute_dtype, twin, group)
    if step.device.type == "cuda":
        check_graphable(model, group)
        if not optimizer.capturable:
            raise ValueError("a CUDA graph of the train step takes a capturable Optimizer")
        multi = GraphedStep(step)
    else:
        def multi(batches):
            rows, counts = [], []
            for b in batches:
                rows.append(step(b))
                counts.append(optimizer.updates)
            multi.updates_after = torch.tensor(counts)
            return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
    multi.generator = step.generator
    return multi


def fetch_group(metrics: Dict[str, torch.Tensor], updates_after: torch.Tensor):
    """A group's metrics ({name: [K]}) and update counts ([K]) on the host in
    one copy (float64: exact for both).  Returns ({name: [K] float64}, [K]
    ints)."""
    host = torch.cat([torch.stack([v.double() for v in metrics.values()]),
                      updates_after.double()[None]]).cpu()
    return dict(zip(metrics, host[:-1])), host[-1].long().tolist()


def _read_counts() -> Dict[str, Dict[str, int]]:
    """Every kernel's launch count (under "") and its counts by route."""
    return {name: {"": fn.launches, **fn.launches_by_route} for name, fn in kernels().items()}


class GraphedStep:
    """One train step (``make_train_step``'s) captured in a CUDA graph per
    kind of step and replayed per batch.

    The first ``warmup`` batches (WARMUP, and at least one ``backprop_freq``
    cycle, so that every kind of step ran) are eager steps on a side
    stream, which train as any step does and leave made what a capture must
    not make (cuBLAS's handles, the kernels' libraries).  The next batch's
    shapes fix the static buffers, on which ``step.run`` is captured once
    per kind (``kinds``: whether the step emits an update); that batch and
    every later one is a replay.  A capture trains nothing (its device work
    is recorded, not run), so the counts of steps it advanced on the host
    are set back.  ``launches_per_step`` is what the wrappers counted at a
    capture (they count no replay)."""

    WARMUP = 2

    def __init__(self, step):
        self.step = step
        k = step.optimizer.cfg.backprop_freq
        self.kinds = (False, True) if k > 1 else (True,)
        self.warmup = max(self.WARMUP, k)
        self.graphs = {}
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
                self.counts.append(step.optimizer._u.clone())
        main.wait_stream(side)
        for r in rows + self.counts:
            r.record_stream(main)
        self.names = list(metrics)
        self.warm += len(batches)
        return rows

    def _capture(self, batch: Dict[str, torch.Tensor], random_starts: bool) -> None:
        step, dev = self.step, self.step.device
        opt, twin = step.optimizer, step.twin
        k = opt.cfg.backprop_freq
        if twin is not None and twin.micro_steps % k != opt.micro:
            raise ValueError("the EMA twin and the optimizer count their micro-steps apart")
        self.static = {key: v.to(dev, copy=True) for key, v in batch.items()}
        self.pos = torch.zeros(3, dtype=torch.long, device=dev) if random_starts else None
        counters = (opt.micro, opt._bound, twin.micro_steps if twin is not None else 0)
        pool = torch.cuda.graph_pool_handle()
        before = _read_counts()
        for emits in self.kinds:
            opt.micro = k - 1 if emits else 0  # the host branches of this kind of step
            if twin is not None:
                twin.micro_steps = opt.micro
            opt.zero_grad()
            graph = torch.cuda.CUDAGraph()
            # thread_local: the loader's threads may pin host memory meanwhile
            with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
                metrics = step.run(self.static, self.pos)
                row = torch.stack([v.float() for v in metrics.values()])
            self.graphs[emits] = graph, row
        after = _read_counts()
        n = len(self.kinds)
        self.launches_per_step = {name: {r: (after[name][r] - before[name][r]) // n
                                         for r in after[name]} for name in after}
        opt.micro, opt._bound = counters[:2]
        if twin is not None:
            twin.micro_steps = counters[2]

    def __call__(self, batches: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
        step, dev = self.step, self.step.device
        opt = step.optimizer
        self.counts = []
        rows = []
        n = min(self.warmup - self.warm, len(batches))
        if n > 0:
            rows = self._warm_up(batches[:n])
            batches = batches[n:]
        if batches:
            starts = [step.draw(b) for b in batches]  # on the host, in step order
            if not self.graphs:
                self._capture(batches[0], starts[0] is not None)
            for b in batches:
                if b.keys() != self.static.keys() or any(
                        b[k].shape != v.shape or b[k].dtype != v.dtype
                        for k, v in self.static.items()):
                    raise ValueError("a graphed train step takes batches of one shape and dtype")
            opt.check_lr_table(opt.emits_in(len(batches)))
            if self.pos is not None:
                starts = torch.tensor(starts).pin_memory().to(dev, non_blocking=True)
            for i, b in enumerate(batches):
                for k, v in self.static.items():
                    v.copy_(b[k], non_blocking=True)
                if self.pos is not None:
                    self.pos.copy_(starts[i])
                graph, row = self.graphs[opt.emits_next()]
                graph.replay()
                rows.append(row.clone())
                opt.next_micro()
                self.counts.append(opt._u.clone())
                if step.twin is not None:
                    step.twin.micro_steps += 1
        self.updates_after = torch.cat(self.counts)
        rows = torch.stack(rows)
        return {k: rows[:, j] for j, k in enumerate(self.names)}
