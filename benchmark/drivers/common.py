"""What the drivers share: the program's weights from the benchmark's draw,
pinned pools, the gradients AdamW took and the reference's follow-up of the
first steps."""

from __future__ import annotations

import time
from typing import Callable, Dict, List

import torch

from ..reference.common import AdamW, leaf_norms


class Marks:
    """Seconds from one mark to the next (where set-up goes, on stderr)."""

    def __init__(self):
        self.last, self.items = time.perf_counter(), []

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.items.append((name, now - self.last))
        self.last = now


def module_with(cls_fn: Callable[[], torch.nn.Module], weights: Dict[str, torch.Tensor],
                device) -> torch.nn.Module:
    """The program's module built on the host (its own draw of weights is
    thrown away: building under ``torch.device("meta")`` imports much of
    torch's compiler stack, seconds more), then given the benchmark's
    weights on ``device`` (strict)."""
    module = cls_fn().to_empty(device=device)
    module.load_state_dict(weights, strict=True)
    return module


def pinned(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in batch.items():
        host = torch.empty(v.shape, dtype=v.dtype, pin_memory=torch.cuda.is_available())
        out[k] = host.copy_(v)
    return out


def nonfinite(x: torch.Tensor) -> torch.Tensor:
    return (~torch.isfinite(x.float())).sum()


def first_moments(adamw: torch.optim.Optimizer, params: Dict[str, torch.Tensor],
                  names: List[str]) -> Dict[str, torch.Tensor]:
    """AdamW's first moment of each leaf (zeros where it has none yet)."""
    out = {}
    for n in names:
        m = adamw.state.get(params[n], {}).get("exp_avg")
        out[n] = torch.zeros_like(params[n]) if m is None else m.detach().clone()
    return out


def group_gradient(before: Dict[str, torch.Tensor], after: Dict[str, torch.Tensor],
                   steps: int) -> Dict[str, float]:
    """Leaf norms of the gradients a group of ``steps`` updates fed AdamW,
    from its first moment before and after them (m ← 0.9 m + 0.1 g each
    update): (m_after − 0.9^steps m_before) / 0.1 = Σ_j 0.9^(steps−1−j) g_j.
    From zero moments and one step, the first gradient itself."""
    decay = 0.9 ** steps
    return leaf_norms({n: (after[n].double() - decay * before[n].double()) / 0.1
                       for n in after})


def follow(params: Dict[str, torch.Tensor], steps: int, loss_and_grads: Callable,
           optimizer: AdamW, names: List[str], group: int) -> dict:
    """The reference's first ``steps`` steps from ``params`` (changed in
    place): each step's loss, the first gradient's leaf norms, the last
    ``group`` steps' gradients as ``group_gradient`` reads them, and the
    parameters' change, all over ``names``."""
    start = {n: params[n].detach().clone() for n in names}
    losses, grad1, before = [], None, None
    for i in range(steps):
        if i == steps - group:
            before = {n: optimizer.m[n].clone() for n in names}
        loss, grads = loss_and_grads(params, i)
        losses.append(float(loss))
        if i == 0:
            grad1 = leaf_norms({n: grads.get(n, torch.zeros_like(params[n])) for n in names})
        optimizer.step(grads)
    change = leaf_norms({n: params[n] - start[n] for n in names})
    return {"losses": losses, "grad1": grad1,
            "group_grad": group_gradient(before, {n: optimizer.m[n] for n in names}, group),
            "change": change}
