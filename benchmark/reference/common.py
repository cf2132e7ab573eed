"""Pieces the plain references share: the precision of their products, the
weights a configuration is drawn with, AdamW with the warm-up + cosine
schedule, and the numbers a run compares.

Plain PyTorch only.  Nothing here imports the program under test.
"""

from __future__ import annotations

import math
import statistics
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

FP8_MAX = 448.0  # the largest finite float8_e4m3fn


class _FakeFp8(torch.autograd.Function):
    """x rounded to float8_e4m3fn under one per-tensor scale (amax to 448),
    returned in float32; the gradient passes unchanged."""

    @staticmethod
    def forward(ctx, x):
        amax = x.detach().abs().amax().float().clamp(min=1e-30)
        scale = amax / FP8_MAX
        return ((x.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


class Precision:
    """How the reference's products see their operands: ``f32`` as they
    are, ``fp8`` (the control) each operand rounded to float8_e4m3fn first,
    the products then summed in float32."""

    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8"):
            raise ValueError(f"precision {kind!r}: f32 or fp8")
        self.kind = kind

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.kind == "f32" else _FakeFp8.apply(x)


def exact_matmuls() -> None:
    """float32 products in float32: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def draw_weights(shapes: Dict[str, Tuple[int, ...]], rule: Callable, seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """One float32 tensor per name, drawn from ``seed`` on ``device`` in one
    call: ``rule(name, shape)`` gives ("normal", std) or ("const", value);
    the normal leaves are consecutive slices of one standard-normal draw."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    plan = {n: rule(n, s) for n, s in shapes.items()}
    total = sum(math.prod(s) for n, s in shapes.items() if plan[n][0] == "normal")
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        kind, value = plan[name]
        n = math.prod(shape)
        if kind == "normal":
            out[name] = flat[at:at + n].view(shape) * value
            at += n
        else:
            out[name] = torch.full(shape, float(value), device=device)
    return out


def lr_at(lr: float, warmup: int, total: int, update: int) -> float:
    """lr · update / warmup, then lr · ½(1 + cos(π · progress)), in float32."""
    f = np.float32
    step = f(update)
    if update < warmup:
        return float(f(lr) * (step / f(warmup)))
    progress = (step - f(warmup)) / f(max(total - warmup, 1))
    return float(f(lr) * (f(0.5) * (f(1.0) + np.cos(f(np.pi) * progress))))


class AdamW:
    """torch.optim.AdamW's arithmetic (betas 0.9, 0.999, eps 1e-8, decoupled
    decay), written out, over named float32 leaves: ``decay(name)`` says
    whether a leaf decays, ``frozen`` names leaves it leaves alone."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, wd: float, warmup: int,
                 total: int, decay: Callable[[str], bool], frozen: Iterable[str] = ()):
        self.params = params
        self.frozen = set(frozen)
        self.lr, self.wd, self.warmup, self.total = lr, wd, warmup, total
        self.decay = decay
        self.m = {n: torch.zeros_like(p) for n, p in params.items() if n not in self.frozen}
        self.v = {n: torch.zeros_like(p) for n, p in params.items() if n not in self.frozen}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        lr = lr_at(self.lr, self.warmup, self.total, self.t)
        self.t += 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        bc1, bc2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for n, p in self.params.items():
            if n in self.frozen:
                continue
            g = grads.get(n)
            g = torch.zeros_like(p) if g is None else g
            if self.decay(n):
                p.mul_(1 - lr * self.wd)
            self.m[n].lerp_(g, 1 - b1)
            self.v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (self.v[n].sqrt() / math.sqrt(bc2)).add_(eps)
            p.addcdiv_(self.m[n], denom, value=-lr / bc1)


PACKED = ("in_proj_weight", "in_proj_bias")  # q, k and v stacked on the first axis


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The norm of each leaf; a packed q, k, v projection counts as three
    leaves (``name[q]``, ``name[k]``, ``name[v]``), as the reference's
    attention holds them: a key's bias has no gradient under softmax, its
    query's and value's have."""
    out = {}
    for n, t in tensors.items():
        t = t.detach().double()
        if n.endswith(PACKED):
            for part, x in zip("qkv", t.chunk(3, 0)):
                out[f"{n}[{part}]"] = float(x.norm())
        else:
            out[n] = float(t.norm())
    return out


def moving_leaves(grad_norms: Dict[str, float]) -> List[str]:
    """The leaves whose first gradient in the reference is at least a
    thousandth of the median leaf's: the others move under Adam by
    round-off alone."""
    median = statistics.median(grad_norms.values())
    return [n for n, g in grad_norms.items() if g >= 1e-3 * median]


def leaf_gaps(program: Dict[str, float], reference: Dict[str, float],
              keep: Optional[List[str]] = None) -> Dict[str, float]:
    """|‖program‖ − ‖reference‖| of each leaf against the larger of the
    reference leaf's norm and the median leaf's (``keep``: the leaves that
    count)."""
    names = list(reference) if keep is None else keep
    median = statistics.median(reference[n] for n in names)
    return {n: abs(program[n] - reference[n]) / max(reference[n], median, 1e-30) for n in names}


def training_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers a training cell compares, from two readings, each a dict
    with ``losses`` (the first steps' losses), ``grad1`` (leaf norms of the
    first gradient), ``group_grad`` (leaf norms of the gradients that the
    last group of steps fed AdamW, as ``drivers.common.group_gradient``
    reads them) and ``change`` (leaf norms of the parameters' change over
    the first steps):

    - ``loss_gap``: the worst step's |loss − reference| / |reference|;
    - ``grad1_median_gap``, ``group_grad_median_gap``: the median leaf's
      gap of those gradients (the worst leaf's swings with the alignability
      labels that flip at near-ties; PERF.md gives its readings);
    - ``change_gap``: the worst leaf's gap of the change, over the leaves
      that ``moving_leaves`` keeps."""
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], ref["losses"]))
    out = {"loss_gap": loss_gap}
    for key in ("grad1", "group_grad"):
        out[f"{key}_median_gap"] = statistics.median(leaf_gaps(prog[key], ref[key]).values())
    change = leaf_gaps(prog["change"], ref["change"], moving_leaves(ref["grad1"]))
    out["change_gap"] = max(change.values())
    return out


def leaf_report(prog: dict, ref: dict, top: int = 4) -> dict:
    """The leaves behind the numbers: for the gradients and the change, the
    worst leaf's gap (``worst_gap``), the ``top`` worst leaves (gap,
    reference norm, program norm) and the median leaf's norm."""
    out = {}
    for key, keep in (("grad1", None), ("group_grad", None),
                      ("change", moving_leaves(ref["grad1"]))):
        gaps = leaf_gaps(prog[key], ref[key], keep)
        worst = sorted(gaps, key=gaps.get, reverse=True)[:top]
        out[key] = {"worst_gap": gaps[worst[0]],
                    "median_norm": statistics.median(ref[key][n] for n in gaps),
                    "worst": [[n, gaps[n], ref[key][n], prog[key][n]] for n in worst]}
    return out
