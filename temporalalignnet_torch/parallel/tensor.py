"""Tensor parallelism of the TAN's encoder blocks (Megatron's column- and
row-parallel layers; the tensor-parallel part of
temporalalignnet_tpu/parallel/mesh.py, whose ``_TP_RULES`` shard over the
``model`` axis).

What is sharded is exactly what ``_TP_RULES`` shard (mesh.py:165-186 there),
in the port's key space: in every ``resblocks.<i>`` block of a
``TemporalEncoder``

- ``attn.in_proj_weight`` / ``attn.in_proj_bias`` (the packed q, k, v):
  column-parallel by heads.  The packed ``[3D, D]`` holds the rows of q, k
  and v one after the other, so a rank takes its block of heads of each of
  the three, ``[3 · D/tp, D]``, not a contiguous third;
- ``attn.out_proj.weight``: row-parallel (``[D, D/tp]``);
- ``mlp.c_fc.weight`` / ``mlp.c_fc.bias``: column-parallel;
- ``mlp.c_proj.weight``: row-parallel.

Everything else is replicated: the LayerNorms, the row-parallel biases
(``out_proj.bias``, ``c_proj.bias``), the projections and heads of the
aligner, and the text towers (the BERT tower's ``attention.self.query``
matches no rule, as its Flax path matches none of JAX's).

The two operators are autograd Functions: ``copy_to_tp`` (identity forward,
all-reduce of the gradient backward) before a column-parallel layer and
``reduce_from_tp`` (all-reduce forward, identity backward) after a
row-parallel one.  ``row_parallel_linear`` sums the ranks' partial
products in f32 and adds the replicated bias once, after the reduce: added
on every rank before it, it would count tp times.

``tp_shard_state_dict`` / ``tp_gather_state_dict`` map a whole state_dict
(any prefix: ``online.``, ``target.``) to a rank's shard and back;
``shard_model_`` makes a model hold its shard (``transformer.MultiheadSelf
Attention`` and ``MLP`` keep the group and run their shard), after which its
parameters know whether they are sharded (``is_sharded``), for the
optimizer's norms and the gradient average.  A tensor-parallel run saves the
gathered state (the tp = 1 key space and shapes) and shards it again on
resume.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from temporalalignnet_torch.parallel.distributed import _all_reduce, rank, world_size

_BLOCK = r"(?:^|\.)resblocks\.\d+\."
_QKV = re.compile(_BLOCK + r"attn\.in_proj_(?:weight|bias)$")
_COLUMN = re.compile(_BLOCK + r"mlp\.c_fc\.(?:weight|bias)$")
_ROW = re.compile(_BLOCK + r"(?:attn\.out_proj|mlp\.c_proj)\.weight$")


def tp_dim(key: str) -> Optional[int]:
    """The dim a parameter is sharded along (0 column-parallel, 1
    row-parallel), or None where it is replicated."""
    if _QKV.search(key) or _COLUMN.search(key):
        return 0
    if _ROW.search(key):
        return 1
    return None


def check_tp(width: int, heads: int, tp: int, mlp_ratio: int = 4) -> None:
    """Refuse a tp that does not divide the heads, the width and the MLP's
    hidden width (GSPMD would pad; the port shards evenly or not at all)."""
    for what, n in (("heads", heads), ("width", width), (f"{mlp_ratio} x width",
                                                         mlp_ratio * width)):
        if n % tp:
            raise ValueError(f"--tp {tp} does not divide the {what} ({n}): tensor parallelism "
                             "shards the heads and the MLP evenly")


def shard_tensor(key: str, x: torch.Tensor, r: int, tp: int) -> torch.Tensor:
    """Rank r's shard of the full tensor ``key`` (a replicated one as it is)."""
    if _QKV.search(key):  # [3D, ...]: this rank's heads of q, of k and of v
        three = x.reshape(3, x.shape[0] // 3, *x.shape[1:])
        n = three.shape[1] // tp
        return three[:, r * n:(r + 1) * n].reshape(3 * n, *x.shape[1:]).clone()
    dim = tp_dim(key)
    if dim is None:
        return x
    return x.chunk(tp, dim)[r].clone()


def tp_shard_state_dict(sd: Dict[str, torch.Tensor], tp_rank: int, tp: int
                        ) -> Dict[str, torch.Tensor]:
    """A full state_dict -> rank ``tp_rank``'s shard of it (the replicated
    tensors as they are)."""
    if tp == 1:
        return dict(sd)
    return {k: shard_tensor(k, v, tp_rank, tp) for k, v in sd.items()}


def gather_tensor(key: str, x: torch.Tensor, group) -> torch.Tensor:
    """The full tensor ``key`` from every rank's shard (a replicated one as
    it is); collective over ``group``."""
    if tp_dim(key) is None:
        return x
    pieces = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(pieces, x.contiguous(), group=group)
    if _QKV.search(key):
        return torch.cat([p.reshape(3, -1, *x.shape[1:]) for p in pieces], 1).reshape(
            -1, *x.shape[1:])
    return torch.cat(pieces, tp_dim(key))


def tp_gather_state_dict(sd: Dict[str, torch.Tensor], tp_group) -> Dict[str, torch.Tensor]:
    """Every rank's shard -> the full state_dict on every rank of
    ``tp_group`` (a collective: the ranks call it together, on equal keys)."""
    if tp_group is None:
        return dict(sd)
    return {k: gather_tensor(k, v, tp_group) for k, v in sd.items()}


# ------------------------------------------------------------- operators


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, dist.ReduceOp.SUM, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, dist.ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """Identity; the gradient is summed over the tp ranks."""
    return _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the tp ranks; the gradient passes as it is."""
    return _ReduceFromTP.apply(x, group)


def column_parallel_linear(x, weight, bias, group):
    """x (replicated) @ this rank's output columns."""
    return F.linear(copy_to_tp(x, group), weight, bias)


def row_parallel_linear(x, weight, bias, group):
    """This rank's input columns @ its rows of the weight, summed over the
    ranks in f32 (a bf16 partial sum is rounded once, as one GEMM rounds its
    output), then the replicated bias, once; f32 out (the residual stream's
    dtype)."""
    y = reduce_from_tp(F.linear(x, weight).float(), group)
    return y + bias.float()


# ---------------------------------------------------------------- models


class TPGroup:
    """The tp process group a sharded module holds; a deep copy (the EMA
    twin's) shares it."""

    def __init__(self, group):
        self.group = group
        self.size = world_size(group)
        self.rank = rank(group)

    def __deepcopy__(self, memo):
        return self


def shard_model_(model: torch.nn.Module, group) -> torch.nn.Module:
    """Make ``model`` hold this rank's shard of its encoder blocks (in place,
    from its current full weights) and run them tensor-parallel over
    ``group``; returns it.  The heads, the width and the MLP's hidden width
    must split evenly (``check_tp``)."""
    from temporalalignnet_torch.models.transformer import MLP, MultiheadSelfAttention

    tp = TPGroup(group)
    if tp.size == 1:
        return model
    full = model.state_dict()
    for name, m in model.named_modules():
        if isinstance(m, (MultiheadSelfAttention, MLP)) and re.search(
                r"(?:^|\.)resblocks\.\d+\.(?:attn|mlp)$", name):
            m.hold_shard(tp)
    model.load_state_dict(tp_shard_state_dict(full, tp.rank, tp.size), strict=True)
    return model


def model_tp_group(model: torch.nn.Module):
    """The tp group ``model``'s blocks run over, or None (tp = 1)."""
    for m in model.modules():
        tp = getattr(m, "tp", None)
        if isinstance(tp, TPGroup):
            return tp.group
    return None


def is_sharded(param: torch.nn.Parameter) -> bool:
    return getattr(param, "tp_sharded", False)


def shard_for(model: torch.nn.Module, sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A full state_dict (a checkpoint's) as ``model`` holds it: its rank's
    shard under tensor parallelism, else ``sd`` itself."""
    group = model_tp_group(model)
    if group is None:
        return sd
    return tp_shard_state_dict(sd, rank(group), world_size(group))
