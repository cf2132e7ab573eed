"""Fused MIL-NCE: the masked cross-batch logsumexps of the training loss
without the [S, B·T, B·N] logits (counterpart of
temporalalignnet_tpu/ops/pallas_milnce.py::fused_milnce_elements, on one
device and, with ``group``, over a process group).

``fused_milnce_elements(video [S,R,C], text [S,K,C] | [K,C], pos_mask [R,K],
col_valid [K], mask_value, inv_temp) -> (v_el [S,R], t_el [S,K])`` equals
``(v_den - v_num, t_den - t_num)`` of losses/tan_loss.py on the logits
``inv_temp · video textᵀ`` (f32), with positives ``where(pos_mask, sim,
mask_value)`` and negatives ``where(col_valid, sim, mask_value)``.
Differentiable in both feature tensors; a [K, C] text is shared by every
layer and its gradient is summed over them.

- ``milnce_reference``: the plain PyTorch version, the dense masked
  logsumexps of pallas_milnce.py:958-968.  A CPU tensor takes it (autograd).
  ``milnce_grad_reference`` is the plain version of the two gradient
  kernels, with their rounding of dsim to the feature dtype.
- ``MilNCEFunction``: on the card, the Hopper kernels of the four
  logsumexps (``milnce_fwd``) and of the feature gradients from the saved
  logsumexps (``milnce_dv``, ``milnce_dt``).  There is no fallback: a CUDA
  tensor launches the kernels or raises.  Each takes its route from the
  dtype alone (``fwd_route``, ``dv_route``, ``dt_route``): bf16 the
  wgmma/TMA kernels of csrc/milnce_wgmma.cu (one skeleton); f32 split TF32
  on mma.sync, the forward of csrc/milnce_fwd.cu and the gradients of
  csrc/milnce_grad_f32.cu (one template over the orientation).
  ``milnce_fwd_v1``, ``milnce_dv_v2`` and ``milnce_dt_v2`` call the earlier
  bf16 kernels of csrc/milnce_fwd.cu and csrc/milnce_bwd.cu, uncounted, for
  timing.

- With ``group`` (a process group), ``MilNCEFunction`` keeps the
  ``_sharded_milnce`` contract (pallas_milnce.py:822-897).  Each rank holds its rows of the video and
  its columns of the text; the forward gathers every rank's text, runs the
  forward kernel on its rows against all columns, keeps the row logsumexps
  and merges the column ones over the ranks (``merge_lse``: the max, then
  the sum of the exponentials, JAX's (m, s) merge from natural logs); the
  backward sums the cotangent of the replicated column elements over the
  ranks (the adjoint), runs ``milnce_dv`` and ``milnce_dt`` with the global
  column logsumexps, keeps dv and sum-reduce-scatters dt back to each rank's
  columns.  A CPU tensor takes the plain versions in place of the kernels,
  with the same collectives.  The merge is collectives and plain tensor
  ops, as JAX's is XLA collectives outside any ``pallas_call``: no kernel.

The masks go to the kernels as bytes: ``pos_mask`` as a [R, K] bool tensor
(it is block-diagonal in the loss, but the contract takes any mask), so the
kernels read R·K bytes rather than rebuilding it.  None of the TPU plumbing
is ported (the VMEM plan pickers, the (8, 128) layouts, the padding of K to
128): the kernels take any R and K.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from temporalalignnet_torch.ops import _build
from temporalalignnet_torch.parallel.distributed import (all_gather, all_reduce_max,
                                                         all_reduce_sum, reduce_scatter)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE = 64  # video rows per block of every forward kernel (the column merge's row blocks)
F32_TILE = 32  # outer entries per block and inner entries per tile of the f32 gradients
# the gradient kernels keep a [64 or 32, C] f32 accumulator a block, the f32
# forward 64 rows of C channels resident
MAX_CHANNELS = 512
_WAVES = 2  # gradient grids: about two waves of one block per SM


def _logits(video, text, inv_temp: float):
    """inv_temp · video textᵀ [S, R, K] in f32; a [K, C] text for every layer."""
    if text.dim() == 2:
        text = text.expand(video.shape[0], *text.shape)
    return inv_temp * torch.einsum("src,skc->srk", video.float(), text.float())


def milnce_reference(video, text, pos_mask, col_valid, mask_value: float, inv_temp: float):
    """Dense masked logsumexps; f32 logits from features of any dtype."""
    return masked_lse_elements(_logits(video, text, inv_temp), pos_mask, col_valid, mask_value)


def milnce_lse_reference(video, text, pos_mask, col_valid, mask_value: float, inv_temp: float):
    """(vnum, vden [S, R], tnum, tden [S, K]): the plain version of ``milnce_fwd``."""
    return masked_lse(_logits(video, text, inv_temp), pos_mask, col_valid, mask_value)


def masked_lse(sim, pos_mask, col_valid, mask_value: float):
    """(vnum, vden [S, R], tnum, tden [S, K]): the row and column logsumexps
    of the positives where(pos_mask, sim, mask_value) and the negatives
    where(col_valid, sim, mask_value) of f32 logits sim [S, R, K]."""
    fill = torch.full((), mask_value, dtype=sim.dtype, device=sim.device)
    pos = torch.where(pos_mask[None], sim, fill)
    neg = torch.where(col_valid[None, None], sim, fill)
    return (torch.logsumexp(pos, 2), torch.logsumexp(neg, 2), torch.logsumexp(pos, 1),
            torch.logsumexp(neg, 1))


def merge_lse(lse, group):
    """Column logsumexps of each rank's rows merged into those of every
    rank's rows: max, then log of the summed exponentials (differentiable
    through ``all_reduce_sum``; the max is a constant shift)."""
    if group is None:
        return lse
    top = all_reduce_max(lse, group)
    return top + torch.log(all_reduce_sum(torch.exp(lse - top), group))


def masked_lse_elements(sim, pos_mask, col_valid, mask_value: float, group=None):
    """(v_den - v_num [S, R], t_den - t_num [S, K]) of f32 logits sim
    [S, R, K] (losses/tan_loss.py::_milnce_components of the JAX package).
    With ``group``, sim holds this rank's rows against every rank's
    columns, and the column logsumexps merge over the ranks."""
    vnum, vden, tnum, tden = masked_lse(sim, pos_mask, col_valid, mask_value)
    return vden - vnum, merge_lse(tden, group) - merge_lse(tnum, group)


def milnce_grad_reference(video, text, pos_mask, col_valid, lse, g_v, g_t, inv_temp: float):
    """(dv, dt) of sum(g_v · v_el) + sum(g_t · t_el) from the four saved
    logsumexps (vnum, vden [S, R], tnum, tden [S, K]), as ``milnce_dv`` and
    ``milnce_dt`` compute them: dsim in f32 with the probabilities re-masked,
    rounded to the feature dtype, then the products in f32; a [K, C] text
    gets its gradient summed over the layers."""
    vnum, vden, tnum, tden = lse
    row = lambda x: x.float()[..., None]  # [S, R] -> [S, R, 1]
    col = lambda x: x.float()[:, None]  # [S, K] -> [S, 1, K]
    t = text.expand(video.shape[0], *text.shape) if text.dim() == 2 else text
    sim = _logits(video, t, inv_temp)
    pm, cv = pos_mask[None], col_valid[None, None]
    zero = torch.zeros((), device=sim.device)
    prob = lambda keep, lse_: torch.where(keep, (sim - lse_).exp(), zero)
    dsim = (row(g_v) * (prob(cv, row(vden)) - prob(pm, row(vnum)))
            + col(g_t) * (prob(cv, col(tden)) - prob(pm, col(tnum))))
    dsim = (inv_temp * dsim).to(video.dtype).float()
    dv = torch.einsum("srk,skc->src", dsim, t.float())
    dt = torch.einsum("srk,src->skc", dsim, video.float())
    if text.dim() == 2:
        dt = dt.sum(0)
    return dv.to(video.dtype), dt.to(text.dtype)


# --------------------------------------------------------------- the kernels


def _fn(lib: str, name: str, argtypes):
    fn = getattr(_build.load(lib), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


def _check(name, video, text, pos_mask, col_valid):
    """Raise on what the kernels do not take; return (S, R, K, C, text layer stride)."""
    if not video.is_cuda or any(x.device != video.device for x in (text, pos_mask, col_valid)):
        raise ValueError(f"{name} takes CUDA tensors on one device")
    if video.dtype not in _DTYPES or text.dtype != video.dtype:
        raise ValueError(f"{name} takes float32 or bfloat16 features, got {video.dtype}, "
                         f"{text.dtype}")
    if video.dim() != 3 or text.dim() not in (2, 3):
        raise ValueError(f"{name} takes video [S, R, C] and text [S, K, C] or [K, C]")
    S, R, C = video.shape
    K = text.shape[-2]
    if text.shape[-1] != C or (text.dim() == 3 and text.shape[0] != S):
        raise ValueError(f"{name}: text {tuple(text.shape)} does not fit video {tuple(video.shape)}")
    if C % 64 != 0 or C > MAX_CHANNELS:
        raise ValueError(f"{name} takes C a multiple of 64 up to {MAX_CHANNELS}, got {C}")
    if not (video.is_contiguous() and text.is_contiguous()):
        raise ValueError(f"{name} takes contiguous features")
    if pos_mask.dtype != torch.bool or tuple(pos_mask.shape) != (R, K) or not pos_mask.is_contiguous():
        raise ValueError(f"{name} takes a contiguous bool pos_mask [{R}, {K}]")
    if col_valid.dtype != torch.bool or tuple(col_valid.shape) != (K,):
        raise ValueError(f"{name} takes a bool col_valid [{K}]")
    return S, R, K, C, (K * C if text.dim() == 3 else 0)


def _launch(name, rc, shape):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc} at (S, R, K, C) = {shape}")


FWD_ROUTES = DV_ROUTES = DT_ROUTES = ("wgmma", "f32")


def fwd_route(dtype: torch.dtype) -> str:
    """The kernel route of each MIL-NCE kernel, from the dtype alone: bf16
    the wgmma/TMA kernels of csrc/milnce_wgmma.cu, f32 the split-TF32
    kernels of csrc/milnce_fwd.cu and csrc/milnce_grad_f32.cu."""
    return "wgmma" if dtype == torch.bfloat16 else "f32"


dv_route = dt_route = fwd_route  # one skeleton, three kernels


def _fwd(video, text, pos_mask, col_valid, mask_value, inv_temp, wgmma=False):
    """The four logsumexps through the wgmma/TMA kernel of csrc/milnce_wgmma.cu
    (``wgmma``) or a kernel of csrc/milnce_fwd.cu (f32: split TF32; bf16:
    the earlier kernel); each writes the same per-64-row-block column
    partials and merges them with the same kernel."""
    S, R, K, C, t_ls = _check("milnce_fwd", video, text, pos_mask, col_valid)
    f32 = dict(dtype=torch.float32, device=video.device)
    vnum, vden = torch.empty(S, R, **f32), torch.empty(S, R, **f32)
    tnum, tden = torch.empty(S, K, **f32), torch.empty(S, K, **f32)
    part = torch.empty(4 * S * -(-R // TILE) * K, **f32)
    if wgmma:
        lib, fname, ints = "milnce_wgmma", "milnce_fwd_wgmma", [S, R, K, C]
    else:
        lib, fname, ints = "milnce_fwd", "milnce_fwd", [S, R, K, C, _DTYPES[video.dtype]]
    fn = _fn(lib, fname, [_P, _P, _L] + [_P] * 7 + [_I] * len(ints) + [_F, _F, _P])
    with torch.cuda.device(video.device):
        stream = torch.cuda.current_stream(video.device).cuda_stream
        rc = fn(video.data_ptr(), text.data_ptr(), t_ls, pos_mask.data_ptr(),
                col_valid.data_ptr(), vnum.data_ptr(), vden.data_ptr(), tnum.data_ptr(),
                tden.data_ptr(), part.data_ptr(), *ints, float(mask_value), float(inv_temp),
                stream)
    _launch("milnce_fwd", rc, (S, R, K, C))
    return vnum, vden, tnum, tden


def milnce_fwd(video, text, pos_mask, col_valid, mask_value: float, inv_temp: float):
    """(vnum, vden [S, R], tnum, tden [S, K]) f32 on the card."""
    which = fwd_route(video.dtype)
    out = _fwd(video, text, pos_mask, col_valid, mask_value, inv_temp, wgmma=which == "wgmma")
    milnce_fwd.launches += 1
    milnce_fwd.launches_by_route[which] += 1
    return out


def milnce_fwd_v1(video, text, pos_mask, col_valid, mask_value: float, inv_temp: float):
    """The earlier bf16 forward kernel (mma.sync, csrc/milnce_fwd.cu), which
    no route takes any more: kept so that a run can time the redesign beside
    it.  Not counted."""
    if video.dtype != torch.bfloat16:
        raise ValueError(f"milnce_fwd_v1 takes bfloat16 features, got {video.dtype}")
    return _fwd(video, text, pos_mask, col_valid, mask_value, inv_temp)


def _splits(outer_tiles: int, out_layers: int, inner_tiles: int, sms: int) -> int:
    """Inner-axis splits of the earlier bf16 kernels that bring the grid
    near ``_WAVES`` waves of one block per SM (their registers allow one)."""
    return max(1, min(inner_tiles, -(-_WAVES * sms // (outer_tiles * out_layers))))


def _wave_splits(blocks: int, inner_tiles: int, sms: int) -> int:
    """Inner-axis splits for a kernel that holds one block per SM.  Its time
    goes as waves x inner tiles per block (the last wave's idle SMs count);
    every split also writes and reads back an f32 partial, so take the
    fewest splits within 5 % of the least such time."""
    cost = [(-(-blocks * sp // sms)) * -(-inner_tiles // sp) for sp in range(1, inner_tiles + 1)]
    return next(sp for sp, c in enumerate(cost, 1) if c <= 1.05 * min(cost))


def _grad(name, video, text, pos_mask, col_valid, lse, g_v, g_t, inv_temp, kernel):
    """``name``'s gradient through ``kernel``: "wgmma" (bf16,
    csrc/milnce_wgmma.cu), "f32" (csrc/milnce_grad_f32.cu) or "v2" (the
    earlier bf16 kernels, csrc/milnce_bwd.cu)."""
    S, R, K, C, t_ls = _check(name, video, text, pos_mask, col_valid)
    vnum, vden, tnum, tden = lse
    g_v, g_t = g_v.float().contiguous(), g_t.float().contiguous()
    f32 = dict(dtype=torch.float32, device=video.device)
    if name == "milnce_dv":
        out_layers, n_out, n_in = S, R, K
        out = torch.empty_like(video)
    else:
        out_layers, n_out, n_in = (S if text.dim() == 3 else 1), K, R
        out = torch.empty(text.shape, dtype=text.dtype, device=text.device)
    args = [video.data_ptr(), text.data_ptr(), t_ls, pos_mask.data_ptr(), col_valid.data_ptr(),
            vnum.data_ptr(), vden.data_ptr(), tnum.data_ptr(), tden.data_ptr(), g_v.data_ptr(),
            g_t.data_ptr(), out.data_ptr()]
    argtypes = [_P, _P, _L] + [_P] * 9
    sms = _build.sm_count(video.device)
    if kernel == "v2":
        splits = _splits(-(-n_out // TILE), out_layers, -(-n_in // TILE), sms)
        ints = ([S, R, K, C] + ([out_layers] if name == "milnce_dt" else [])
                + [splits, _DTYPES[video.dtype]])
        lib, fname = "milnce_bwd", name
    else:
        tile = TILE if kernel == "wgmma" else F32_TILE
        splits = _wave_splits(-(-n_out // tile) * out_layers, -(-n_in // tile), sms)
        ints = [S, R, K, C, out_layers, splits]
        lib, fname = ("milnce_wgmma", f"{name}_wgmma") if kernel == "wgmma" else (
            "milnce_grad_f32", f"{name}_f32")
    # one split of the wgmma and f32 kernels writes the output straight away
    part = (torch.empty(splits * out_layers * n_out * C, **f32) if splits > 1 or kernel == "v2"
            else None)
    fn = _fn(lib, fname, argtypes + [_P] + [_I] * len(ints) + [_F, _P])
    args += [None if part is None else part.data_ptr()] + ints
    with torch.cuda.device(video.device):
        stream = torch.cuda.current_stream(video.device).cuda_stream
        rc = fn(*args, float(inv_temp), stream)
    _launch(name, rc, (S, R, K, C))
    return out


def milnce_dv(video, text, pos_mask, col_valid, lse, g_v, g_t, inv_temp: float):
    """d/d video [S, R, C] of sum(g_v · v_el) + sum(g_t · t_el), on the card."""
    which = dv_route(video.dtype)
    out = _grad("milnce_dv", video, text, pos_mask, col_valid, lse, g_v, g_t, inv_temp, which)
    milnce_dv.launches += 1
    milnce_dv.launches_by_route[which] += 1
    return out


def milnce_dt(video, text, pos_mask, col_valid, lse, g_v, g_t, inv_temp: float):
    """d/d text, [S, K, C] or (shared text) [K, C] summed over the layers."""
    which = dt_route(video.dtype)
    out = _grad("milnce_dt", video, text, pos_mask, col_valid, lse, g_v, g_t, inv_temp, which)
    milnce_dt.launches += 1
    milnce_dt.launches_by_route[which] += 1
    return out


def milnce_dv_v2(video, text, pos_mask, col_valid, lse, g_v, g_t, inv_temp: float):
    """The earlier bf16 video-gradient kernel (mma.sync, csrc/milnce_bwd.cu),
    which no route takes any more: kept so that a run can time the redesign
    beside it.  Not counted."""
    if video.dtype != torch.bfloat16:
        raise ValueError(f"milnce_dv_v2 takes bfloat16 features, got {video.dtype}")
    return _grad("milnce_dv", video, text, pos_mask, col_valid, lse, g_v, g_t, inv_temp, "v2")


def milnce_dt_v2(video, text, pos_mask, col_valid, lse, g_v, g_t, inv_temp: float):
    """The earlier bf16 text-gradient kernel, as ``milnce_dv_v2``.  Not counted."""
    if video.dtype != torch.bfloat16:
        raise ValueError(f"milnce_dt_v2 takes bfloat16 features, got {video.dtype}")
    return _grad("milnce_dt", video, text, pos_mask, col_valid, lse, g_v, g_t, inv_temp, "v2")


milnce_fwd.launches = milnce_dv.launches = milnce_dt.launches = 0
milnce_fwd.launches_by_route = dict.fromkeys(FWD_ROUTES, 0)
milnce_dv.launches_by_route = dict.fromkeys(DV_ROUTES, 0)
milnce_dt.launches_by_route = dict.fromkeys(DT_ROUTES, 0)


class MilNCEFunction(torch.autograd.Function):
    """(v_el, t_el) through the kernels; saves the features, masks and the
    four logsumexps, as the custom VJP at pallas_milnce.py:789-817 does.
    With a process group ``group``, the ``_sharded_milnce`` contract (the
    module docstring): v_el [S, R_rank] of this rank's rows, t_el [S, K_all]
    of every rank's columns; on the CPU through the plain versions."""

    @staticmethod
    def forward(ctx, video, text, pos_mask, col_valid, mask_value, inv_temp, group):
        kdim = text.dim() - 2  # the column axis of [K, C] or [S, K, C]
        text_all = all_gather(text, kdim, group).contiguous()
        fwd = milnce_fwd if video.is_cuda else milnce_lse_reference
        vnum, vden, tnum, tden = fwd(video, text_all, pos_mask, col_valid, mask_value, inv_temp)
        tnum, tden = merge_lse(tnum, group), merge_lse(tden, group)
        ctx.save_for_backward(video, text_all, pos_mask, col_valid, vnum, vden, tnum, tden)
        ctx.inv_temp, ctx.group, ctx.kdim = inv_temp, group, kdim
        return vden - vnum, tden - tnum

    @staticmethod
    def backward(ctx, g_v, g_t):
        video, text_all, pos_mask, col_valid, *lse = ctx.saved_tensors
        if g_v is None:
            g_v = torch.zeros(video.shape[:2], dtype=torch.float32, device=video.device)
        if g_t is None:
            g_t = torch.zeros(video.shape[0], text_all.shape[-2], dtype=torch.float32,
                              device=video.device)
        # t_el is replicated: every rank's cotangent of it reaches every rank's rows
        g_t = all_reduce_sum(g_t, ctx.group)
        args = (video, text_all, pos_mask, col_valid, lse, g_v, g_t, ctx.inv_temp)
        if video.is_cuda:
            dv = milnce_dv(*args) if ctx.needs_input_grad[0] else None
            dt = milnce_dt(*args) if ctx.needs_input_grad[1] else None
        else:
            dv, dt = milnce_grad_reference(*args)
        if ctx.needs_input_grad[1]:  # this rank's rows' part of every column's gradient
            dt = reduce_scatter(dt, ctx.kdim, ctx.group).contiguous()
        return dv, dt, None, None, None, None, None


def fused_milnce_elements(
    video: torch.Tensor,  # [S, R, C] per-layer L2-normalized video features
    text: torch.Tensor,  # [S, K, C] (joint) or [K, C] (dual, shared by the layers)
    pos_mask: torch.Tensor,  # [R, K] bool, col_valid already applied
    col_valid: torch.Tensor,  # [K] bool
    mask_value: float,
    inv_temp: float = 1.0,
    group=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(v_el [S, R], t_el [S, K]) f32, without materializing the logits on the card.

    With ``group`` (a process group): ``video`` and ``text`` are this rank's
    rows and columns, ``pos_mask`` [R, K_all] and ``col_valid`` [K_all] are
    over every rank's columns in rank order, and t_el [S, K_all] is the
    same on every rank."""
    if video.device.type == "cpu" and group is None:
        return milnce_reference(video, text, pos_mask, col_valid, mask_value, inv_temp)
    if video.device.type in ("cpu", "cuda"):
        return MilNCEFunction.apply(video.contiguous(), text.contiguous(), pos_mask.contiguous(),
                                    col_valid.contiguous(), float(mask_value), float(inv_temp),
                                    group)
    raise ValueError(f"no MIL-NCE path for device {video.device}")
