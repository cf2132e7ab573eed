"""ctypes wrapper of the Hopper attention kernels in csrc/mha_fwd.cu (bf16)
and csrc/mha_fwd_f32.cu (f32).

``mha_fwd`` replaces temporalalignnet_tpu/ops/pallas_attention.py::_mha_kernel
on a CUDA tensor.  It checks its inputs, allocates the output (and the split
partials of the long route), launches on PyTorch's current stream and raises
if the launch was refused.  The route depends on the dtype and S alone
(``route``):

- ``short``: bf16 with S <= 128, every encoder block of the train step and of
  the overlap-seq eval.  The wgmma/TMA kernel, one block per (batch row, head)
  holding all its queries.
- ``long``: bf16 with S > 128, the global eval.  The same kernel at 128
  queries a block; where that grid is short of the card the key range is
  split across blocks (``key_splits``) and a merge kernel combines the
  splits in split order.
- ``f32``: float32 at any S, the eval's ``--f32``, the punctuator and f32
  training.  Split TF32 on the tensor cores (each product big·small +
  small·big + big·big of TF32 halves, f32 accumulators): f32 accuracy, as the
  TPU kernel's Precision.HIGHEST asks.  The same block plan as bf16: up to
  S = 128 one block per (batch row, head), past it ``F32_LONG_QUERIES``
  queries a block with key splits (``f32_key_splits``) merged by the merge
  kernel in f32.

The kernel is the ``torch.library`` custom op ``temporalalignnet::mha_fwd``
(``torch.ops.temporalalignnet.mha_fwd``, ``mha_fwd_op``): its CUDA
implementation ``_mha_fwd_cuda`` launches the route above, and its fake
implementation returns ``empty_like(q)``, so ``torch.export`` traces a call
as one node of that op (the long route's split partials are allocated
inside the CUDA implementation and never appear in the schema).  ``mha_fwd``
sends a CUDA tensor (or a fake one) through the op and any other to the
launch's checks, which refuse it: the op has no CPU implementation and
never takes the plain version.  A program that calls the op (an exported
one, ``tools/export_eval.py``) needs this module imported first, which
registers it.

``mha_fwd.launches`` counts the op's launches, ``mha_fwd.launches_by_route``
them by route; tracing runs the fake and counts nothing.  A captured CUDA
graph counts once at capture (``train/train_step.py::make_multi_train_step``
adds that count per replay).  ``mha_fwd_v1`` calls the earlier bf16 kernel
(mma.sync), which no route takes, uncounted, so that a run can time the
wgmma routes beside it.
The plain version of the same function is
``temporalalignnet_torch.ops.attention.attention_reference``.

The output has no autograd history, so a call that autograd would track
raises: training goes through ``ops.attention.KernelAttention``, whose
backward is ``ops.mha_bwd.mha_bwd``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from temporalalignnet_torch.ops import _build

_DTYPES = (torch.float32, torch.bfloat16)  # the kernels' input dtypes
HEAD_DIMS = (64,)  # the kernels' template instantiations
SHORT_MAX_S = 128  # the short route holds a head's queries in two warpgroups of 64
LONG_QUERIES = 128  # queries per block of the long route
F32_LONG_QUERIES = 64  # queries per block of the f32 route past S = 128
KEY_TILE = 64
ROUTES = ("short", "long", "f32")


def route(dtype: torch.dtype, S: int) -> str:
    """The kernel route of a call, from its dtype and sequence length alone."""
    if dtype == torch.float32:
        return "f32"
    return "short" if S <= SHORT_MAX_S else "long"


def key_splits(blocks: int, key_tiles: int, sms: int) -> int:
    """Key-range splits of the long route.  A grid of ``blocks`` (B·H × query
    blocks) that fills the card is not split; a shorter one is split into as
    many parts as fit the two blocks each SM holds at once, at most one per
    key tile, and then into the fewest parts of that length (no part is
    empty)."""
    if blocks >= sms:
        return 1
    splits = max(1, min(key_tiles, 2 * sms // blocks))
    per = -(-key_tiles // splits)
    return -(-key_tiles // per)


F32_SPLIT_TILES = 4  # key tiles a split of the f32 route walks when its grid is short


def f32_key_splits(blocks: int, key_tiles: int, sms: int) -> int:
    """Key-range splits of the f32 route past S = 128 (``F32_LONG_QUERIES``
    queries a block, two blocks resident per SM).  A grid of ``blocks`` that
    holds two blocks per SM, or whose blocks walk at most 2 ``F32_SPLIT_TILES``
    key tiles, is not split: the merge pass and the partials would cost more
    than they win (the punctuator's [4, 12, 258, 64], 240 blocks of 5 tiles,
    ran 10 % slower split on an H100).  Else the key range goes in parts of
    ``F32_SPLIT_TILES`` tiles, so that a short grid with long key walks (the
    global method's [1, 8, 1088, 64]: 136 blocks of 17 tiles, 35 % faster
    in 4 parts there) fills the card."""
    if blocks >= 2 * sms or key_tiles <= 2 * F32_SPLIT_TILES:
        return 1
    return -(-key_tiles // F32_SPLIT_TILES)


def _fn(lib: str, name: str, argtypes):
    fn = getattr(_build.load(lib), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def check_inputs(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 key_padding_mask: Optional[torch.Tensor]) -> Optional[int]:
    """Raise on what the attention kernels do not take; return the mask's
    pointer (None without a mask)."""
    check_shapes(name, q, k, v, key_padding_mask)
    return None if key_padding_mask is None else key_padding_mask.data_ptr()


def check_shapes(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 key_padding_mask: Optional[torch.Tensor]) -> None:
    """``check_inputs`` without touching memory (fake tensors pass it too)."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"{name} takes CUDA tensors on one device, got {q.device}, "
                         f"{k.device}, {v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name} takes float32 or bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name} takes q, k, v of one [B, H, S, D] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, S, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"{name} is built for head dims {HEAD_DIMS}, got {D}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name} takes contiguous q, k, v")
    m = key_padding_mask
    if m is not None:
        if m.device != q.device or m.dtype not in (torch.bool, torch.uint8):
            raise ValueError(f"key_padding_mask must be bool or uint8 on {q.device}, "
                             f"got {m.dtype} on {m.device}")
        if tuple(m.shape) != (B, S) or not m.is_contiguous():
            raise ValueError(f"key_padding_mask must be a contiguous [{B}, {S}], "
                             f"got {tuple(m.shape)}")


def mha_fwd(
    q: torch.Tensor,  # [B, H, S, D]
    k: torch.Tensor,
    v: torch.Tensor,
    key_padding_mask: Optional[torch.Tensor] = None,  # [B, S] bool/uint8, True = pad
) -> torch.Tensor:
    """softmax(q kᵀ/√D + bias) v on the card, bias = -1e30 on padded keys:
    a CUDA tensor (or a fake one, under tracing) goes through the custom op
    ``temporalalignnet::mha_fwd``; any other reaches the launch's checks,
    which refuse it."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError("mha_fwd would return an output detached from autograd; "
                           "call ops.attention.multihead_attention (KernelAttention) instead")
    if q.is_cuda:
        return torch.ops.temporalalignnet.mha_fwd(q, k, v, key_padding_mask)
    return _mha_fwd_cuda(q, k, v, key_padding_mask)


def _mha_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The op's CUDA implementation: the route's launch, counted."""
    which = route(q.dtype, q.shape[2])
    out = _launch(which, q, k, v, key_padding_mask)
    mha_fwd.launches += 1
    mha_fwd.launches_by_route[which] += 1
    return out


mha_fwd_op = torch.library.custom_op("temporalalignnet::mha_fwd", _mha_fwd_cuda,
                                     mutates_args=(), device_types="cuda")


@mha_fwd_op.register_fake
def _mha_fwd_fake(q, k, v, key_padding_mask=None):
    check_shapes("mha_fwd", q, k, v, key_padding_mask)
    return torch.empty_like(q)


def mha_fwd_v1(q, k, v, key_padding_mask=None):
    """The earlier bf16 kernel (mma.sync) at any S, which no route takes any
    more: kept so that a run can time the wgmma routes beside it.  Not
    counted."""
    if q.dtype != torch.bfloat16:
        raise ValueError("mha_fwd_v1 takes bfloat16")
    return _launch("v1", q, k, v, key_padding_mask)


def _launch(which, q, k, v, key_padding_mask):
    pad_ptr = check_inputs("mha_fwd", q, k, v, key_padding_mask)
    B, H, S, D = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if which == "v1":
            fn = _fn("mha_fwd", "mha_fwd_v1",
                     [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), pad_ptr, out.data_ptr(),
                    B, H, S, D, stream)
        else:
            part, splits = None, 1
            if S > SHORT_MAX_S:  # long and f32: key splits where the grid is short
                rows = F32_LONG_QUERIES if which == "f32" else LONG_QUERIES
                qblocks = -(-S // rows)
                choose = f32_key_splits if which == "f32" else key_splits
                splits = choose(B * H * qblocks, -(-S // KEY_TILE), _build.sm_count(q.device))
                if splits > 1:
                    part = torch.empty(splits * B * H * qblocks * rows * (D + 2),
                                       dtype=torch.float32, device=q.device)
            lib, name = ("mha_fwd_f32", "mha_fwd_f32") if which == "f32" else (
                "mha_fwd", "mha_fwd_wgmma")
            fn = _fn(lib, name, [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), pad_ptr, out.data_ptr(),
                    None if part is None else part.data_ptr(), B, H, S, D, splits, stream)
    if rc != 0:
        raise RuntimeError(f"mha_fwd ({which}) launch failed: cudaError {rc} at shape "
                           f"{tuple(q.shape)}")
    return out


mha_fwd.launches = 0
mha_fwd.launches_by_route = dict.fromkeys(ROUTES, 0)
