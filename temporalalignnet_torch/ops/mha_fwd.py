"""ctypes wrapper of the Hopper attention kernels in csrc/mha_fwd.cu.

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
- ``f32``: f32 FMAs on the CUDA cores, the parity path.

``mha_fwd.launches`` counts its calls, ``mha_fwd.launches_by_route`` them by
route.  ``mha_fwd_v1`` calls the earlier bf16 kernel (mma.sync), which no
route takes, uncounted, so that a run can time the wgmma routes beside it.
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

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64,)  # the kernels' template instantiations
SHORT_MAX_S = 128  # the short route holds a head's queries in two warpgroups of 64
LONG_QUERIES = 128  # queries per block of the long route
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


def _fn(name: str, argtypes):
    fn = getattr(_build.load("mha_fwd"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def check_inputs(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 key_padding_mask: Optional[torch.Tensor]) -> Optional[int]:
    """Raise on what the attention kernels do not take; return the mask's
    pointer (None without a mask)."""
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
    pad_ptr = None
    if key_padding_mask is not None:
        m = key_padding_mask
        if m.device != q.device or m.dtype not in (torch.bool, torch.uint8):
            raise ValueError(f"key_padding_mask must be bool or uint8 on {q.device}, "
                             f"got {m.dtype} on {m.device}")
        if tuple(m.shape) != (B, S) or not m.is_contiguous():
            raise ValueError(f"key_padding_mask must be a contiguous [{B}, {S}], "
                             f"got {tuple(m.shape)}")
        pad_ptr = m.data_ptr()
    return pad_ptr


def mha_fwd(
    q: torch.Tensor,  # [B, H, S, D]
    k: torch.Tensor,
    v: torch.Tensor,
    key_padding_mask: Optional[torch.Tensor] = None,  # [B, S] bool/uint8, True = pad
) -> torch.Tensor:
    """softmax(q kᵀ/√D + bias) v on the card, bias = -1e30 on padded keys."""
    which = route(q.dtype, q.shape[2])
    out = _launch(which, q, k, v, key_padding_mask)
    mha_fwd.launches += 1
    mha_fwd.launches_by_route[which] += 1
    return out


def mha_fwd_v1(q, k, v, key_padding_mask=None):
    """The earlier bf16 kernel (mma.sync) at any S, which no route takes any
    more: kept so that a run can time the wgmma routes beside it.  Not
    counted."""
    if q.dtype != torch.bfloat16:
        raise ValueError("mha_fwd_v1 takes bfloat16")
    return _launch("v1", q, k, v, key_padding_mask)


def _launch(which, q, k, v, key_padding_mask):
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError("mha_fwd would return an output detached from autograd; "
                           "call ops.attention.multihead_attention (KernelAttention) instead")
    pad_ptr = check_inputs("mha_fwd", q, k, v, key_padding_mask)
    B, H, S, D = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if which in ("f32", "v1"):
            fn = _fn("mha_fwd", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), pad_ptr, out.data_ptr(),
                    B, H, S, D, _DTYPES[q.dtype], stream)
        else:
            part, splits = None, 1
            if which == "long":
                qblocks = -(-S // LONG_QUERIES)
                splits = key_splits(B * H * qblocks, -(-S // KEY_TILE),
                                    _build.sm_count(q.device))
                if splits > 1:
                    part = torch.empty(splits * B * H * qblocks * LONG_QUERIES * (D + 2),
                                       dtype=torch.float32, device=q.device)
            fn = _fn("mha_fwd_wgmma", [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                     + [ctypes.c_void_p])
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), pad_ptr, out.data_ptr(),
                    None if part is None else part.data_ptr(), B, H, S, D, splits, stream)
    if rc != 0:
        raise RuntimeError(f"mha_fwd ({which}) launch failed: cudaError {rc} at shape "
                           f"{tuple(q.shape)}")
    return out


mha_fwd.launches = 0
mha_fwd.launches_by_route = dict.fromkeys(ROUTES, 0)
