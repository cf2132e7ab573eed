"""ctypes wrapper of the Hopper attention backward kernels in csrc/mha_bwd.cu.

``mha_bwd`` replaces temporalalignnet_tpu/ops/pallas_attention.py::_mha_bwd_kernel
on CUDA tensors: from q, k, v, the key padding mask and the output's
cotangent it returns (dq, dk, dv) of ``mha_fwd``.  It checks its inputs,
allocates the outputs (and the row-statistics scratch of the two-kernel
routes), launches on PyTorch's current stream and raises if a launch was
refused.  The route depends on the dtype and S alone (``route``):

- ``fused``: bf16 with S <= 128, every training shape.  One wgmma/TMA kernel
  per call, a block per (batch row, head) holding the whole head.
- ``v2``: bf16 with S > 128.  The dq kernel and the dk/dv kernel on mma.sync.
- ``f32``: the same two-kernel scheme as f32 FMAs, the parity path.

``mha_bwd.launches`` counts its calls, ``mha_bwd.launches_by_route`` them by
route.

The plain version is ``mha_bwd_reference``: the same gradients in plain
PyTorch with the kernel's roundings (P to dO's dtype before dV, dS to q's
dtype before dQ and dK, f32 everywhere else).  In f32 it is the autograd of
``temporalalignnet_torch.ops.attention.attention_reference``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from temporalalignnet_torch.ops import _build
from temporalalignnet_torch.ops.attention import NEG_INF
from temporalalignnet_torch.ops.mha_fwd import _DTYPES, check_inputs


def mha_bwd_reference(
    q: torch.Tensor,  # [B, H, S, D]
    k: torch.Tensor,
    v: torch.Tensor,
    key_padding_mask: Optional[torch.Tensor],  # [B, S] True = pad
    dout: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in the input dtype, rounded where the kernel rounds."""
    dtype = q.dtype
    qf, kf, vf, df = (t.float() for t in (q, k, v, dout))
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if key_padding_mask is not None:
        bias = torch.zeros(key_padding_mask.shape, dtype=torch.float32, device=q.device)
        scores = scores + bias.masked_fill(key_padding_mask.bool(), NEG_INF)[:, None, None, :]
    p = torch.softmax(scores, dim=-1)
    dv = torch.matmul(p.to(dtype).float().transpose(-1, -2), df)
    dp = torch.matmul(df, vf.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    ds = ds.to(dtype).float()
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(dtype), dk.to(dtype), dv.to(dtype)


FUSED_MAX_S = 128  # the fused kernel holds a head's rows in two warpgroups of 64
ROUTES = ("fused", "v2", "f32")


def route(dtype: torch.dtype, S: int) -> str:
    """The kernel route of a call, from its dtype and sequence length alone."""
    if dtype == torch.float32:
        return "f32"
    return "fused" if S <= FUSED_MAX_S else "v2"


def _kernel(name: str, n_ptrs: int):
    fn = getattr(_build.load("mha_bwd"), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 4 + (
            [ctypes.c_int] if name == "mha_bwd" else []) + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def mha_bwd(
    q: torch.Tensor,  # [B, H, S, D]
    k: torch.Tensor,
    v: torch.Tensor,
    key_padding_mask: Optional[torch.Tensor],  # [B, S] bool/uint8, True = pad
    dout: torch.Tensor,  # [B, H, S, D], the cotangent of mha_fwd's output
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    which = route(q.dtype, q.shape[2])
    dq, dk, dv = _launch(which, q, k, v, key_padding_mask, dout)
    mha_bwd.launches += 1
    mha_bwd.launches_by_route[which] += 1
    return dq, dk, dv


def mha_bwd_v2(q, k, v, key_padding_mask, dout):
    """The two-kernel bf16 backward (mma.sync) at any S, which no route takes
    at S <= 128 any more: kept so that a run can time the fused kernel beside
    it.  Not counted."""
    if q.dtype != torch.bfloat16:
        raise ValueError("mha_bwd_v2 takes bfloat16")
    return _launch("v2", q, k, v, key_padding_mask, dout)


def _launch(which, q, k, v, key_padding_mask, dout):
    pad_ptr = check_inputs("mha_bwd", q, k, v, key_padding_mask)
    if dout.shape != q.shape or dout.dtype != q.dtype or dout.device != q.device:
        raise ValueError(f"mha_bwd takes dout like q, got {dout.dtype} {tuple(dout.shape)}")
    dout = dout.contiguous()
    B, H, S, D = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), pad_ptr, dout.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr()]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if which == "fused":
            rc = _kernel("mha_bwd_fused", 8)(*ptrs, B, H, S, D, stream)
        else:
            stats = torch.empty(3 * B * H * S, dtype=torch.float32, device=q.device)
            rc = _kernel("mha_bwd", 9)(*ptrs, stats.data_ptr(), B, H, S, D,
                                       _DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"mha_bwd ({which}) launch failed: cudaError {rc} at shape "
                           f"{tuple(q.shape)}")
    return dq, dk, dv


mha_bwd.launches = 0
mha_bwd.launches_by_route = dict.fromkeys(ROUTES, 0)
