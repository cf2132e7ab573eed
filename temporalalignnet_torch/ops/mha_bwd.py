"""ctypes wrapper of the Hopper attention backward kernels in csrc/mha_bwd.cu
(bf16) and csrc/mha_bwd_f32.cu, csrc/mha_bwd_f32_wide.cu (f32).

``mha_bwd`` replaces temporalalignnet_tpu/ops/pallas_attention.py::_mha_bwd_kernel
on CUDA tensors: from q, k, v, the key padding mask and the output's
cotangent it returns (dq, dk, dv) of ``mha_fwd``.  It checks its inputs,
allocates the outputs (and the row-statistics scratch of the two-kernel
plans), launches on PyTorch's current stream and raises if a launch was
refused.  The route depends on the dtype and S alone (``route``):

- ``fused``: bf16 with S <= 128, every training shape.  One wgmma/TMA kernel
  per call, a block per (batch row, head) holding the whole head.
- ``long``: bf16 with S > 128.  A dq kernel and a dk/dv kernel on wgmma and
  TMA, each fed by a producer warp, the row statistics through a small f32
  scratch.
- ``f32``: float32 at any S, the ``--f32`` training path.  Split TF32 on the
  tensor cores (each product big·small + small·big + big·big of TF32 halves,
  f32 accumulators): f32 accuracy, as the TPU kernel's Precision.HIGHEST
  asks.  Up to S = 128 one kernel, a block per (batch row, head), one pass,
  no scratch; past it a dq and a dk/dv kernel with the row statistics'
  scratch.

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
from temporalalignnet_torch.ops.mha_fwd import check_inputs


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
# the f32 whole-head kernel past this S is built in a source of its own,
# csrc/mha_bwd_f32_wide.cu, so that its instantiations compile in parallel
F32_WIDE_MIN_S = 81
LONG_TILE = 64  # rows per tile of the long route's kernels (its statistics scratch)
ROUTES = ("fused", "long", "f32")


def route(dtype: torch.dtype, S: int) -> str:
    """The kernel route of a call, from its dtype and sequence length alone."""
    if dtype == torch.float32:
        return "f32"
    return "fused" if S <= FUSED_MAX_S else "long"


def _kernel(lib: str, name: str, n_ptrs: int):
    fn = getattr(_build.load(lib), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 4 + [ctypes.c_void_p]
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


def _launch(which, q, k, v, key_padding_mask, dout):
    if which != "f32" and q.dtype != torch.bfloat16:
        raise ValueError(f"mha_bwd's {which} route takes bfloat16, got {q.dtype}")
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
            rc = _kernel("mha_bwd", "mha_bwd_fused", 8)(*ptrs, B, H, S, D, stream)
        else:  # the row statistics of the two-kernel plans (long; f32 past S = 128)
            if which == "long":
                size = 3 * LONG_TILE * B * H * -(-S // LONG_TILE)
            else:
                size = 0 if S <= FUSED_MAX_S else 3 * B * H * S
            stats = torch.empty(size, dtype=torch.float32, device=q.device) if size else None
            if which == "long":
                lib, name = "mha_bwd", "mha_bwd_long"
            else:  # each f32 library exports one function of its own name
                lib = name = ("mha_bwd_f32_wide" if F32_WIDE_MIN_S <= S <= FUSED_MAX_S
                              else "mha_bwd_f32")
            rc = _kernel(lib, name, 9)(*ptrs, None if stats is None else stats.data_ptr(),
                                       B, H, S, D, stream)
    if rc != 0:
        raise RuntimeError(f"mha_bwd ({which}) launch failed: cudaError {rc} at shape "
                           f"{tuple(q.shape)}")
    return dq, dk, dv


mha_bwd.launches = 0
mha_bwd.launches_by_route = dict.fromkeys(ROUTES, 0)
