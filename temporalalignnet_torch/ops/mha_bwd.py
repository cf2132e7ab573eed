"""ctypes wrapper of the Hopper attention backward kernels in csrc/mha_bwd.cu.

``mha_bwd`` replaces temporalalignnet_tpu/ops/pallas_attention.py::_mha_bwd_kernel
on CUDA tensors: from q, k, v, the key padding mask and the output's
cotangent it returns (dq, dk, dv) of ``mha_fwd``.  It checks its inputs,
allocates the outputs and the row-statistics scratch, launches the two
kernels on PyTorch's current stream and raises if a launch was refused.
``mha_bwd.launches`` counts its calls.

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


def _kernel():
    fn = _build.load("mha_bwd").mha_bwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def mha_bwd(
    q: torch.Tensor,  # [B, H, S, D]
    k: torch.Tensor,
    v: torch.Tensor,
    key_padding_mask: Optional[torch.Tensor],  # [B, S] bool/uint8, True = pad
    dout: torch.Tensor,  # [B, H, S, D], the cotangent of mha_fwd's output
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    pad_ptr = check_inputs("mha_bwd", q, k, v, key_padding_mask)
    if dout.shape != q.shape or dout.dtype != q.dtype or dout.device != q.device:
        raise ValueError(f"mha_bwd takes dout like q, got {dout.dtype} {tuple(dout.shape)}")
    dout = dout.contiguous()
    B, H, S, D = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stats = torch.empty(3 * B * H * S, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), pad_ptr, dout.data_ptr(),
                       dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
                       B, H, S, D, _DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"mha_bwd launch failed: cudaError {rc} at shape {tuple(q.shape)}")
    mha_bwd.launches += 1
    return dq, dk, dv


mha_bwd.launches = 0
