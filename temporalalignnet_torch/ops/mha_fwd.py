"""ctypes wrapper of the Hopper attention kernel in csrc/mha_fwd.cu.

``mha_fwd`` replaces temporalalignnet_tpu/ops/pallas_attention.py::_mha_kernel
on a CUDA tensor.  It checks its inputs, allocates the output, launches the
kernel on PyTorch's current stream and raises if the launch was refused.
``mha_fwd.launches`` counts its launches, so a run can show that its path went
through the kernel.  The plain version of the same function is
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
HEAD_DIMS = (64,)  # the kernel's template instantiations


def _kernel():
    lib = _build.load("mha_fwd")
    fn = lib.mha_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
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
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError("mha_fwd would return an output detached from autograd; "
                           "call ops.attention.multihead_attention (KernelAttention) instead")
    pad_ptr = check_inputs("mha_fwd", q, k, v, key_padding_mask)
    B, H, S, D = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), pad_ptr, out.data_ptr(),
                       B, H, S, D, _DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"mha_fwd launch failed: cudaError {rc} at shape {tuple(q.shape)}")
    mha_fwd.launches += 1
    return out


mha_fwd.launches = 0
