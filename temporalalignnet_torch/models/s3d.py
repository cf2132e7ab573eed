"""S3D-G (MIL-NCE) video backbone, the end-to-end fine-tune model
(counterpart of temporalalignnet_tpu/models/s3d.py; reference
model/s3d_milnce/s3dg.py:27-379).

- Input ``[B, 3, T, H, W]`` in [0, 1], the reference's layout.  The data
  pipeline yields ``[B, T, H, W, 3]``; ``x.permute(0, 4, 1, 2, 3)`` of that
  is already a ``channels_last_3d`` tensor, which the convolutions take as
  it is (the model's 5-D weights go to the same format on the card).
- The module tree and its state_dict are the reference ``s3dg.py`` key
  space (``conv1.conv1.weight``, ``mixed_3b.conv_b1_b.bn2.running_var``,
  ``mixed_4c.gating_b0.fc.weight``, ``fc.weight`` ...), that of
  ``s3d_howto100m.pth``, so that file loads with ``strict=True``; BN keeps
  no ``num_batches_tracked``.
- conv1 runs on the space-to-depth input: by default folded into one
  stride-2 (4, 8, 8) convolution over the raw pixels (``fold_s2d``, the
  JAX ``_FoldedS2DConv``: the stored [64, 24, 2, 4, 4] weight scattered to
  [64, 3, 4, 8, 8], padding (2, 4, 4); the same 768 terms per output), or
  on an explicit ``space_to_depth`` tensor; then the TF-"SAME" crop.
- TF-"SAME" max pools (``max_pool_same``): padding total
  ``max((ceil(n/s) - 1)·s + k - n, 0)`` per dimension, ``total // 2`` at the
  low end and the rest at the high end, padded with -inf.
- BatchNorm (eps 1e-5, momentum 0.1 = flax's 0.9) is frozen by default:
  running statistics, trainable scale and bias, whatever ``.train()`` says
  (the reference's FrozenBN surgery, end2end/freeze_bn.py:6-37).  With
  ``train_bn_stats`` a BN in training mode normalises with the batch
  statistics and folds the batch's BIASED variance into its running
  variance, as flax does (``nn.BatchNorm3d`` would fold the unbiased one).
  Its output keeps the input's dtype (bf16 under autocast on the card).
  Under data parallelism (``S3D.sync_batch_stats(group)``) the batch mean
  and variance are those of every rank's batch (each an all-reduced sum,
  differentiable), as GSPMD's BN statistics are global in JAX.
- ``freeze_early``: no gradient reaches conv1 ... mixed_3c (``freeze_forward``,
  s3dg.py:351-378; JAX ``stop_gradient``); their forward runs without
  autograd.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from temporalalignnet_torch.parallel.distributed import all_reduce_sum, world_size

Kernel3 = Tuple[int, int, int]
BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # torch's convention: new = (1 - m)·running + m·batch (flax momentum 0.9)

# InceptionBlock widths (c0, c1a, c1b, c2a, c2b, c3b), s3dg.py:256-305
INCEPTION = (
    ("mixed_3b", (64, 96, 128, 16, 32, 32)),
    ("mixed_3c", (128, 128, 192, 32, 96, 64)),
    ("mixed_4b", (192, 96, 208, 16, 48, 64)),
    ("mixed_4c", (160, 112, 224, 24, 64, 64)),
    ("mixed_4d", (128, 128, 256, 24, 64, 64)),
    ("mixed_4e", (112, 144, 288, 32, 64, 64)),
    ("mixed_4f", (256, 160, 320, 32, 128, 128)),
    ("mixed_5b", (256, 160, 320, 32, 128, 128)),
    ("mixed_5c", (384, 192, 384, 48, 128, 128)),
)


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """[B, C, T, H, W] -> [B, 8C, T/2, H/2, W/2], channels in (t2, h2, w2, C)
    order (s3dg.py:312-318), so the reference conv1 weight applies as is."""
    B, C, T, H, W = x.shape
    x = x.reshape(B, C, T // 2, 2, H // 2, 2, W // 2, 2)
    x = x.permute(0, 3, 5, 7, 1, 2, 4, 6)
    return x.reshape(B, 8 * C, T // 2, H // 2, W // 2)


def fold_s2d_weight(w: torch.Tensor) -> torch.Tensor:
    """The s2d-space conv1 weight [O, (t2, h2, w2, c), kt, kh, kw] -> the raw-pixel
    weight [O, c, 2kt+t2, 2kh+h2, 2kw+w2] of the same convolution."""
    O, _, kt, kh, kw = w.shape
    w = w.reshape(O, 2, 2, 2, 3, kt, kh, kw)  # [o, t2, h2, w2, c, kt, kh, kw]
    w = w.permute(0, 4, 5, 1, 6, 2, 7, 3)  # [o, c, kt, t2, kh, h2, kw, w2]
    return w.reshape(O, 3, 2 * kt, 2 * kh, 2 * kw)


def max_pool_same(x: torch.Tensor, kernel: Kernel3, stride: Kernel3) -> torch.Tensor:
    """TF-'SAME' 3-D max pool over [B, C, T, H, W] (JAX ``nn.max_pool(...,
    padding='SAME')``; reference MaxPool3dTFPadding, s3dg.py:153-183).

    The low padding goes to ``F.max_pool3d``'s own (implicit -inf) padding.
    An odd total leaves one more at the high end; with a stride of 2 or more
    ``ceil_mode`` covers it (the last window is cut at the edge, which is the
    same max as padding it with -inf); with stride 1 it is padded with -inf."""
    low, high = [], []
    for n, k, s in zip(x.shape[2:], kernel, stride):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        low.append(total // 2)
        high.append(total - total // 2 - total // 2 if s == 1 else 0)
    if any(high):
        x = F.pad(x, (0, high[2], 0, high[1], 0, high[0]), value=-math.inf)
    return F.max_pool3d(x, kernel, stride, padding=low, ceil_mode=True)


class BatchNorm(nn.Module):
    """BatchNorm over the channel axis of [B, C, T, H, W]; see the module
    docstring for frozen and ``train_bn_stats`` behaviour."""

    def __init__(self, dim: int, frozen: bool = True):
        super().__init__()
        self.frozen = frozen
        self.group = None  # the process group whose batches the statistics span
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.frozen or not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, BN_EPS)
        if self.group is not None:
            return self._global_batch_norm(x)
        with torch.no_grad():  # flax: the biased batch variance into the running one
            var, mean = torch.var_mean(x.to(self.running_mean.dtype), dim=(0, 2, 3, 4),
                                       correction=0)
            self.running_mean.lerp_(mean, BN_MOMENTUM)
            self.running_var.lerp_(var, BN_MOMENTUM)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, BN_EPS)

    def _global_batch_norm(self, x: torch.Tensor) -> torch.Tensor:
        """Training BN on the statistics of every rank's batch, in f32: the
        mean, then the biased variance about it, each a sum all-reduced
        over the ranks (its backward all-reduces the cotangents)."""
        dims = (0, 2, 3, 4)
        xf = x.to(self.running_mean.dtype)
        n = x.numel() // x.shape[1] * world_size(self.group)  # every rank's batch is as large
        mean = all_reduce_sum(xf.sum(dims), self.group) / n
        centred = xf - mean[None, :, None, None, None]
        var = all_reduce_sum((centred * centred).sum(dims), self.group) / n
        with torch.no_grad():
            self.running_mean.lerp_(mean, BN_MOMENTUM)
            self.running_var.lerp_(var, BN_MOMENTUM)
        scale = self.weight * torch.rsqrt(var + BN_EPS)
        y = centred * scale[None, :, None, None, None] + self.bias[None, :, None, None, None]
        return y.to(x.dtype)


class STConv3D(nn.Module):
    """(Separable) spatio-temporal conv + BN + ReLU (s3dg.py:93-150).  A
    separable (k, k, k) conv is a (1, k, k) conv, BN, ReLU, then a (k, 1, 1)
    conv, BN, ReLU.  ``fold_s2d`` (conv1 only) takes the raw 3-channel input
    and applies the s2d-space weight folded (``fold_s2d_weight``)."""

    def __init__(self, cin: int, cout: int, kernel: Kernel3, padding: Sequence[int] = (0, 0, 0),
                 separable: bool = False, frozen_bn: bool = True, fold_s2d: bool = False):
        super().__init__()
        self.separable = separable and kernel[0] != 1
        self.fold_s2d = fold_s2d
        self.padding = tuple(padding)
        if self.separable:
            kt, kh, kw = kernel
            pt, ph, pw = self.padding
            self.conv1 = nn.Conv3d(cin, cout, (1, kh, kw), padding=(0, ph, pw), bias=False)
            self.bn1 = BatchNorm(cout, frozen_bn)
            self.conv2 = nn.Conv3d(cout, cout, (kt, 1, 1), padding=(pt, 0, 0), bias=False)
            self.bn2 = BatchNorm(cout, frozen_bn)
        else:
            self.conv1 = nn.Conv3d(cin, cout, kernel, padding=self.padding, bias=False)
            self.bn1 = BatchNorm(cout, frozen_bn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fold_s2d:
            w = fold_s2d_weight(self.conv1.weight)
            x = F.conv3d(x, w, stride=2, padding=tuple(2 * p for p in self.padding))
        else:
            x = self.conv1(x)
        x = F.relu(self.bn1(x))
        if self.separable:
            x = F.relu(self.bn2(self.conv2(x)))
        return x


class SelfGating(nn.Module):
    """Squeeze-excite gating (s3dg.py:79-90): x · sigmoid(fc(mean over T, H, W))."""

    def __init__(self, dim: int):
        super().__init__()
        self.fc = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = torch.sigmoid(self.fc(x.mean(dim=(2, 3, 4))))
        return w[:, :, None, None, None] * x


class InceptionBlock(nn.Module):
    """Four gated branches, concatenated on channels (s3dg.py:27-76)."""

    def __init__(self, cin: int, widths: Sequence[int], frozen_bn: bool = True):
        super().__init__()
        c0, c1a, c1b, c2a, c2b, c3b = widths
        st = lambda i, o, k, sep: STConv3D(i, o, k, (1, 1, 1) if sep else (0, 0, 0), sep,
                                           frozen_bn)
        self.conv_b0 = st(cin, c0, (1, 1, 1), False)
        self.conv_b1_a = st(cin, c1a, (1, 1, 1), False)
        self.conv_b1_b = st(c1a, c1b, (3, 3, 3), True)
        self.conv_b2_a = st(cin, c2a, (1, 1, 1), False)
        self.conv_b2_b = st(c2a, c2b, (3, 3, 3), True)
        self.conv_b3_b = st(cin, c3b, (1, 1, 1), False)
        self.gating_b0 = SelfGating(c0)
        self.gating_b1 = SelfGating(c1b)
        self.gating_b2 = SelfGating(c2b)
        self.gating_b3 = SelfGating(c3b)
        self.output_dim = c0 + c1b + c2b + c3b

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b0 = self.gating_b0(self.conv_b0(x))
        b1 = self.gating_b1(self.conv_b1_b(self.conv_b1_a(x)))
        b2 = self.gating_b2(self.conv_b2_b(self.conv_b2_a(x)))
        b3 = self.gating_b3(self.conv_b3_b(max_pool_same(x, (3, 3, 3), (1, 1, 1))))
        return torch.cat([b0, b1, b2, b3], dim=1)


class S3D(nn.Module):
    """S3D-G: ``forward(x)`` -> ``fc`` of the 1024-d mixed_5c mean
    [B, num_classes]; ``return_embedding=True`` -> the 1024-d mean itself
    (s3dg.py:321-348)."""

    def __init__(self, num_classes: int = 512, freeze_early: bool = False,
                 train_bn_stats: bool = False, fold_s2d: bool = True):
        super().__init__()
        self.freeze_early = freeze_early
        frozen = not train_bn_stats
        self.conv1 = STConv3D(24, 64, (2, 4, 4), (1, 2, 2), frozen_bn=frozen, fold_s2d=fold_s2d)
        self.conv_2b = STConv3D(64, 64, (1, 1, 1), frozen_bn=frozen)
        self.conv_2c = STConv3D(64, 192, (3, 3, 3), (1, 1, 1), separable=True, frozen_bn=frozen)
        self.gating = SelfGating(192)
        cin = 192
        for name, widths in INCEPTION:
            block = InceptionBlock(cin, widths, frozen)
            self.add_module(name, block)
            cin = block.output_dim
        self.fc = nn.Linear(cin, num_classes)

    def sync_batch_stats(self, group) -> "S3D":
        """Training BNs normalise with the statistics of every rank's batch
        of ``group`` (None: this process's batch)."""
        for m in self.modules():
            if isinstance(m, BatchNorm):
                m.group = group
        return self

    def early(self, x: torch.Tensor) -> torch.Tensor:
        """conv1 ... mixed_3c (what ``freeze_early`` freezes)."""
        if not self.conv1.fold_s2d:
            x = space_to_depth(x)
        x = self.conv1(x)[:, :, 1:, 1:, 1:]  # the TF-SAME crop (s3dg.py:327-329)
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2))  # maxpool_2a
        x = self.gating(self.conv_2c(self.conv_2b(x)))
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2))  # maxpool_3a
        return self.mixed_3c(self.mixed_3b(x))

    def forward(self, x: torch.Tensor, return_embedding: bool = False) -> torch.Tensor:
        if self.freeze_early:  # freeze_forward (s3dg.py:351-378)
            with torch.no_grad():
                x = self.early(x)
        else:
            x = self.early(x)
        x = max_pool_same(x, (3, 3, 3), (2, 2, 2))  # maxpool_4a
        for name in ("mixed_4b", "mixed_4c", "mixed_4d", "mixed_4e", "mixed_4f"):
            x = getattr(self, name)(x)
        x = max_pool_same(x, (2, 2, 2), (2, 2, 2))  # maxpool_5a
        x = self.mixed_5c(self.mixed_5b(x))
        emb = x.mean(dim=(2, 3, 4))  # [B, 1024]
        return emb if return_embedding else self.fc(emb)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "S3D":
        """The JAX init's distributions, drawn from ``generator``: convs He
        normal (truncated at 2σ, flax ``he_normal``), Linear weights LeCun
        normal, biases 0, BN scale 1, shift 0, mean 0, var 1."""
        for name, p in self.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif p.dim() == 5:
                fan_in = p[0].numel()
                p.copy_(truncated_normal(p.shape, math.sqrt(2.0 / fan_in), generator))
            elif p.dim() == 2:
                p.copy_(truncated_normal(p.shape, math.sqrt(1.0 / p.shape[1]), generator))
            else:  # BN scale
                p.fill_(1.0)
        for name, b in self.named_buffers():
            b.fill_(1.0 if name.endswith("running_var") else 0.0)
        return self


def truncated_normal(shape, std: float, generator: torch.Generator) -> torch.Tensor:
    """N(0, std²) truncated at ±2 standard deviations of the underlying
    normal, rescaled to variance std² (flax ``variance_scaling(...,
    'truncated_normal')``)."""
    out = torch.empty(shape)
    nn.init.trunc_normal_(out, a=-2.0, b=2.0, generator=generator)
    return out * (std / 0.87962566103423978)
