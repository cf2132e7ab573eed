"""Agreement self-labelling, the heart of Stage 2 (counterpart of
temporalalignnet_tpu/losses/agreement.py; reference train/loss.py:88-229).

From the (EMA) model's same-video similarity logits, find each sentence's
best temporal window by sliding an average-pool kernel of the sentence's
original duration over every start ("circulant kernel bank",
loss.py:16-23,117-144), check the dual and joint windows' agreement by IoU,
gate by confidence quantiles, and emit pseudo-label targets.

No gradient flows here (the reference runs under ``torch.no_grad``,
loss.py:89); everything is f32 on the caller's device.  The discrete steps
(``argmax``, the ``>=`` quantile gates) take the first maximal index, as
``jnp.argmax`` does, so the targets equal JAX's wherever no two windows'
scores tie to within rounding.

Shapes: logits_diag [B, S, T, N] (the same-video slice), masks [B, T] /
[B, N] (True = pad), binary_tgt_raw [B, N, T].  Under a process group
(``group``) these are a rank's videos; the two confidence quantiles and the
``confidence-ratio`` are over every rank's sentences, as JAX computes them
over the global batch.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from temporalalignnet_torch.core.config import LossConfig
from temporalalignnet_torch.losses.masked import masked_mean, masked_quantile
from temporalalignnet_torch.parallel.distributed import all_gather, all_reduce_sum


def circulant_last(x: torch.Tensor) -> torch.Tensor:
    """C[..., i, j] = x[..., (j - i) mod T] (loss.py:16-23): row i is x rolled
    right by i, the duration kernel slid to start i."""
    T = x.shape[-1]
    pos = torch.arange(T, device=x.device)
    return x[..., (pos[None, :] - pos[:, None]) % T]  # [..., T, T]


def _window_kernel_bank(binary_tgt_raw: torch.Tensor,  # [B, N, T]
                        text_padding_mask: torch.Tensor,  # [B, N]
                        ) -> torch.Tensor:
    """Normalized sliding average-pool kernels [B, N, T(start), T(pos)]
    (loss.py:113-132)."""
    T = binary_tgt_raw.shape[-1]
    durations = binary_tgt_raw.float().sum(-1).clamp(min=1.0)
    durations = durations.masked_fill(text_padding_mask, 0.0)  # loss.py:115
    steps = torch.arange(T, dtype=torch.float32, device=durations.device)
    C = circulant_last((steps < durations[..., None]).float())  # [B, N, T, T]
    pos = torch.arange(T, device=C.device)
    # a window starting at i may not wrap before i (loss.py:122-123)
    C = C.masked_fill(pos[:, None] > pos[None, :], 0.0)
    # drop the windows truncated at the end (loss.py:124)
    C = C.masked_fill((C.sum(-1) < durations[..., None])[..., None], 0.0)
    # avoid boundary collapse (loss.py:127-128)
    C[..., 0] = 0.0
    C[..., -1] = 0.0
    # average-pool weights (loss.py:130-132)
    return C / C.sum(-1, keepdim=True).clamp(min=1e-3)


def _two_way_softmax(logits_diag: torch.Tensor, temperature: float) -> torch.Tensor:
    """Softmax over sentences, /tau, softmax over time: the exclusion-principle
    approximation (loss.py:104,160).  logits_diag [B, S, T, N]."""
    return torch.softmax(torch.softmax(logits_diag, dim=-1) / temperature, dim=-2)


def pad_fill(logits_diag: torch.Tensor, video_padding_mask: torch.Tensor,
             text_padding_mask: torch.Tensor, mask_value: float) -> torch.Tensor:
    """f32 logits [B, S, T, N] with padded positions and sentences set to
    ``mask_value``."""
    x = logits_diag.float().masked_fill(video_padding_mask.bool()[:, None, :, None], mask_value)
    return x.masked_fill(text_padding_mask.bool()[:, None, None, :], mask_value)


def window_scores(logits_diag: torch.Tensor,  # [B, S, T, N], pad-filled
                  C: torch.Tensor,  # [B, N, T, T]
                  temperature: float) -> torch.Tensor:
    """[B, N, T]: each start's window mean of the last layer's two-way
    softmax, the scores whose argmax picks a sentence's window."""
    prob_last = _two_way_softmax(logits_diag, temperature)[:, -1]  # [B, T, N]
    # prob_scan[b, n, i] = sum_j prob_last[b, j, n] C[b, n, i, j]
    return torch.einsum("bjn,bnij->bni", prob_last, C)


def _best_window_circulant(logits_diag: torch.Tensor,  # [B, S, T, N], pad-filled
                           C: torch.Tensor,  # [B, N, T, T]
                           temperature: float,
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The materialized kernel bank (loss.py:133-144), the path
    ``agreement_self_labelling`` takes.  Returns (target [B, T, N] 0/1,
    the best window's mean probability [B, N], its mean logit [B, N])."""
    prob_scan = window_scores(logits_diag, C, temperature)
    max_prob = prob_scan.amax(-1)
    max_position = prob_scan.argmax(-1)  # the first maximal index, as jnp.argmax
    window = torch.gather(
        C, 2, max_position[:, :, None, None].expand(-1, -1, 1, C.shape[-1]))[:, :, 0]
    max_logits = torch.einsum("btn,bnt->bn", logits_diag[:, -1], window)
    return (window > 0).float().transpose(1, 2), max_prob, max_logits


def _sliding_mean(x: torch.Tensor, durations: torch.Tensor):
    """Mean of x over [i, i + d) ∩ [1, T - 2] for every start i, as cumsum
    differences: O(B N T) instead of the kernel bank's O(B N T²).

    x [B, T, N], durations [B, N] (0 = padded sentence).  Returns (scan,
    cnt, row_valid), each [B, N, T], with the kernel bank's semantics:
    windows past the end dropped, positions 0 and T - 1 in no window, the
    mean over the positions left."""
    B, T, N = x.shape
    pos = torch.arange(T, device=x.device)
    keep = (pos >= 1) & (pos <= T - 2)  # boundary positions excluded
    xk = torch.where(keep, x.transpose(1, 2), torch.zeros((), device=x.device))
    zero = torch.zeros(B, N, 1, dtype=xk.dtype, device=x.device)
    S = torch.cat([zero, xk.cumsum(-1)], dim=-1)  # [B, N, T + 1]
    Sc = torch.cat([torch.zeros(1, device=x.device), keep.float().cumsum(0)])  # [T + 1]
    start = pos.expand(B, N, T)
    d = durations[:, :, None].long()
    end = torch.clamp(start + d, max=T)
    scan_sum = S.gather(-1, end) - S.gather(-1, start)
    cnt = Sc[end] - Sc[start]
    row_valid = (start + d <= T) & (d > 0)
    scan = torch.where(row_valid, scan_sum / cnt.clamp(min=1e-3),
                       torch.zeros((), device=x.device))
    return scan, cnt, row_valid


def _best_window_cumsum(logits_diag: torch.Tensor,  # [B, S, T, N], pad-filled
                        durations: torch.Tensor,  # [B, N] (0 = padded)
                        temperature: float,
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The O(B N T) cumsum form of ``_best_window_circulant``, kept as its
    oracle as in the JAX package (which measured it slower on its chip)."""
    T = logits_diag.shape[2]
    prob_scan, _, row_valid = _sliding_mean(
        _two_way_softmax(logits_diag, temperature)[:, -1], durations)
    logit_scan, _, _ = _sliding_mean(logits_diag[:, -1], durations)
    max_prob = prob_scan.amax(-1)
    max_position = prob_scan.argmax(-1, keepdim=True)  # [B, N, 1]
    chosen_valid = row_valid.gather(-1, max_position)
    max_logits = torch.where(chosen_valid[..., 0], logit_scan.gather(-1, max_position)[..., 0],
                             torch.zeros((), device=logits_diag.device))
    pos = torch.arange(T, device=logits_diag.device)
    d = durations[:, :, None].long()
    window = ((pos >= max_position) & (pos < max_position + d) & (pos >= 1) & (pos <= T - 2)
              & chosen_valid)
    return window.float().transpose(1, 2), max_prob, max_logits


@torch.no_grad()
def agreement_self_labelling(
    logits_joint_diag: torch.Tensor,  # [B, S, T, N]
    logits_dual_diag: torch.Tensor,  # [B, S, T, N]
    video_padding_mask: torch.Tensor,  # [B, T] True = pad
    text_padding_mask: torch.Tensor,  # [B, N] True = pad
    binary_tgt_raw: torch.Tensor,  # [B, N, T]
    cfg: LossConfig,
    group=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (agreement target [B, T, N] f32 0/1, metrics).  The caller
    expands the target to the cross-batch mask with an identity over videos:
    only same-video pairs are ever positive (loss.py:84-85)."""
    text_padding_mask = text_padding_mask.bool()
    C = _window_kernel_bank(binary_tgt_raw, text_padding_mask)
    joint_tgt, _, joint_max_logits = _best_window_circulant(
        pad_fill(logits_joint_diag, video_padding_mask, text_padding_mask, cfg.mask_value), C,
        cfg.temperature)
    dual_tgt, _, dual_max_logits = _best_window_circulant(
        pad_fill(logits_dual_diag, video_padding_mask, text_padding_mask, cfg.mask_value), C,
        cfg.temperature)

    # dual/joint IoU per sentence (loss.py:182-186)
    inter_diag = ((joint_tgt > 0) & (dual_tgt > 0)).float()
    union_diag = ((joint_tgt > 0) | (dual_tgt > 0)).float()
    iou = inter_diag.sum(1) / union_diag.sum(1).clamp(min=1e-5)  # [B, N]

    valid = ~text_padding_mask
    every = (lambda x: x) if group is None else (lambda x: all_gather(x, 0, group))
    valid_all = every(valid.to(torch.uint8)).bool()
    dual_conf = dual_max_logits >= masked_quantile(every(dual_max_logits), valid_all,
                                                   cfg.confidence_quantile)
    joint_conf = joint_max_logits >= masked_quantile(every(joint_max_logits), valid_all,
                                                     cfg.confidence_quantile)
    confidence_iou = iou >= cfg.iou_threshold
    confidence_mask = dual_conf & joint_conf & confidence_iou  # [B, N]

    binary_diag = binary_tgt_raw.float().transpose(1, 2)  # [B, T, N]
    atype = cfg.temporal_agreement_type
    if atype == "i":
        agreement = inter_diag * confidence_mask[:, None, :]
    elif atype == "u":
        agreement = union_diag * confidence_mask[:, None, :]
    elif atype == "keep":
        # keep the YouTube timestamps; the self-label where the IoU is
        # confident (loss.py:207-210)
        agreement = torch.where(confidence_iou[:, None, :], union_diag, binary_diag)
    elif atype == "keep-joint":
        agreement = torch.where(confidence_iou[:, None, :], joint_tgt, binary_diag)
    else:
        raise ValueError(f"temporal_agreement_type {atype!r}")

    # exclusion: each timestep keeps only its first positive sentence
    # (loss.py:216-226); sentence 0's channel is restored afterwards, and a
    # sentence left with no positive falls back to its original target:
    # the reference's quirks, kept exactly
    N = agreement.shape[-1]
    dedup = torch.eye(N, device=agreement.device)[agreement.argmax(-1)]  # one-hot [B, T, N]
    dedup[..., 0] = agreement[..., 0]
    no_pos = dedup.sum(1) == 0  # [B, N]
    dedup = torch.where(no_pos[:, None, :], binary_diag, dedup)

    if group is None:
        ratio = masked_mean(confidence_mask.float(), valid)
    else:
        m = valid.float()
        sums = all_reduce_sum(torch.stack([(confidence_mask.float() * m).sum(), m.sum()]), group)
        ratio = sums[0] / sums[1].clamp(min=1.0)
    metrics = {
        "confidence-ratio": ratio,
        "iou-threshold": torch.full((), cfg.iou_threshold, device=dedup.device),
    }
    return dedup, metrics
