"""Multi-layer MIL-NCE, thresholding and the alignability BCE, Stage 1
(counterpart of temporalalignnet_tpu/losses/tan_loss.py; reference
train/loss.py:55-373).

Fixed-shape throughout: every boolean compress of the reference
(``x[:, ~text_padding_mask]``) is arithmetic masking with the -6e4 fill and
masked means, the same in f32 (exp(-6e4) == 0).

``get_loss(outputs, batch, cfg) -> (loss, metrics)``:
- outputs: the training forward's dict (models/tan.py::TemporalAligner.forward);
- batch: start, end [B, N] (seconds in the window), video_padding_mask [B, T],
  text_padding_mask [B, N] (True = pad), and abs_text_pos [B, N, 2] or absent.
The agreement self-labelling of Stage 2 (``learn_agreement``) is slice 3.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from temporalalignnet_torch.core.config import LossConfig
from temporalalignnet_torch.losses.masked import masked_mean, masked_quantile, masked_std
from temporalalignnet_torch.ops.milnce import fused_milnce_elements, masked_lse_elements


def mask_from_time(start: torch.Tensor, end: torch.Tensor, num_timestamps: int,
                   text_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Bool [B, N, T]: True where start <= t < end (train/loss.py:26-41),
    False on padded sentences."""
    steps = torch.arange(num_timestamps, dtype=start.dtype, device=start.device)
    m = (start[..., None] <= steps) & (steps < end[..., None])
    if text_padding_mask is not None:
        m = m & ~text_padding_mask[..., None]
    return m


def positive_mask(start: torch.Tensor, end: torch.Tensor, num_timestamps: int,
                  text_padding_mask: torch.Tensor):
    """(pos_mask [B·T, B·N], col_valid [B·N]) bool: a window position and a
    sentence of the same video whose span holds it (loss.py:84-85); only
    same-video positives, padded sentences excluded."""
    B, N = start.shape
    tgt = mask_from_time(start, end, num_timestamps, text_padding_mask)  # [B, N, T]
    eye = torch.eye(B, dtype=torch.bool, device=tgt.device)
    col_valid = (~text_padding_mask).reshape(B * N)
    pos = tgt.transpose(1, 2)[:, :, :, None] & eye[:, None, None, :]  # [B, T, N, B]
    pos_mask = pos.permute(0, 1, 3, 2).reshape(B * num_timestamps, B * N) & col_valid[None]
    return pos_mask, col_valid


def _same_video_diagonal(logits: torch.Tensor) -> torch.Tensor:
    """[B, S, T, B, N] -> [B, S, T, N], the same-video slice (loss.py:92-96)."""
    return torch.diagonal(logits, dim1=0, dim2=3).permute(3, 0, 1, 2)


def _flat_layers(x: torch.Tensor) -> torch.Tensor:
    """[B, S, n, C] -> [S, B·n, C], contiguous."""
    B, S, n, C = x.shape
    return x.transpose(0, 1).reshape(S, B * n, C)


def _bce_with_logits(logits, labels, pos_weight, sel_mask):
    """Masked binary_cross_entropy_with_logits with pos_weight (loss.py:345-351)."""
    per_el = -(pos_weight * labels * F.logsigmoid(logits)
               + (1.0 - labels) * F.logsigmoid(-logits))
    return masked_mean(per_el, sel_mask)


def _milnce_means(v_el, t_el, row_mask, col_mask):
    return (masked_mean(v_el, row_mask[None].expand_as(v_el))
            + masked_mean(t_el, col_mask[None].expand_as(t_el))) / 2.0


def get_loss(outputs: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
             cfg: LossConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    if cfg.learn_agreement or cfg.model != "init":
        raise NotImplementedError(
            "Stage-2 co-training (learn_agreement, model='cotrain') comes with slice 3 "
            "of the port")
    inv_temp = 1.0 / cfg.temperature if cfg.sim == "cos" else 1.0  # loss.py:65-70
    mv = cfg.mask_value
    fused = cfg.use_fused_milnce
    if fused:
        vfd, tfd = outputs["dual_feature_video"], outputs["dual_feature_text"]
        vfj, tfj = outputs["joint_feature_video"], outputs["joint_feature_text"]
        B, S, T, _ = vfd.shape
        N = tfd.shape[1]
        diag_dual = torch.einsum("bstc,bnc->bstn", vfd.float(), tfd.float()) * inv_temp
        diag_joint = torch.einsum("bstc,bsnc->bstn", vfj.float(), tfj.float()) * inv_temp
    else:
        logits_dual = outputs["logits_dual"].float() * inv_temp
        logits_joint = outputs["logits_joint"].float() * inv_temp
        B, S, T, _, N = logits_dual.shape
        diag_dual = _same_video_diagonal(logits_dual)
        diag_joint = _same_video_diagonal(logits_joint)

    text_padding_mask = batch["text_padding_mask"].bool()
    metrics: Dict[str, torch.Tensor] = {}
    pos_mask, col_valid = positive_mask(batch["start"].float(), batch["end"].float(), T,
                                        text_padding_mask)
    row_mask = pos_mask.any(-1)  # video positions with a positive
    col_mask = pos_mask.any(-2)  # texts with a positive

    if fused:
        v_el_dual, t_el_dual = fused_milnce_elements(
            _flat_layers(vfd), tfd.reshape(B * N, -1), pos_mask, col_valid, mv, inv_temp)
        v_el_joint, t_el_joint = fused_milnce_elements(
            _flat_layers(vfj), _flat_layers(tfj), pos_mask, col_valid, mv, inv_temp)
    else:
        # the plain logits path: the same masked logsumexps on the [S, B·T, B·N] logits
        def flat(logits):
            return logits.transpose(0, 1).reshape(S, B * T, B * N)

        v_el_dual, t_el_dual = masked_lse_elements(flat(logits_dual), pos_mask, col_valid, mv)
        v_el_joint, t_el_joint = masked_lse_elements(flat(logits_joint), pos_mask, col_valid,
                                                     mv)
    loss_dual = _milnce_means(v_el_dual, t_el_dual, row_mask, col_mask)
    loss_joint = _milnce_means(v_el_joint, t_el_joint, row_mask, col_mask)
    metrics["loss-dual"] = loss_dual
    metrics["loss-joint"] = loss_joint
    loss_dual_final, loss_joint_final = loss_dual, loss_joint
    loss_bce_joint = None

    if cfg.loss_threshold > 0 or cfg.use_alignability_head:
        # per-text hardness from the last layer's same-video max logits
        # (loss.py:277-290); statistics over the valid texts only
        max_dual = diag_dual[:, -1].amax(1).reshape(B * N).detach()
        max_joint = diag_joint[:, -1].amax(1).reshape(B * N).detach()

        def standardize(x):
            return (x - masked_mean(x, col_valid)) / masked_std(x, col_valid)

        t_th_metric = -(standardize(max_dual) + standardize(max_joint))
        t_th_mask = t_th_metric <= masked_quantile(t_th_metric, col_valid, cfg.loss_threshold)

        if cfg.loss_threshold > 0:
            metrics["loss-dual-all"] = loss_dual
            metrics["loss-joint-all"] = loss_joint
            row_mask_th = (pos_mask & t_th_mask[None]).any(-1)
            t_sel = col_mask & t_th_mask & col_valid
            loss_dual_final = _milnce_means(v_el_dual, t_el_dual, row_mask_th, t_sel)
            loss_joint_final = _milnce_means(v_el_joint, t_el_joint, row_mask_th, t_sel)
            metrics["loss-dual"] = loss_dual_final
            metrics["loss-joint"] = loss_joint_final

        if cfg.use_alignability_head:
            # pseudo labels: 1 if both max logits above their medians, 0 if
            # both below, 2 = ignore (loss.py:308-323)
            med_dual = masked_quantile(max_dual, col_valid, 0.5)
            med_joint = masked_quantile(max_joint, col_valid, 0.5)
            labels = torch.full((B * N,), 2.0, device=max_dual.device)
            labels = torch.where((max_dual > med_dual) & (max_joint > med_joint),
                                 torch.ones_like(labels), labels)
            labels = torch.where((max_dual < med_dual) & (max_joint < med_joint),
                                 torch.zeros_like(labels), labels)
            if batch.get("abs_text_pos") is not None:
                # texts near the video boundary forced negative (loss.py:325-328)
                center = batch["abs_text_pos"].float().mean(-1).reshape(B * N)
                labels = torch.where((center < 0.2) | (center > 0.8), torch.zeros_like(labels),
                                     labels)
            sel = col_valid & col_mask & (labels != 2.0)
            pos_weight = 1.0 / masked_mean(labels, sel).clamp(min=1e-6) - 1.0
            logit_dual_a = outputs["dual_logits_alignability"][..., 0].reshape(B * N).float()
            joint_a = outputs["joint_logits_alignability"]
            a_layer = min(cfg.alignability_layer, joint_a.shape[1] - 1)
            logit_joint_a = joint_a[:, a_layer, :, 0].reshape(B * N).float()
            loss_bce_joint = _bce_with_logits(logit_joint_a, labels, pos_weight, sel)
            metrics["loss-joint-bce"] = loss_bce_joint
            metrics["loss-dual-bce"] = _bce_with_logits(logit_dual_a, labels, pos_weight, sel)
            metrics["alignability_top1"] = masked_mean(
                ((logit_joint_a > 0).float() == labels).float(), sel)

    # final combination (loss.py:359-373)
    if cfg.loss_threshold > 0:
        metrics["loss-total"] = (loss_dual + loss_joint) / 2.0
    loss = (loss_dual_final + loss_joint_final) / 2.0
    if cfg.use_alignability_head and loss_bce_joint is not None:
        nce_weight = 0.0 if cfg.optim_policy == "bce" else 1.0
        loss = loss * nce_weight + loss_bce_joint
    metrics["loss"] = loss
    return loss, metrics
