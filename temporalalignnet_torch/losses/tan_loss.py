"""Multi-layer MIL-NCE, thresholding, the alignability BCE and the Stage-2
agreement targets (counterpart of temporalalignnet_tpu/losses/tan_loss.py; reference
train/loss.py:55-373).

Fixed-shape throughout: every boolean compress of the reference
(``x[:, ~text_padding_mask]``) is arithmetic masking with the -6e4 fill and
masked means, the same in f32 (exp(-6e4) == 0).

``get_loss(outputs, batch, cfg) -> (loss, metrics)``:
- outputs: the training forward's dict (models/tan.py::TemporalAligner.forward),
  and for ``model='cotrain'`` the EMA twin's under ``ema-<key>``;
- batch: start, end [B, N] (seconds in the window), video_padding_mask [B, T],
  text_padding_mask [B, N] (True = pad), and abs_text_pos [B, N, 2] or absent.
With ``learn_agreement`` the positives come from the agreement targets
(losses/agreement.py) instead of the ASR spans.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from temporalalignnet_torch.core.config import LossConfig
from temporalalignnet_torch.losses.agreement import agreement_self_labelling
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


def positive_mask_from_target(tgt_diag: torch.Tensor, text_padding_mask: torch.Tensor):
    """(pos_mask [B·T, B·N], col_valid [B·N]) bool from a same-video target
    [B, T, N]: a window position and a sentence of the same video where the
    target is positive (loss.py:84-85); padded sentences excluded."""
    B, T, N = tgt_diag.shape
    eye = torch.eye(B, dtype=torch.bool, device=tgt_diag.device)
    col_valid = (~text_padding_mask).reshape(B * N)
    pos = (tgt_diag > 0)[:, :, None, :] & eye[:, None, :, None]  # [B, T, B, N]
    return pos.reshape(B * T, B * N) & col_valid[None], col_valid


def positive_mask(start: torch.Tensor, end: torch.Tensor, num_timestamps: int,
                  text_padding_mask: torch.Tensor):
    """``positive_mask_from_target`` of the ASR spans: a position is positive
    for a sentence of the same video whose span holds it."""
    tgt = mask_from_time(start, end, num_timestamps, text_padding_mask)  # [B, N, T]
    return positive_mask_from_target(tgt.transpose(1, 2), text_padding_mask)


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


def _diag_dual(vfeat, tfeat, inv_temp):
    """Same-video per-layer sims [B, S, T, N] from the dual features."""
    return torch.einsum("bstc,bnc->bstn", vfeat.float(), tfeat.float()) * inv_temp


def _diag_joint(vfeat, tfeat, inv_temp):
    """... and from the joint features (per-layer text)."""
    return torch.einsum("bstc,bsnc->bstn", vfeat.float(), tfeat.float()) * inv_temp


def get_loss(outputs: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
             cfg: LossConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    inv_temp = 1.0 / cfg.temperature if cfg.sim == "cos" else 1.0  # loss.py:65-70
    mv = cfg.mask_value
    fused = cfg.use_fused_milnce
    if fused:
        vfd, tfd = outputs["dual_feature_video"], outputs["dual_feature_text"]
        vfj, tfj = outputs["joint_feature_video"], outputs["joint_feature_text"]
        B, S, T, _ = vfd.shape
        N = tfd.shape[1]
        diag_dual = _diag_dual(vfd, tfd, inv_temp)
        diag_joint = _diag_joint(vfj, tfj, inv_temp)
    else:
        logits_dual = outputs["logits_dual"].float() * inv_temp
        logits_joint = outputs["logits_joint"].float() * inv_temp
        B, S, T, _, N = logits_dual.shape
        diag_dual = _same_video_diagonal(logits_dual)
        diag_joint = _same_video_diagonal(logits_joint)

    text_padding_mask = batch["text_padding_mask"].bool()
    metrics: Dict[str, torch.Tensor] = {}
    binary_tgt = mask_from_time(batch["start"].float(), batch["end"].float(), T,
                                text_padding_mask)  # [B, N, T]
    if cfg.learn_agreement:
        # the targets' source: the EMA twin's same-video sims for cotrain, the
        # online model's own for init (loss.py:88-104)
        if cfg.model == "cotrain" and fused:
            src_joint = _diag_joint(outputs["ema-joint_feature_video"],
                                    outputs["ema-joint_feature_text"], inv_temp)
            src_dual = _diag_dual(outputs["ema-dual_feature_video"],
                                  outputs["ema-dual_feature_text"], inv_temp)
        elif cfg.model == "cotrain":
            src_joint = _same_video_diagonal(outputs["ema-logits_joint"].float() * inv_temp)
            src_dual = _same_video_diagonal(outputs["ema-logits_dual"].float() * inv_temp)
        else:
            src_joint, src_dual = diag_joint, diag_dual
        tgt_diag, agree_metrics = agreement_self_labelling(
            src_joint.detach(), src_dual.detach(), batch["video_padding_mask"],
            text_padding_mask, binary_tgt, cfg)
        metrics.update(agree_metrics)
    else:
        tgt_diag = binary_tgt.transpose(1, 2)  # [B, T, N]
    pos_mask, col_valid = positive_mask_from_target(tgt_diag, text_padding_mask)
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
