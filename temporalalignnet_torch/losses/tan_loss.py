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

Data parallelism (``group``, a process group of W ranks, each with B/W
consecutive videos of the global batch of B): every batch-level statistic
is the global batch's, as GSPMD makes it in JAX.  The MIL-NCE columns are
every rank's texts (gathered; the column logsumexps merged over the ranks),
the masked means' row and column counts are global, and so are the
threshold's and the alignability head's statistics and labels (from the
gathered, detached same-video maxima) and ``pos_weight``.

Which loss each rank backprops.  Write the 1-process loss of the global
batch as L = sum_k a_k · M_k over the means it combines.  A mean over rows
or texts, M = sum_i x_i / n, splits over the ranks that own the i: rank r's
share is M_r = sum_{i of r} x_i / n with the global count n.  A mean over
the columns (the text elements t_el, replicated on every rank after the
merge) has the share M / W on every rank.  So the rank's loss
l_r = sum_k a_k · M_k,r satisfies sum_r l_r = L.  Every collective's
backward is its adjoint (``parallel/distributed.py``: the gather's a
reduce-scatter, the merge's sum again a sum), so rank r's backward of l_r
gives g_r, the gradient of sum_r' l_r' through what rank r computed, and
sum_r g_r = dL/dθ for the replicated params θ.  The train step backprops
W · l_r and averages the gradients over the ranks:
(1 / W) · sum_r W · g_r = dL/dθ, the 1-process gradient.

The loss and the metrics ``get_loss`` returns hold the global values (the
shares summed over the ranks); the loss's gradient is that of l_r.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from temporalalignnet_torch.core.config import LossConfig
from temporalalignnet_torch.losses.agreement import agreement_self_labelling
from temporalalignnet_torch.losses.masked import masked_mean, masked_quantile, masked_std
from temporalalignnet_torch.ops.milnce import fused_milnce_elements, masked_lse_elements
from temporalalignnet_torch.parallel.distributed import (all_gather, all_reduce_max,
                                                         all_reduce_sum, rank, world_size)


def mask_from_time(start: torch.Tensor, end: torch.Tensor, num_timestamps: int,
                   text_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Bool [B, N, T]: True where start <= t < end (train/loss.py:26-41),
    False on padded sentences."""
    steps = torch.arange(num_timestamps, dtype=start.dtype, device=start.device)
    m = (start[..., None] <= steps) & (steps < end[..., None])
    if text_padding_mask is not None:
        m = m & ~text_padding_mask[..., None]
    return m


def positive_mask_from_target(tgt_diag: torch.Tensor, text_padding_mask: torch.Tensor,
                              first_video: int = 0):
    """(pos_mask [B·T, Ba·N], col_valid [Ba·N]) bool from a same-video target
    [B, T, N]: a window position and a sentence of the same video where the
    target is positive (loss.py:84-85); padded sentences excluded.  The
    columns are the Ba videos of ``text_padding_mask`` [Ba, N], of which the
    rows' videos are Ba[first_video : first_video + B] (a rank's rows
    against every rank's columns)."""
    B, T, N = tgt_diag.shape
    Ba = text_padding_mask.shape[0]
    dev = tgt_diag.device
    eye = (torch.arange(B, device=dev)[:, None] + first_video) == torch.arange(Ba, device=dev)
    col_valid = (~text_padding_mask).reshape(Ba * N)
    pos = (tgt_diag > 0)[:, :, None, :] & eye[:, None, :, None]  # [B, T, Ba, N]
    return pos.reshape(B * T, Ba * N) & col_valid[None], col_valid


def positive_mask(start: torch.Tensor, end: torch.Tensor, num_timestamps: int,
                  text_padding_mask: torch.Tensor):
    """``positive_mask_from_target`` of the ASR spans: a position is positive
    for a sentence of the same video whose span holds it."""
    tgt = mask_from_time(start, end, num_timestamps, text_padding_mask)  # [B, N, T]
    return positive_mask_from_target(tgt.transpose(1, 2), text_padding_mask)


def _same_video_diagonal(logits: torch.Tensor, first_video: int = 0) -> torch.Tensor:
    """[B, S, T, Ba, N] -> [B, S, T, N], the same-video slice (loss.py:92-96);
    the rows' videos are Ba[first_video : first_video + B]."""
    return torch.diagonal(logits, offset=first_video, dim1=0, dim2=3).permute(3, 0, 1, 2)


def _flat_layers(x: torch.Tensor) -> torch.Tensor:
    """[B, S, n, C] -> [S, B·n, C], contiguous."""
    B, S, n, C = x.shape
    return x.transpose(0, 1).reshape(S, B * n, C)


class _Shares:
    """How the loss reads the batch under a process group (the module
    docstring): this rank's share of a mean over its own rows or texts,
    and of a replicated column mean; without a group the means themselves."""

    def __init__(self, group, videos: int):
        self.group = group
        self.world = world_size(group) if group is not None else 1
        self.first = rank(group) * videos if group is not None else 0

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of a statistic, no gradient (bools as bytes)."""
        if self.group is None:
            return x
        if x.dtype == torch.bool:
            return all_gather(x.to(torch.uint8), 0, self.group).bool()
        return all_gather(x.detach(), 0, self.group)

    def own(self, x: torch.Tensor, videos: int) -> torch.Tensor:
        """This rank's rows of a gathered [B_all·n] vector."""
        n = x.shape[0] // (videos * self.world)
        return x[self.first * n:(self.first + videos) * n]

    def any(self, mask: torch.Tensor) -> torch.Tensor:
        """The OR over the ranks of a bool mask."""
        if self.group is None:
            return mask
        return all_reduce_max(mask.to(torch.uint8), self.group).bool()

    def rows(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """This rank's share of the global masked mean of x over the rows it owns."""
        if self.group is None:
            return masked_mean(x, mask)
        m = mask.to(x.dtype)
        count = all_reduce_sum(m.sum().detach(), self.group)
        return (x * m).sum() / count.clamp(min=1.0)

    def replicated(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's share of a value every rank holds."""
        return x if self.group is None else x / self.world

    def totals(self, loss: torch.Tensor, metrics: Dict[str, torch.Tensor]):
        """(loss with the global value and this rank's gradient, the metrics'
        global values): the shares summed over the ranks."""
        if self.group is None:
            return loss, metrics
        keys = list(metrics)
        summed = all_reduce_sum(torch.stack([loss.detach().float()]
                                            + [metrics[k].detach().float() for k in keys]),
                                self.group)
        return (loss + (summed[0] - loss.detach()),
                {k: summed[i + 1] for i, k in enumerate(keys)})


def _bce_with_logits(logits, labels, pos_weight, sel_mask, shares: _Shares):
    """Masked binary_cross_entropy_with_logits with pos_weight (loss.py:345-351)."""
    per_el = -(pos_weight * labels * F.logsigmoid(logits)
               + (1.0 - labels) * F.logsigmoid(-logits))
    return shares.rows(per_el, sel_mask)


def _milnce_means(v_el, t_el, row_mask, col_mask, shares: _Shares):
    return (shares.rows(v_el, row_mask[None].expand_as(v_el))
            + shares.replicated(masked_mean(t_el, col_mask[None].expand_as(t_el)))) / 2.0


def _diag_dual(vfeat, tfeat, inv_temp):
    """Same-video per-layer sims [B, S, T, N] from the dual features."""
    return torch.einsum("bstc,bnc->bstn", vfeat.float(), tfeat.float()) * inv_temp


def _diag_joint(vfeat, tfeat, inv_temp):
    """... and from the joint features (per-layer text)."""
    return torch.einsum("bstc,bsnc->bstn", vfeat.float(), tfeat.float()) * inv_temp


def get_loss(outputs: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
             cfg: LossConfig, group=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, metrics) of the batch; with ``group`` of this rank's rows of
    the global batch (the module docstring)."""
    inv_temp = 1.0 / cfg.temperature if cfg.sim == "cos" else 1.0  # loss.py:65-70
    mv = cfg.mask_value
    fused = cfg.use_fused_milnce
    text_padding_mask = batch["text_padding_mask"].bool()
    B = text_padding_mask.shape[0]
    shares = _Shares(group, B)
    lo = shares.first
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
        B, S, T, Ba, N = logits_dual.shape
        diag_dual = _same_video_diagonal(logits_dual, lo)
        diag_joint = _same_video_diagonal(logits_joint, lo)

    metrics: Dict[str, torch.Tensor] = {}
    binary_tgt = mask_from_time(batch["start"].float(), batch["end"].float(), T,
                                text_padding_mask)  # [B, N, T]
    replicated_metrics: Dict[str, torch.Tensor] = {}
    if cfg.learn_agreement:
        # the targets' source: the EMA twin's same-video sims for cotrain, the
        # online model's own for init (loss.py:88-104)
        if cfg.model == "cotrain" and fused:
            src_joint = _diag_joint(outputs["ema-joint_feature_video"],
                                    outputs["ema-joint_feature_text"], inv_temp)
            src_dual = _diag_dual(outputs["ema-dual_feature_video"],
                                  outputs["ema-dual_feature_text"], inv_temp)
        elif cfg.model == "cotrain":
            src_joint = _same_video_diagonal(outputs["ema-logits_joint"].float() * inv_temp, lo)
            src_dual = _same_video_diagonal(outputs["ema-logits_dual"].float() * inv_temp, lo)
        else:
            src_joint, src_dual = diag_joint, diag_dual
        tgt_diag, replicated_metrics = agreement_self_labelling(
            src_joint.detach(), src_dual.detach(), batch["video_padding_mask"],
            text_padding_mask, binary_tgt, cfg, group=group)
    else:
        tgt_diag = binary_tgt.transpose(1, 2)  # [B, T, N]
    # every rank's texts are the columns
    pos_mask, col_valid = positive_mask_from_target(
        tgt_diag, shares.gather(text_padding_mask), lo)
    row_mask = pos_mask.any(-1)  # video positions with a positive
    col_mask = shares.any(pos_mask.any(-2))  # texts with a positive

    if fused:
        v_el_dual, t_el_dual = fused_milnce_elements(
            _flat_layers(vfd), tfd.reshape(B * N, -1), pos_mask, col_valid, mv, inv_temp,
            group=group)
        v_el_joint, t_el_joint = fused_milnce_elements(
            _flat_layers(vfj), _flat_layers(tfj), pos_mask, col_valid, mv, inv_temp,
            group=group)
    else:
        # the plain logits path: the same masked logsumexps on the [S, B·T, Ba·N] logits
        def flat(logits):
            return logits.transpose(0, 1).reshape(S, B * T, Ba * N)

        v_el_dual, t_el_dual = masked_lse_elements(flat(logits_dual), pos_mask, col_valid, mv,
                                                   group)
        v_el_joint, t_el_joint = masked_lse_elements(flat(logits_joint), pos_mask, col_valid,
                                                     mv, group)
    loss_dual = _milnce_means(v_el_dual, t_el_dual, row_mask, col_mask, shares)
    loss_joint = _milnce_means(v_el_joint, t_el_joint, row_mask, col_mask, shares)
    metrics["loss-dual"] = loss_dual
    metrics["loss-joint"] = loss_joint
    loss_dual_final, loss_joint_final = loss_dual, loss_joint
    loss_bce_joint = None

    if cfg.loss_threshold > 0 or cfg.use_alignability_head:
        # per-text hardness from the last layer's same-video max logits
        # (loss.py:277-290); statistics over the valid texts only, of every rank
        max_dual = shares.gather(diag_dual[:, -1].amax(1).reshape(B * N).detach())
        max_joint = shares.gather(diag_joint[:, -1].amax(1).reshape(B * N).detach())

        def standardize(x):
            return (x - masked_mean(x, col_valid)) / masked_std(x, col_valid)

        t_th_metric = -(standardize(max_dual) + standardize(max_joint))
        t_th_mask = t_th_metric <= masked_quantile(t_th_metric, col_valid, cfg.loss_threshold)

        if cfg.loss_threshold > 0:
            metrics["loss-dual-all"] = loss_dual
            metrics["loss-joint-all"] = loss_joint
            row_mask_th = (pos_mask & t_th_mask[None]).any(-1)
            t_sel = col_mask & t_th_mask & col_valid
            loss_dual_final = _milnce_means(v_el_dual, t_el_dual, row_mask_th, t_sel, shares)
            loss_joint_final = _milnce_means(v_el_joint, t_el_joint, row_mask_th, t_sel, shares)
            metrics["loss-dual"] = loss_dual_final
            metrics["loss-joint"] = loss_joint_final

        if cfg.use_alignability_head:
            # pseudo labels: 1 if both max logits above their medians, 0 if
            # both below, 2 = ignore (loss.py:308-323)
            med_dual = masked_quantile(max_dual, col_valid, 0.5)
            med_joint = masked_quantile(max_joint, col_valid, 0.5)
            labels = torch.full(max_dual.shape, 2.0, device=max_dual.device)
            labels = torch.where((max_dual > med_dual) & (max_joint > med_joint),
                                 torch.ones_like(labels), labels)
            labels = torch.where((max_dual < med_dual) & (max_joint < med_joint),
                                 torch.zeros_like(labels), labels)
            if batch.get("abs_text_pos") is not None:
                # texts near the video boundary forced negative (loss.py:325-328)
                center = shares.gather(batch["abs_text_pos"].float().mean(-1).reshape(B * N))
                labels = torch.where((center < 0.2) | (center > 0.8), torch.zeros_like(labels),
                                     labels)
            sel = col_valid & col_mask & (labels != 2.0)
            pos_weight = 1.0 / masked_mean(labels, sel).clamp(min=1e-6) - 1.0
            labels, sel = shares.own(labels, B), shares.own(sel, B)  # this rank's texts
            logit_dual_a = outputs["dual_logits_alignability"][..., 0].reshape(B * N).float()
            joint_a = outputs["joint_logits_alignability"]
            a_layer = min(cfg.alignability_layer, joint_a.shape[1] - 1)
            logit_joint_a = joint_a[:, a_layer, :, 0].reshape(B * N).float()
            loss_bce_joint = _bce_with_logits(logit_joint_a, labels, pos_weight, sel, shares)
            metrics["loss-joint-bce"] = loss_bce_joint
            metrics["loss-dual-bce"] = _bce_with_logits(logit_dual_a, labels, pos_weight, sel,
                                                        shares)
            metrics["alignability_top1"] = shares.rows(
                ((logit_joint_a > 0).float() == labels).float(), sel)

    # final combination (loss.py:359-373)
    if cfg.loss_threshold > 0:
        metrics["loss-total"] = (loss_dual + loss_joint) / 2.0
    loss = (loss_dual_final + loss_joint_final) / 2.0
    if cfg.use_alignability_head and loss_bce_joint is not None:
        nce_weight = 0.0 if cfg.optim_policy == "bce" else 1.0
        loss = loss * nce_weight + loss_bce_joint
    loss, metrics = shares.totals(loss, metrics)
    metrics["loss"] = loss
    return loss, {**replicated_metrics, **metrics}
