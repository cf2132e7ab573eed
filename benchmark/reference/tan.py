"""The TAN of Temporal Alignment Networks (Han, Xie, Zisserman, CVPR 2022;
github.com/TengdaHan/TemporalAlignNet, model/tan_model.py, train/loss.py),
written plainly over a dict of named float32 weights.

- the word2vec sentence tower: a frozen word embedding, fc1, ReLU, a max
  over the words (pad filled with -6e4; an all-pad sentence keeps every
  word), fc2;
- a dual encoder over the video and a joint encoder over [video || text]:
  pre-LN blocks (packed q, k, v; QuickGELU MLP), per-layer taps (each block's
  ln_1 input from the second on, then the last output under its post-LN);
- learned temporal positions, read from a start offset in training;
- per-layer cosine similarities and the alignability head;
- Stage 1's training loss: multi-layer MIL-NCE over the batch's
  [S, B·T, B·N] logits at temperature 0.07, plus the alignability BCE on
  median pseudo-labels.

Every product goes through ``prec`` (``common.Precision``): as it is in the
reference, rounded to float8 in the control.  Plain PyTorch only.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .common import Precision

MASK_VALUE = -6.0e4
NEG_BIAS = -1.0e30


def param_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    D, Cv, P = cfg["width"], cfg["video_embed_dim"], cfg["num_pos_embeds"]
    hid = cfg["mlp_ratio"] * D
    shapes = {"temporal_pos_embed": (P, D), "text_temporal_pos_embed": (P, D)}
    for enc, layers in (("video_temporal_encoder", cfg["num_encoder_layers"]),
                        ("joint_temporal_encoder", cfg["num_joint_layers"])):
        for i in range(layers):
            pre = f"{enc}.resblocks.{i}."
            shapes.update({
                pre + "attn.in_proj_weight": (3 * D, D), pre + "attn.in_proj_bias": (3 * D,),
                pre + "attn.out_proj.weight": (D, D), pre + "attn.out_proj.bias": (D,),
                pre + "ln_1.weight": (D,), pre + "ln_1.bias": (D,),
                pre + "ln_2.weight": (D,), pre + "ln_2.bias": (D,),
                pre + "mlp.c_fc.weight": (hid, D), pre + "mlp.c_fc.bias": (hid,),
                pre + "mlp.c_proj.weight": (D, hid), pre + "mlp.c_proj.bias": (D,)})
    shapes["video_pre_proj.weight"] = (D, Cv)
    shapes["text_pre_proj.weight"] = (D, cfg["text_embed_dim"])
    for ln in ("ln_text_init", "ln_video_init", "ln_position_init", "ln_video_post_enc",
               "ln_joint_post_enc"):
        shapes[ln + ".weight"] = (D,)
        shapes[ln + ".bias"] = (D,)
    if cfg["use_alignability_head"]:
        shapes["binary_head.weight"] = (1, D)
        shapes["binary_head.bias"] = (1,)
    shapes["bert.word_embd.weight"] = (cfg["vocab_size"], cfg["word_dim"])
    shapes["bert.fc1.weight"] = (cfg["text_hidden_dim"], cfg["word_dim"])
    shapes["bert.fc1.bias"] = (cfg["text_hidden_dim"],)
    shapes["bert.fc2.weight"] = (cfg["text_embed_dim"], cfg["text_hidden_dim"])
    shapes["bert.fc2.bias"] = (cfg["text_embed_dim"],)
    return shapes


def init_rule(cfg: dict):
    """The CLIP-style draw of tan_model.py:76-97 (and a LeCun-normal text
    tower): ("normal", std) or ("const", value) per weight."""
    D = cfg["width"]
    proj_std = D ** -0.5 * (2 * cfg["num_joint_layers"]) ** -0.5

    def rule(name: str, shape) -> Tuple[str, float]:
        if name.endswith("in_proj_weight"):
            return "normal", D ** -0.5
        if name.endswith(("out_proj.weight", "c_proj.weight")):
            return "normal", proj_std
        if name.endswith("c_fc.weight"):
            return "normal", (2 * D) ** -0.5
        if "ln_" in name:
            return "const", 1.0 if name.endswith("weight") else 0.0
        if name.endswith("bias"):
            return "const", 0.0
        if name.endswith("word_embd.weight"):
            return "normal", 1.0
        if name.startswith("bert.fc"):
            return "normal", shape[1] ** -0.5
        return "normal", 0.01  # pre-projections, position tables, the head

    return rule


def trainable(name: str) -> bool:
    return "word_embd" not in name  # the frozen word2vec embedding


def decays(name: str) -> bool:
    """Biases and LayerNorm weights take no decay (train/main.py:330-356)."""
    parts = name.split(".")
    return not (parts[-1].endswith("bias") or any(p.startswith("ln_") for p in parts))


# ------------------------------------------------------------------ the model


def _linear(x, w, b, prec: Precision):
    return F.linear(prec(x), prec(w), b)


def _ln(x, p, name):
    return F.layer_norm(x, (x.shape[-1],), p[name + ".weight"], p[name + ".bias"], 1e-5)


def _attention(x, mask, p, pre, heads, prec):
    B, S, D = x.shape
    dh = D // heads
    qkv = _linear(x, p[pre + "in_proj_weight"], p[pre + "in_proj_bias"], prec)
    q, k, v = qkv.view(B, S, 3, heads, dh).permute(2, 0, 3, 1, 4)
    scores = prec(q) @ prec(k).transpose(-1, -2) / math.sqrt(dh)
    if mask is not None:
        scores = scores + torch.where(mask, NEG_BIAS, 0.0)[:, None, None, :]
    out = prec(torch.softmax(scores, dim=-1)) @ prec(v)
    out = out.transpose(1, 2).reshape(B, S, D)
    return _linear(out, p[pre + "out_proj.weight"], p[pre + "out_proj.bias"], prec)


def _encoder(x, mask, p, prefix, layers, heads, prec):
    taps = []
    for i in range(layers):
        pre = f"{prefix}.resblocks.{i}."
        xn = _ln(x, p, pre + "ln_1")
        x = x + _attention(xn, mask, p, pre + "attn.", heads, prec)
        h = _linear(_ln(x, p, pre + "ln_2"), p[pre + "mlp.c_fc.weight"], p[pre + "mlp.c_fc.bias"],
                    prec)
        h = h * torch.sigmoid(1.702 * h)
        x = x + _linear(h, p[pre + "mlp.c_proj.weight"], p[pre + "mlp.c_proj.bias"], prec)
        taps.append(xn)
    taps.pop(0)
    taps.append(x)
    return taps


def encode_text(p, ids, prec: Precision):
    """[..., W] token ids -> [..., C] sentence embeddings."""
    lead, W = ids.shape[:-1], ids.shape[-1]
    ids = ids.reshape(-1, W).long()
    x = torch.relu(_linear(p["bert.word_embd.weight"][ids], p["bert.fc1.weight"],
                           p["bert.fc1.bias"], prec))
    keep = ids != 0
    keep = keep | ~keep.any(-1, keepdim=True)
    x = x.masked_fill(~keep[..., None], MASK_VALUE)
    out = _linear(x.amax(-2), p["bert.fc2.weight"], p["bert.fc2.bias"], prec)
    return out.reshape(*lead, -1)


def _video_tokens(p, video, start, prec):
    T = video.shape[1]
    x = _ln(_linear(video.float(), p["video_pre_proj.weight"], None, prec), p, "ln_video_init")
    s = 0 if start is None else int(start)
    pos = _ln(p["temporal_pos_embed"][s:s + T], p, "ln_position_init")
    return x + pos[None]


def _l2n(x):
    return x / x.norm(dim=-1, keepdim=True)


def features(p, cfg, video, text, video_pad, text_pad, starts: Optional[Sequence[int]],
             prec: Precision):
    """(dual video [B,S,T,C], text [B,N,C], joint video [B,S,T,C], joint text
    [B,S,N,C]) before normalising, starts = (dual video, text, joint video)."""
    s = (None, None, None) if starts is None else tuple(starts)
    H = cfg["heads"]
    dual = _encoder(_video_tokens(p, video, s[0], prec), video_pad, p, "video_temporal_encoder",
                    cfg["num_encoder_layers"], H, prec)
    dual[-1] = _ln(dual[-1], p, "ln_video_post_enc")
    lang = _ln(_linear(text, p["text_pre_proj.weight"], None, prec), p, "ln_text_init")
    x = _video_tokens(p, video, s[2], prec)
    T = x.shape[1]
    joint = _encoder(torch.cat([x, lang], 1), torch.cat([video_pad, text_pad], 1), p,
                     "joint_temporal_encoder", cfg["num_joint_layers"], H, prec)
    joint[-1] = _ln(joint[-1], p, "ln_joint_post_enc")
    joint = torch.stack(joint, 1)
    return torch.stack(dual, 1), lang, joint[:, :, :T], joint[:, :, T:]


def head(p, x, prec):
    return _linear(x, p["binary_head.weight"], p["binary_head.bias"], prec)


def eval_sims(p, cfg, video, ids, prec: Precision) -> Dict[str, torch.Tensor]:
    """The zero-shot eval forward (tan_model.py:237-312) of [B, T, Cv] video
    and [B, N, W] ids, no padding: per-layer cosine sims [B, S, T, N] joint
    ('sim') and dual ('dual-sim'), the head's logits."""
    B, T = video.shape[:2]
    N = ids.shape[1]
    text = encode_text(p, ids, prec)
    no_pad_v = torch.zeros(B, T, dtype=torch.bool, device=video.device)
    no_pad_t = torch.zeros(B, N, dtype=torch.bool, device=video.device)
    dv, lang, jv, jt = features(p, cfg, video, text, no_pad_v, no_pad_t, None, prec)
    out = {"sim": torch.einsum("bstc,bskc->bstk", _l2n(jv), _l2n(jt)),
           "dual-sim": torch.einsum("bstc,bkc->bstk", _l2n(dv), _l2n(lang))}
    if cfg["use_alignability_head"]:
        out["alignability-dual"] = head(p, lang, prec)
        out["alignability-joint"] = head(p, jt, prec)
    return out


# ------------------------------------------------------------------- the loss


def _masked_mean(x, mask):
    m = mask.to(x.dtype)
    return (x * m).sum() / m.sum().clamp(min=1.0)


def _masked_quantile(x, mask, q):
    x = x.reshape(-1).float()
    mask = mask.reshape(-1)
    xs = torch.sort(torch.where(mask, x, torch.full_like(x, float("inf")))).values
    n_max = (mask.sum() - 1).clamp(min=0)
    pos = q * n_max.float()
    lo = pos.floor().long()
    hi = torch.minimum(lo + 1, n_max)
    frac = pos - lo.float()
    return xs.take(lo) * (1.0 - frac) + xs.take(hi) * frac


def _milnce(v_norm, t_norm, shared_text, pos_mask, col_valid, row_mask, col_mask, inv_temp,
            prec):
    """Multi-layer MIL-NCE of one branch (train/loss.py:55-110): the masked
    row and column logsumexps of the [S, B·T, B·N] logits."""
    B, S, T, C = v_norm.shape
    v = v_norm.transpose(0, 1).reshape(S, B * T, C)
    if shared_text:
        t = t_norm.reshape(1, -1, C).expand(S, -1, -1)
    else:
        t = t_norm.transpose(0, 1).reshape(S, -1, C)
    sim = inv_temp * (prec(v) @ prec(t).transpose(1, 2))
    pos = torch.where(pos_mask[None], sim, MASK_VALUE)
    neg = torch.where(col_valid[None, None], sim, MASK_VALUE)
    v_el = torch.logsumexp(neg, 2) - torch.logsumexp(pos, 2)
    t_el = torch.logsumexp(neg, 1) - torch.logsumexp(pos, 1)
    return (_masked_mean(v_el, row_mask[None].expand_as(v_el))
            + _masked_mean(t_el, col_mask[None].expand_as(t_el))) / 2.0


def train_loss(p, cfg, batch: Dict[str, torch.Tensor], starts, prec: Precision,
               alignability_layer: int = 2) -> torch.Tensor:
    """Stage 1's training loss of one batch (train/loss.py:55-373)."""
    video, ids = batch["video"].float(), batch["input_ids"]
    text_pad = batch["text_padding_mask"].bool()
    video_pad = batch["video_padding_mask"].bool()
    B, T = video.shape[:2]
    N = ids.shape[1]
    inv_temp = 1.0 / cfg["temperature"]
    dv, lang, jv, jt = features(p, cfg, video, encode_text(p, ids, prec), video_pad, text_pad,
                                starts, prec)
    dvn, tn, jvn, jtn = _l2n(dv), _l2n(lang), _l2n(jv), _l2n(jt)
    steps = torch.arange(T, dtype=torch.float32, device=video.device)
    tgt = ((batch["start"].float()[..., None] <= steps) & (steps < batch["end"].float()[..., None])
           & ~text_pad[..., None])  # [B, N, T]
    tgt_diag = tgt.transpose(1, 2)  # [B, T, N]
    eye = torch.eye(B, dtype=torch.bool, device=video.device)
    col_valid = (~text_pad).reshape(B * N)
    pos_mask = (tgt_diag[:, :, None, :] & eye[:, None, :, None]).reshape(B * T, B * N)
    pos_mask = pos_mask & col_valid[None]
    row_mask, col_mask = pos_mask.any(-1), pos_mask.any(-2)
    loss_dual = _milnce(dvn, tn, True, pos_mask, col_valid, row_mask, col_mask, inv_temp, prec)
    loss_joint = _milnce(jvn, jtn, False, pos_mask, col_valid, row_mask, col_mask, inv_temp, prec)
    loss = (loss_dual + loss_joint) / 2.0
    if not cfg["use_alignability_head"]:
        return loss
    with torch.no_grad():  # pseudo labels (loss.py:308-328)
        # per-text hardness: the last layer's same-video sims, their max over time
        diag_dual = torch.einsum("bstc,bnc->bstn", prec(dvn), prec(tn)) * inv_temp
        diag_joint = torch.einsum("bstc,bsnc->bstn", prec(jvn), prec(jtn)) * inv_temp
        max_dual = diag_dual[:, -1].amax(1).reshape(B * N)
        max_joint = diag_joint[:, -1].amax(1).reshape(B * N)
        col_mask = pos_mask.any(-2)
        med_dual = _masked_quantile(max_dual, col_valid, 0.5)
        med_joint = _masked_quantile(max_joint, col_valid, 0.5)
        labels = torch.full_like(max_dual, 2.0)
        labels = torch.where((max_dual > med_dual) & (max_joint > med_joint), 1.0, labels)
        labels = torch.where((max_dual < med_dual) & (max_joint < med_joint), 0.0, labels)
        if batch.get("abs_text_pos") is not None:
            center = batch["abs_text_pos"].float().mean(-1).reshape(B * N)
            labels = torch.where((center < 0.2) | (center > 0.8), 0.0, labels)
        sel = col_valid & col_mask & (labels != 2.0)
        pos_weight = 1.0 / _masked_mean(labels, sel).clamp(min=1e-6) - 1.0
    joint_a = head(p, jt, prec)
    layer = min(alignability_layer, joint_a.shape[1] - 1)
    logit = joint_a[:, layer, :, 0].reshape(B * N)
    per_el = -(pos_weight * labels * F.logsigmoid(logit) + (1.0 - labels) * F.logsigmoid(-logit))
    return loss + _masked_mean(per_el, sel)


def draw_pos_starts(generator: torch.Generator, T: int, N: int,
                    use_text_pos_enc: bool = False) -> Tuple[int, int, int]:
    """One training forward's random table starts, drawn in the forward's
    order from a CPU generator: the dual video start in [0, T // 2), the text
    start in [0, N // 2) (with the text positions), the joint video start."""
    limits = (T // 2, N // 2 if use_text_pos_enc else 0, T // 2)
    return tuple(int(torch.randint(0, n, (1,), generator=generator)) if n > 1 else 0
                 for n in limits)
