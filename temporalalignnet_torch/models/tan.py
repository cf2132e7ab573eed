"""TemporalAligner — the TAN model (counterpart of temporalalignnet_tpu/models/tan.py).

Reference model/tan_model.py:
- a dual video self-attention encoder and a joint [video || text] encoder,
  both returning per-layer taps (tan_model.py:43-46, 100-149);
- a 1024-slot learned or sine temporal pos-enc, with a random start offset in
  training (tan_model.py:57-66, 162-166) and linear interpolation for eval
  windows of another length (tan_model.py:157-160);
- per-layer cosine similarities and the optional alignability head
  (tan_model.py:69-72, 146-148).

The parameter names are the reference state_dict key space, so the port loads
a reference checkpoint or ``checkpoint.convert.state_dict_from_jax`` output
with ``strict=True``.  The reference's unused ``self.mlp`` Linear is not
instantiated.  Layout is batch-first [B, T, C].

Mixed precision: params stay in their own dtype (f32 in training), and the
compute dtype is whatever the caller runs the forward under
(``torch.autocast`` to bf16 on the card, see train/train_step.py).  Under
autocast LayerNorm returns f32, so the normalized features the training
forward hands to the loss are cast to the compute dtype explicitly, as the
JAX model hands them over in its compute dtype.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn

from temporalalignnet_torch.core.config import ModelConfig
from temporalalignnet_torch.models.posenc import linear_interpolate, sine_position_embedding
from temporalalignnet_torch.models.transformer import TemporalEncoder
from temporalalignnet_torch.parallel.distributed import all_gather


def l2_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """x / ||x|| — torch ``x / x.norm(dim=-1, keepdim=True)`` (no eps)."""
    return x / x.norm(dim=dim, keepdim=True)


def _compute_dtype(x: torch.Tensor, param_dtype: torch.dtype) -> torch.dtype:
    dev = x.device.type
    return torch.get_autocast_dtype(dev) if torch.is_autocast_enabled(dev) else param_dtype


def _cross_logits(video: torch.Tensor, text: torch.Tensor, eq: str) -> torch.Tensor:
    """f32 logits of features in the compute dtype: the products of bf16
    values are exact in f32, so this is the JAX einsum's
    preferred_element_type=f32 with autocast kept out of it."""
    with torch.autocast(video.device.type, enabled=False):
        return torch.einsum(eq, video.float(), text.float())


def _cos_sims(video: torch.Tensor, text: torch.Tensor, eq: str) -> torch.Tensor:
    """Cosine sims in f32 from features in the compute dtype (the JAX
    package's preferred_element_type=f32)."""
    return torch.einsum(eq, l2_normalize(video).float(), l2_normalize(text).float())


class TemporalAligner(nn.Module):
    def __init__(self, cfg: ModelConfig, text_embed_dim: Optional[int] = None):
        super().__init__()
        self.cfg = cfg
        width = cfg.width
        self.video_temporal_encoder = TemporalEncoder(
            width, cfg.num_encoder_layers, cfg.heads, cfg.mlp_ratio, cfg.remat)
        self.joint_temporal_encoder = TemporalEncoder(
            width, cfg.num_joint_layers, cfg.heads, cfg.mlp_ratio, cfg.remat)
        self.video_pre_proj = nn.Linear(cfg.video_embed_dim, width, bias=False)
        self.text_pre_proj = nn.Linear(text_embed_dim or cfg.text_embed_dim, width, bias=False)
        for name in ("ln_text_init", "ln_video_init", "ln_position_init",
                     "ln_video_post_enc", "ln_joint_post_enc"):
            setattr(self, name, nn.LayerNorm(width, eps=1e-5))
        if cfg.pos_enc == "learned":
            self.temporal_pos_embed = nn.Parameter(torch.empty(cfg.num_pos_embeds, width))
        elif cfg.pos_enc == "sine":
            self.register_buffer(
                "temporal_pos_embed",
                sine_position_embedding(width, cfg.num_pos_embeds), persistent=False)
        else:
            raise ValueError(cfg.pos_enc)
        self.text_temporal_pos_embed = nn.Parameter(torch.empty(cfg.num_pos_embeds, width))
        if cfg.use_alignability_head:
            self.binary_head = nn.Linear(width, 1)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "TemporalAligner":
        """CLIP-style init (tan_model.py:76-97), all draws from ``generator``."""
        width = self.cfg.width
        proj_std = (width ** -0.5) * ((2 * self.cfg.num_joint_layers) ** -0.5)
        attn_std = width ** -0.5
        fc_std = (2 * width) ** -0.5
        normal = lambda p, std: p.copy_(torch.randn(p.shape, generator=generator) * std)
        for name, p in self.named_parameters():
            if name.endswith("in_proj_weight"):
                normal(p, attn_std)
            elif name.endswith(("out_proj.weight", "c_proj.weight")):
                normal(p, proj_std)
            elif name.endswith("c_fc.weight"):
                normal(p, fc_std)
            elif "ln_" in name:
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            elif name.endswith("bias"):
                p.zero_()
            elif name.endswith("word_embd.weight"):
                normal(p, 1.0)
            elif name.startswith("bert.fc"):
                normal(p, p.shape[1] ** -0.5)  # lecun normal
            else:  # pre-projections, pos-enc tables, binary head
                normal(p, 0.01)
        return self

    @property
    def dtype(self) -> torch.dtype:
        return self.video_pre_proj.weight.dtype

    # ------------------------------------------------------------------ helpers

    def draw_pos_starts(self, T: int, N: int,
                        generator: Optional[torch.Generator]) -> Optional[Tuple[int, int, int]]:
        """The random positional-table start offsets of one training forward
        (tan_model.py:162-166), drawn on the host from ``generator`` in the
        forward's order: the dual branch's video start in [0, T // 2), the
        text start in [0, N // 2) (with the text pos-enc), the joint branch's
        video start in [0, T // 2); 0 without a draw where the range holds
        one value.  Three ints, or None where no start is random
        (``random_pos_start`` off)."""
        limits = self._pos_limits(T, N)
        if limits is None:
            return None
        if generator is None:
            raise ValueError("a random pos start needs a torch.Generator")
        return tuple(int(torch.randint(0, n, (1,), generator=generator)) if n > 1 else 0
                     for n in limits)

    def _pos_limits(self, T: int, N: int) -> Optional[Tuple[int, int, int]]:
        limits = (T // 2, N // 2 if self.cfg.use_text_pos_enc else 0, T // 2)
        if not self.cfg.random_pos_start or max(limits) <= 1:
            return None
        return limits

    @staticmethod
    def _pos_rows(table: torch.Tensor, n: int, start) -> torch.Tensor:
        """Rows start ... start + n - 1 of ``table``: ``start`` an int (a
        slice), a 0-d int tensor on the table's device (a gather: a CUDA
        graph replays it with each step's start), or None (the first n)."""
        if start is None:
            return table[:n]
        if isinstance(start, int):
            return table[start:start + n]
        return table.index_select(0, start + torch.arange(n, device=table.device))

    def _video_pos_embed(self, T, interpolate_from, effective_len, start):
        table = self.temporal_pos_embed.to(self.dtype)
        if interpolate_from:
            return linear_interpolate(table[:interpolate_from], T, effective_len)
        return self._pos_rows(table, T, start)

    def _video_tokens(self, video_embed, interpolate_from, effective_len, start):
        x = self.ln_video_init(self.video_pre_proj(video_embed.to(self.dtype)))
        pos = self._video_pos_embed(x.shape[1], interpolate_from, effective_len, start)
        pos = self.ln_position_init(pos)
        return x + (pos if pos.dim() == 3 else pos[None])

    # ------------------------------------------------------------- feature paths

    def get_visual_feature(
        self,
        video_embed: torch.Tensor,  # [B, T, Cv]
        video_padding_mask: Optional[torch.Tensor] = None,  # [B, T] True = pad
        interpolate_from: Optional[int] = None,
        deterministic: bool = True,
        effective_len: Optional[torch.Tensor] = None,  # scalar or [B]
        pos_start=None,  # the random table start (``_pos_rows``)
    ) -> torch.Tensor:
        """Dual-branch video features, all layers: [B, S, T, C] (tan_model.py:152-179)."""
        x = self._video_tokens(video_embed, interpolate_from, effective_len,
                               None if deterministic else pos_start)
        if self.cfg.num_encoder_layers == 0:
            return x[:, None]  # raw-feature fallback (tan_model.py:177-179)
        taps = self.video_temporal_encoder(x, video_padding_mask)
        taps[-1] = self.ln_video_post_enc(taps[-1])
        return torch.stack(taps, dim=1)

    def get_textual_feature(self, lang_embed: torch.Tensor) -> torch.Tensor:
        """proj + LN (tan_model.py:231-234). [..., Ct] -> [..., C]."""
        return self.ln_text_init(self.text_pre_proj(lang_embed.to(self.dtype)))

    def get_textual_feature_with_time(
        self,
        lang_embed: torch.Tensor,  # [B, N, Ct]
        interpolate_from: Optional[int] = None,
        deterministic: bool = True,
        pos_start=None,
    ) -> torch.Tensor:
        """Text features + text temporal pos-enc (tan_model.py:212-228)."""
        x = self.get_textual_feature(lang_embed)
        N = x.shape[1]
        table = self.text_temporal_pos_embed.to(self.dtype)
        if interpolate_from:
            pos = linear_interpolate(table[:interpolate_from], N)
        else:
            pos = self._pos_rows(table, N, None if deterministic else pos_start)
        return x + self.ln_position_init(pos)[None]

    def get_joint_feature(
        self,
        video_embed: torch.Tensor,  # [B, T, Cv]
        video_padding_mask: Optional[torch.Tensor],
        lang_embed_with_time: torch.Tensor,  # [B, N, C], already projected
        lang_padding_mask: Optional[torch.Tensor],
        interpolate_from: Optional[int] = None,
        deterministic: bool = True,
        effective_len: Optional[torch.Tensor] = None,
        pos_start=None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Joint encoder over [video || text]; returns ([B,S,T,C], [B,S,N,C])
        (tan_model.py:182-209)."""
        x = self._video_tokens(video_embed, interpolate_from, effective_len,
                               None if deterministic else pos_start)
        B, T, _ = x.shape
        N = lang_embed_with_time.shape[1]
        joint = torch.cat([x, lang_embed_with_time], dim=1)
        if video_padding_mask is None:
            video_padding_mask = torch.zeros(B, T, dtype=torch.bool, device=x.device)
        if lang_padding_mask is None:
            lang_padding_mask = torch.zeros(B, N, dtype=torch.bool, device=x.device)
        joint_mask = torch.cat([video_padding_mask, lang_padding_mask], dim=1)
        taps = self.joint_temporal_encoder(joint, joint_mask)
        taps[-1] = self.ln_joint_post_enc(taps[-1])
        out = torch.stack(taps, dim=1)  # [B, S, T+N, C]
        return out[:, :, :T], out[:, :, T:]

    # ----------------------------------------------------------------- forward

    def forward(
        self,
        video_embed: torch.Tensor,  # [B, T, Cv]
        lang_embed: torch.Tensor,  # [B, N, Ct]
        video_padding_mask: Optional[torch.Tensor] = None,  # [B, T] True = pad
        lang_padding_mask: Optional[torch.Tensor] = None,  # [B, N] True = pad
        interpolate_from: Optional[int] = None,
        deterministic: bool = False,
        pos_starts: Union[Sequence[int], torch.Tensor, None] = None,
        group=None,
    ) -> Dict[str, torch.Tensor]:
        """Training forward (tan_model.py:100-149).  Without ``fused_milnce``:
        the cross-batch per-layer logits 'logits_dual' and 'logits_joint'
        [B, S, T, B, N] f32 (under a process group ``group``: this rank's B
        videos against the texts of every rank's videos, [B, S, T, B_all, N],
        through the differentiable all-gather), plus the dual features with
        ``return_dual_feature``; with it: the four per-layer normalized
        features for ops/milnce.py.  With the head, also the alignability
        logits 'dual_logits_alignability' [B, N, 1] and
        'joint_logits_alignability' [B, S, N, 1].

        Unless ``deterministic``, the random pos starts come as ``pos_starts``:
        ``draw_pos_starts``'s three ints, or those as a [3] int tensor on the
        device (what a CUDA graph replays)."""
        cfg = self.cfg
        if (pos_starts is None and not deterministic
                and self._pos_limits(video_embed.shape[1], lang_embed.shape[1]) is not None):
            raise ValueError("a training forward with random pos starts needs pos_starts "
                             "(draw_pos_starts)")
        starts = [None] * 3 if pos_starts is None else list(pos_starts)
        video_out = self.get_visual_feature(
            video_embed, video_padding_mask, interpolate_from, deterministic,
            pos_start=starts[0])
        lang_raw = self.get_textual_feature(lang_embed)
        fdt = _compute_dtype(video_out, self.dtype)
        video_norm = l2_normalize(video_out).to(fdt)
        text_norm = l2_normalize(lang_raw).to(fdt)
        lang_with_time = (
            self.get_textual_feature_with_time(lang_embed, interpolate_from, deterministic,
                                               starts[1])
            if cfg.use_text_pos_enc else lang_raw
        )
        joint_video, joint_text = self.get_joint_feature(
            video_embed, video_padding_mask, lang_with_time, lang_padding_mask,
            interpolate_from, deterministic, pos_start=starts[2])
        joint_video_norm = l2_normalize(joint_video).to(fdt)
        joint_text_norm = l2_normalize(joint_text).to(fdt)

        if cfg.fused_milnce:
            out = {
                "dual_feature_video": video_norm,
                "dual_feature_text": text_norm,
                "joint_feature_video": joint_video_norm,
                "joint_feature_text": joint_text_norm,
            }
        else:
            out = {
                "logits_dual": _cross_logits(video_norm, all_gather(text_norm, 0, group),
                                             "astc,bkc->astbk"),
                "logits_joint": _cross_logits(joint_video_norm,
                                              all_gather(joint_text_norm, 0, group),
                                              "astc,bskc->astbk"),
            }
            if cfg.return_dual_feature:
                out["dual_feature_video"] = video_norm
                out["dual_feature_text"] = text_norm
        if cfg.use_alignability_head:
            out["dual_logits_alignability"] = self.binary_head(lang_raw)
            out["joint_logits_alignability"] = self.binary_head(joint_text)
        return out

    # -------------------------------------------------------------- eval methods

    def get_text_visual_sims(
        self,
        video_embed: torch.Tensor,  # [B, T, Cv]
        lang_embed: torch.Tensor,  # [B, N, Ct]
        video_padding_mask: Optional[torch.Tensor] = None,
        lang_padding_mask: Optional[torch.Tensor] = None,
        interpolate_from: Optional[int] = None,
        effective_len: Optional[torch.Tensor] = None,
        dual: bool = True,
    ) -> Dict[str, torch.Tensor]:
        """Joint sim, dual sim and alignability logits in one pass.

        Returns per-layer f32 sims [B, S, T, N] ('sim' joint, 'dual-sim') and,
        with the head, 'alignability-dual' [B, N, 1] and
        'alignability-joint' [B, S, N, 1] (tan_model.py:237-312).  With
        ``dual=False`` only the joint encoder runs and only 'sim' (and
        'alignability-joint') come back: the joint encoder reads the raw
        features, not the dual encoder's output.
        """
        lang_raw = self.get_textual_feature(lang_embed)
        lang_with_time = (
            self.get_textual_feature_with_time(lang_embed)
            if self.cfg.use_text_pos_enc else lang_raw
        )
        joint_video, joint_text = self.get_joint_feature(
            video_embed, video_padding_mask, lang_with_time, lang_padding_mask,
            interpolate_from, effective_len=effective_len)
        out = {"sim": _cos_sims(joint_video, joint_text, "bstc,bskc->bstk")}
        if dual:
            video_out = self.get_visual_feature(
                video_embed, video_padding_mask, interpolate_from, effective_len=effective_len)
            out["dual-sim"] = _cos_sims(video_out, lang_raw, "bstc,bkc->bstk")
        if self.cfg.use_alignability_head:
            if dual:
                out["alignability-dual"] = self.binary_head(lang_raw)
            out["alignability-joint"] = self.binary_head(joint_text)
        return out
