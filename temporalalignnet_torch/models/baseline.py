"""Raw-feature baseline: MIL-NCE features scored against the MIL-NCE text
tower with no TAN (counterpart of temporalalignnet_tpu/models/baseline.py,
word2vec mode; reference eval/eval_zeroshot_align.py:255-291, where MIL-NCE
overlap-seq reads R@1 0.342 / AUC 0.734 on HTM-Align).

It has the evaluators' interface (``encode_text``, ``text_visual_sims``,
``visual_feature``, ``textual_feature``, ``dtype``, ``cfg``), so
AlignmentEvaluator and RetrievalEvaluator run it unchanged:

    sim(t, n) = <fc(raw_video_feature_t), word2vec(sentence_n)>

with ``fc`` the MIL-NCE 1024 -> 512 projection (``use_visual_proj``) and the
dot product or, with ``cfg.sim == 'cos'``, the cosine.  Without the
projection the text tower outputs ``cfg.video_embed_dim`` features.  The
weights come from ``s3d_howto100m.pth`` through
``checkpoint.load_milnce_checkpoint``.  The projection and the similarity run
in f32 whatever the params' dtype (JAX ``_project``).

CLIP mode (eval_zeroshot_align.py:294-330): ``text_tower``, a zero-argument
factory of the text tower (``models/clip_text.py::CLIPTextEncoder`` with the
checkpoint's sizes), takes the word2vec tower's place at ``lang_model``;
with no projection and ``cfg.sim == 'cos'`` the captions meet the CLIP
features by cosine.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from temporalalignnet_torch.core.config import ModelConfig
from temporalalignnet_torch.models.tan import l2_normalize
from temporalalignnet_torch.models.word2vec import Word2VecEncoder

EMBED_DIM = 512  # the MIL-NCE joint space: fc 1024 -> 512, word2vec fc2 -> 512


class RawFeatureBaseline(nn.Module):
    def __init__(self, cfg: ModelConfig, vocab_size: int = 66251, use_visual_proj: bool = True,
                 text_tower: Optional[Callable[[], nn.Module]] = None):
        super().__init__()
        self.cfg = cfg
        out_dim = EMBED_DIM if use_visual_proj else cfg.video_embed_dim
        self.lang_model = (text_tower() if text_tower is not None
                           else Word2VecEncoder(vocab_size=vocab_size, output_dim=out_dim))
        self.visual_proj = nn.Linear(cfg.video_embed_dim, EMBED_DIM) if use_visual_proj else None

    @property
    def dtype(self) -> torch.dtype:
        return next(self.lang_model.parameters()).dtype

    def _project(self, video: torch.Tensor) -> torch.Tensor:
        v = video.float()
        if self.visual_proj is not None:
            v = F.linear(v, self.visual_proj.weight.float(), self.visual_proj.bias.float())
        return v

    def _norm(self, x: torch.Tensor) -> torch.Tensor:
        return l2_normalize(x) if self.cfg.sim == "cos" else x

    def encode_text(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """[..., W] tokens -> [..., C] pooled sentence embeddings."""
        lead, W = input_ids.shape[:-1], input_ids.shape[-1]
        out = self.lang_model(input_ids.reshape(-1, W), attention_mask.reshape(-1, W))
        return out.reshape(*lead, -1)

    def forward(self, video: torch.Tensor, input_ids: torch.Tensor,
                **_) -> Dict[str, torch.Tensor]:
        text = self.encode_text(input_ids, (input_ids != 0).int())
        sims = self.text_visual_sims(video, text)
        return {"logits_dual": sims["dual-sim"], "logits_joint": sims["sim"]}

    def text_visual_sims(
        self,
        video: torch.Tensor,  # [B, T, Cv] raw features
        text_embed: torch.Tensor,  # [B, N, C]
        video_padding_mask: Optional[torch.Tensor] = None,
        lang_padding_mask: Optional[torch.Tensor] = None,
        interpolate_from: Optional[int] = None,
        effective_len: Optional[torch.Tensor] = None,
        dual: bool = True,
    ) -> Dict[str, torch.Tensor]:
        """One f32 "layer" [B, 1, T, N], as both 'sim' and 'dual-sim' (the
        masks, the pos-enc options and ``dual`` change nothing here)."""
        with torch.autocast(video.device.type, enabled=False):
            sim = torch.einsum("btc,bkc->btk", self._norm(self._project(video)),
                               self._norm(text_embed.float()))[:, None]
        return {"sim": sim, "dual-sim": sim}

    def visual_feature(self, video: torch.Tensor, video_padding_mask=None,
                       interpolate_from=None, effective_len=None) -> torch.Tensor:
        """[B, 1, T, C]: the projected raw features, the retrieval's clip side."""
        return self._project(video)[:, None]

    def textual_feature(self, text_embed: torch.Tensor) -> torch.Tensor:
        return text_embed

    def load_milnce(self, loaded: Dict) -> List[str]:
        """The text tower and ``visual_proj`` from ``load_milnce_checkpoint``'s
        dict, each merged non-strictly (JAX ``neq_merge``): what the file
        lacks keeps its init.  Returns the merge report."""
        from temporalalignnet_torch.checkpoint import merge_into

        report: List[str] = []
        for name, part in (("lang_model", loaded["text"]), ("visual_proj", loaded["fc"])):
            if getattr(self, name) is not None and part:
                report += merge_into(getattr(self, name), part, name)
        return report
