"""TANWithText — TemporalAligner + the word2vec language model as one module.

Counterpart of temporalalignnet_tpu/models/net.py (word2vec only; the BERT
tower comes later).  The language model sits at ``bert`` — the attribute name
the reference gives it even for word2vec (tan_model.py:38-40) — so the
module's state_dict is the reference key space.  Text is fixed-shape
[..., N, W] tokens, encoded on the flattened [B*N, W] batch.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from temporalalignnet_torch.core.config import ModelConfig
from temporalalignnet_torch.models.tan import TemporalAligner
from temporalalignnet_torch.models.word2vec import Word2VecEncoder


class TANWithText(TemporalAligner):
    def __init__(self, cfg: ModelConfig, vocab_size: int = 66251):
        super().__init__(cfg)
        if cfg.language_model != "word2vec":
            raise NotImplementedError(f"language_model={cfg.language_model!r}")
        self.bert = Word2VecEncoder(vocab_size=vocab_size, output_dim=cfg.text_embed_dim)

    def encode_text(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """[..., W] tokens -> [..., C] pooled sentence embeddings."""
        lead, W = input_ids.shape[:-1], input_ids.shape[-1]
        out = self.bert(input_ids.reshape(-1, W), attention_mask.reshape(-1, W))
        return out.reshape(*lead, -1)

    def forward(
        self,
        video: torch.Tensor,  # [B, T, Cv]
        input_ids: torch.Tensor,  # [B, N, W]
        video_padding_mask: Optional[torch.Tensor] = None,
        lang_padding_mask: Optional[torch.Tensor] = None,
        deterministic: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        """Training forward (models/net.py:102-118 of the JAX package)."""
        text_embed = self.encode_text(input_ids, (input_ids != 0).int())
        return super().forward(video, text_embed, video_padding_mask, lang_padding_mask,
                               deterministic=deterministic, generator=generator)

    def text_visual_sims(
        self,
        video: torch.Tensor,  # [B, T, Cv]
        text_embed: torch.Tensor,  # pre-encoded [B, N, C]
        video_padding_mask: Optional[torch.Tensor] = None,
        lang_padding_mask: Optional[torch.Tensor] = None,
        interpolate_from: Optional[int] = None,
        effective_len: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        return self.get_text_visual_sims(
            video, text_embed, video_padding_mask, lang_padding_mask,
            interpolate_from, effective_len=effective_len,
        )
