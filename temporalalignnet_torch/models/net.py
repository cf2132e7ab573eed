"""TANWithText — TemporalAligner + its language model as one module.

Counterpart of temporalalignnet_tpu/models/net.py.  The language model, the
word2vec tower or (``language_model='bert'``) ``models/bert.py``'s
BertEncoder, sits at ``bert`` — the attribute name the reference gives it
(tan_model.py:37-40) — so the module's state_dict is the reference key
space (``bert.embeddings.*`` / ``bert.encoder.*`` / ``bert.pooler.*`` for
BERT).  Text is fixed-shape [..., N, W] tokens, encoded on the flattened
[B*N, W] batch; BERT's sentence embedding is its ``pooler_output`` and its
width (768 for bert-base-uncased) is the aligner's text input.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from temporalalignnet_torch.core.config import ModelConfig
from temporalalignnet_torch.models.bert import BertConfig, BertEncoder
from temporalalignnet_torch.models.tan import TemporalAligner
from temporalalignnet_torch.models.word2vec import Word2VecEncoder


class TANWithText(TemporalAligner):
    def __init__(self, cfg: ModelConfig, vocab_size: int = 66251,
                 bert_config: Optional[BertConfig] = None):
        if cfg.language_model == "bert":
            bert_config = bert_config or BertConfig()
            super().__init__(cfg, text_embed_dim=bert_config.hidden_size)
            self.bert = BertEncoder(bert_config)
        elif cfg.language_model == "word2vec":
            super().__init__(cfg)
            self.bert = Word2VecEncoder(vocab_size=vocab_size, output_dim=cfg.text_embed_dim)
        else:
            raise NotImplementedError(f"language_model={cfg.language_model!r}")

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "TANWithText":
        """The aligner's CLIP-style init; BERT then takes HF's own."""
        super().init_weights(generator)
        if isinstance(self.bert, BertEncoder):
            self.bert.init_weights(generator)
        return self

    def encode_text(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """[..., W] tokens -> [..., C] pooled sentence embeddings."""
        lead, W = input_ids.shape[:-1], input_ids.shape[-1]
        out = self.bert(input_ids.reshape(-1, W), attention_mask.reshape(-1, W))
        if isinstance(out, dict):  # BERT: its pooler (net.py:90-95 of the JAX package)
            out = out["pooler_output"]
        return out.reshape(*lead, -1)

    def forward(
        self,
        video: torch.Tensor,  # [B, T, Cv]
        input_ids: torch.Tensor,  # [B, N, W]
        video_padding_mask: Optional[torch.Tensor] = None,
        lang_padding_mask: Optional[torch.Tensor] = None,
        deterministic: bool = False,
        pos_starts=None,
        group=None,
    ) -> Dict[str, torch.Tensor]:
        """Training forward (models/net.py:102-118 of the JAX package); the
        random pos starts and the process group as ``TemporalAligner.forward``
        takes them."""
        text_embed = self.encode_text(input_ids, (input_ids != 0).int())
        return super().forward(video, text_embed, video_padding_mask, lang_padding_mask,
                               deterministic=deterministic, pos_starts=pos_starts, group=group)

    def text_visual_sims(
        self,
        video: torch.Tensor,  # [B, T, Cv]
        text_embed: torch.Tensor,  # pre-encoded [B, N, C]
        video_padding_mask: Optional[torch.Tensor] = None,
        lang_padding_mask: Optional[torch.Tensor] = None,
        interpolate_from: Optional[int] = None,
        effective_len: Optional[torch.Tensor] = None,
        dual: bool = True,
    ) -> Dict[str, torch.Tensor]:
        """``get_text_visual_sims``; ``dual=False`` runs the joint encoder only."""
        return self.get_text_visual_sims(
            video, text_embed, video_padding_mask, lang_padding_mask,
            interpolate_from, effective_len=effective_len, dual=dual,
        )

    def visual_feature(
        self,
        video: torch.Tensor,  # [B, T, Cv]
        video_padding_mask: Optional[torch.Tensor] = None,
        interpolate_from: Optional[int] = None,
        effective_len: Optional[torch.Tensor] = None,  # scalar or [B]
    ) -> torch.Tensor:
        """Deterministic dual-encoder features, all layers [B, S, T, C]
        (the retrieval evaluator's entry point)."""
        return self.get_visual_feature(video, video_padding_mask, interpolate_from,
                                       deterministic=True, effective_len=effective_len)

    def textual_feature(self, text_embed: torch.Tensor) -> torch.Tensor:
        """Pooled sentence embeddings [..., Ct] -> projected features [..., C]."""
        return self.get_textual_feature(text_embed)
