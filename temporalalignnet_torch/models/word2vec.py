"""Word2vec (MIL-NCE) sentence encoder and tokenizer.

Counterpart of temporalalignnet_tpu/models/word2vec.py:
- tokenizer: regex word split ``[\\w']+``, lowercase, dict lookup with OOV -> 0,
  pad/truncate to max_words (reference model/word2vec_model.py:26-73; vocab
  token = index + 1, model/s3d_milnce/s3dg.py:200-204).
- encoder: frozen word embedding, fc1 + ReLU, masked max-pool over words
  (padding filled with -6e4; an all-padding sentence keeps every position),
  fc2 -> 512-d (reference model/word2vec_model.py:84-102).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn as nn

MASK_VALUE = -6.0e4

_WORD_RE = re.compile(r"[\w']+")


class Word2VecTokenizer:
    """``vocab`` is a list of words (token = index + 1, the MIL-NCE
    s3d_dict.npy convention) or a path to that .npy file."""

    def __init__(self, vocab: Union[str, Sequence[str]], max_words: int = 32):
        words = np.load(vocab) if isinstance(vocab, str) else vocab
        self.word_to_token = {str(w): i + 1 for i, w in enumerate(words)}
        self.vocab_size = len(self.word_to_token) + 1  # +1 for the pad/OOV token 0
        self.max_words = max_words

    def _words_to_ids(self, words: List[str]) -> List[int]:
        ids = [self.word_to_token.get(w, 0) for w in words[: self.max_words]]
        return ids + [0] * (self.max_words - len(ids))

    def __call__(self, inputs: Union[str, Sequence[str]]) -> Dict[str, np.ndarray]:
        if isinstance(inputs, str):
            inputs = [inputs]
        ids = np.asarray(
            [self._words_to_ids(_WORD_RE.findall(str(s).lower())) for s in inputs], np.int32
        )
        return {"input_ids": ids, "attention_mask": (ids != 0).astype(np.int32)}


class Word2VecEncoder(nn.Module):
    """embed -> fc1 -> ReLU -> masked max-pool -> fc2.

    MIL-NCE dims: vocab 66250+1 x 300 embedding, fc1 300->2048, fc2 2048->512.
    The word embedding is frozen (reference word2vec_model.py:85-86).  Returns
    the pooled sentence embedding [..., output_dim] (the reference's
    ``pooler_output``, the only output the TAN reads).
    """

    def __init__(self, vocab_size: int = 66251, word_dim: int = 300,
                 hidden_dim: int = 2048, output_dim: int = 512):
        super().__init__()
        self.word_embd = nn.Embedding(vocab_size, word_dim)
        self.word_embd.weight.requires_grad_(False)
        self.fc1 = nn.Linear(word_dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, output_dim)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = torch.relu(self.fc1(self.word_embd(input_ids)))
        if attention_mask is not None:
            keep = attention_mask.bool()
            # all-padding sentences (e.g. all stop words) keep every position
            keep = keep | ~keep.any(dim=-1, keepdim=True)
            x = x.masked_fill(~keep[..., None], MASK_VALUE)
        return self.fc2(x.amax(dim=-2))
