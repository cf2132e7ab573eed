"""CLIP text tower and byte-BPE tokenizer, the CLIP baseline's text side
(counterpart of temporalalignnet_tpu/models/clip_text.py; reference
eval/eval_zeroshot_align.py:294-327 encodes the captions with
``clip.tokenize`` + ``clipmodel.encode_text``).

- ``CLIPTextEncoder``: token embedding plus learned positions, causal pre-LN
  blocks (``models/transformer.py``'s ResidualAttentionBlock with
  ``causal=True`` and the checkpoint's activation), ``ln_final``, pooling and
  a bias-free projection (``embed_dim`` 0: none).  It pools at
  ``argmax(input_ids)`` (OpenAI releases: EOT is the highest id) or, with an
  ``eos_token_id``, at its first occurrence (HF CLIPTextTransformer).  The
  causal attention is plain PyTorch on every device: the JAX package sends
  it to XLA, never to its Pallas kernel.  Weights in HF's key space go
  through ``checkpoint/clip_convert.py``.
- ``CLIPTokenizer``: lower-case, whitespace-clean, GPT-2 byte-to-unicode,
  ``</w>`` end-of-word merges, <|startoftext|> / <|endoftext|> wrapping, a
  fixed context with truncation that keeps EOT; from HF vocab.json +
  merges.txt or OpenAI's bpe_simple_vocab_16e6.txt.gz
  (``from_openai_bpe``).  Its pre-tokenizer is CLIP's pattern
  ``<|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|
  [^\\s\\p{L}\\p{N}]+``, scanned here over ``unicodedata`` categories (letters
  L*, numbers N*), which needs no ``regex`` package.  The cleaning is
  html-unescape and whitespace collapse: JAX adds ``ftfy``'s text fixing
  where ftfy is installed, and neither machine has it.
"""

from __future__ import annotations

import functools
import gzip
import html
import json
import re
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from temporalalignnet_torch.models.transformer import ResidualAttentionBlock


class CLIPTextEncoder(nn.Module):
    """[B, L] token ids -> [B, embed_dim]; defaults ViT-B/32's text stack."""

    def __init__(self, vocab_size: int = 49408, context_length: int = 77, width: int = 512,
                 layers: int = 12, heads: int = 8, embed_dim: int = 512,
                 hidden_act: str = "quick_gelu", eos_token_id: Optional[int] = None):
        super().__init__()
        self.eos_token_id = eos_token_id
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(torch.zeros(context_length, width))
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, act=hidden_act, causal=True)
            for _ in range(layers))
        self.ln_final = nn.LayerNorm(width, eps=1e-5)
        self.proj = nn.Linear(width, embed_dim, bias=False) if embed_dim else None

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``attention_mask`` is taken for the evaluators' interface and not
        used: padding attends but is never pooled (clip/model.py, and HF
        CLIPTextTransformer without a mask)."""
        L = input_ids.shape[-1]
        x = self.token_embedding(input_ids)
        x = x + self.positional_embedding[:L].to(x.dtype)
        for block in self.resblocks:
            x, _ = block(x)
        x = self.ln_final(x)
        at = input_ids if self.eos_token_id is None else (input_ids == self.eos_token_id).int()
        pooled = x[torch.arange(x.shape[0], device=x.device), at.argmax(dim=-1)]
        return self.proj(pooled) if self.proj is not None else pooled


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

SOT = "<|startoftext|>"
EOT = "<|endoftext|>"
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2/CLIP reversible byte -> printable-unicode table."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Tuple[str, ...]):
    return {(a, b) for a, b in zip(word, word[1:])}


def _basic_clean(text: str) -> str:
    return html.unescape(html.unescape(text)).strip()


def _kind(ch: str) -> str:
    """'L' letter, 'N' number, ' ' whitespace, '' anything else."""
    if ch.isspace():
        return " "
    return unicodedata.category(ch)[0] if unicodedata.category(ch)[0] in "LN" else ""


def pre_tokenize(text: str) -> List[str]:
    """CLIP's token pattern (IGNORECASE, on lower-cased text), left to right:
    the two specials, the contractions, a run of letters, one number, a run
    of what is neither whitespace, letter nor number."""
    out, i, n = [], 0, len(text)
    folded = text.replace("\u017f", "s")  # IGNORECASE: the long s matches 's'
    while i < n:
        hit = next((s for s in (SOT, EOT) + _CONTRACTIONS if folded.startswith(s, i)), None)
        if hit is not None:
            out.append(text[i:i + len(hit)])
            i += len(hit)
            continue
        kind = _kind(text[i])
        if kind == " ":
            i += 1
            continue
        j = i + 1
        if kind != "N":  # letters and the rest run on while the kind holds
            while j < n and _kind(text[j]) == kind:
                j += 1
        out.append(text[i:j])
        i = j
    return out


class CLIPTokenizer:
    """CLIP byte-BPE with the Word2VecTokenizer call contract.

    ``vocab``: token -> id dict or the path of an HF vocab.json; ``merges``:
    the ordered merge pairs or the path of an HF merges.txt (``#version``
    lines skipped).  OpenAI's file: :meth:`from_openai_bpe`."""

    def __init__(self, vocab: Union[str, Dict[str, int]],
                 merges: Union[str, Sequence[Tuple[str, str]]], context_length: int = 77):
        if isinstance(vocab, str):
            with open(vocab, encoding="utf-8") as f:
                vocab = json.load(f)
        if isinstance(merges, str):
            with open(merges, encoding="utf-8") as f:
                merges = [tuple(line.split()) for line in f.read().split("\n")
                          if line and not line.startswith("#version")]
        self.encoder: Dict[str, int] = dict(vocab)
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.context_length = context_length
        self.max_words = context_length  # the datasets pad to it
        self.vocab_size = len(self.encoder)
        self.sot_id = self.encoder[SOT]
        self.eot_id = self.encoder[EOT]
        self._cache: Dict[str, str] = {SOT: SOT, EOT: EOT}

    @classmethod
    def from_openai_bpe(cls, path: str, context_length: int = 77) -> "CLIPTokenizer":
        """OpenAI's bpe_simple_vocab_16e6.txt.gz: line 0 a banner, merges on
        lines 1 .. 49152-256-2; the vocab is the bytes, the bytes + </w>, the
        joined merges and the two specials (clip/simple_tokenizer.py)."""
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [tuple(m.split()) for m in lines[1: 49152 - 256 - 2 + 1] if m]
        chars = list(bytes_to_unicode().values())
        vocab_list = chars + [c + "</w>" for c in chars]
        vocab_list += ["".join(m) for m in merges] + [SOT, EOT]
        return cls({tok: i for i, tok in enumerate(vocab_list)}, merges, context_length)

    def bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        text = re.sub(r"\s+", " ", _basic_clean(text)).strip().lower()
        ids: List[int] = []
        for token in pre_tokenize(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids

    def _to_fixed(self, ids: List[int]) -> Tuple[List[int], int]:
        ids = [self.sot_id] + ids + [self.eot_id]
        if len(ids) > self.context_length:  # truncation keeps EOT (clip.tokenize)
            ids = ids[: self.context_length]
            ids[-1] = self.eot_id
        n = len(ids)
        return ids + [0] * (self.context_length - n), n

    def __call__(self, inputs: Union[str, Sequence[str]]) -> Dict[str, np.ndarray]:
        if isinstance(inputs, str):
            inputs = [inputs]
        rows, lens = zip(*(self._to_fixed(self.encode(s)) for s in inputs))
        ids = np.asarray(rows, np.int32)
        # pad id 0 is a real byte token ('!'): the mask comes from the lengths
        mask = (np.arange(self.context_length)[None, :] < np.asarray(lens)[:, None]).astype(
            np.int32)
        return {"input_ids": ids, "attention_mask": mask}
