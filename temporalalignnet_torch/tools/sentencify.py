"""Sentencify: regroup ASR caption fragments into timestamped sentences
(counterpart of temporalalignnet_tpu/tools/sentencify.py; ``Sentencify`` is
its copy and gives the same output).

Port of reference sentencify_text/filters/sentencify.py:20-157 with the
punctuation model injected instead of hard-wired:
- ``Sentencify(punctuator)`` where the punctuator provides ``tokenize(text)``,
  ``convert_tokens_to_ids(tokens)``, and ``predict(input_ids, attention_mask)``
  -> per-token label logits over the 15-label scheme (sentencify.py:29);
- ``HFPunctuator`` runs the felflare/bert-restore-punctuation checkpoint
  (BERT-base, a token classifier over the 15 labels) from a local directory
  on the port's own BERT (``models/bert.py``: ``BertForTokenClassification``
  and ``BertTokenizer``), without ``transformers``: ``config.json``,
  ``vocab.txt`` and ``model.safetensors`` or ``pytorch_model.bin``.  It runs
  in f32 with TF32 off, as the JAX package's HF model does; on the card its
  self-attention is the ``mha_fwd`` kernel's ``f32`` route, 12 launches per
  ``predict`` call of BERT-base (one per layer);
- algorithm parity: per-token timestamps linearly interpolated inside each
  caption (:54-63), 256-token chunks with [CLS]/[SEP] (:66-76), the -0.4
  no-punctuation bias (:82), sentence cuts on full stops (<20-token buffer) or
  partial stops (>=20) or >1 s silence gaps, never inside '##' continuations
  or after apostrophes (:91-122); skip-path for already-punctuated input
  (:124-151).
"""

from __future__ import annotations

import os
from typing import List, Optional, Protocol, Sequence, Tuple

import numpy as np
import torch

LABEL_LIST = ["OU", "OO", ".O", "!O", ",O", ".U", "!U", ",U", ":O", ";O",
              ":U", "'O", "-O", "?O", "?U"]
FULL_STOP = (2, 3, 5, 6, 13, 14)
PARTIAL_STOP = (2, 3, 4, 5, 6, 7, 8, 9, 10, 13, 14)


class Punctuator(Protocol):
    def tokenize(self, text: str) -> List[str]: ...

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]: ...

    def predict(self, input_ids: np.ndarray, attention_mask: np.ndarray) -> np.ndarray:
        """[B, L] ids -> [B, L, 15] logits."""
        ...


class HFPunctuator:
    """BertForTokenClassification loaded from a local model directory, on
    ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(self, model_dir: str, device: str = "cuda"):
        from temporalalignnet_torch.models.bert import (BertForTokenClassification,
                                                        load_bert_dir, num_labels)

        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("HFPunctuator on cuda: no CUDA device here (pass device='cpu' "
                               "for the CPU)")
        found = load_bert_dir(model_dir)
        if found.weights is None:
            raise ValueError(f"{model_dir}: no model.safetensors or pytorch_model.bin")
        model = BertForTokenClassification(
            found.config, num_labels(os.path.join(model_dir, "config.json")))
        model.bert.load_state_dict(found.weights, strict=True)
        model.classifier.load_state_dict(found.classifier, strict=True)
        self._model = model.to(device).eval()
        self._tok = found.tokenizer
        self._device = device

    def tokenize(self, text: str) -> List[str]:
        return self._tok.tokenize(text)

    def convert_tokens_to_ids(self, tokens):
        return [self._tok.vocab.get(t, self._tok.unk_id) for t in tokens]

    def predict(self, input_ids, attention_mask):
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False  # f32 as the HF model runs it
        try:
            with torch.no_grad():
                logits = self._model(
                    torch.from_numpy(input_ids).long().to(self._device),
                    torch.from_numpy(attention_mask).long().to(self._device))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        return logits.float().cpu().numpy()


class Sentencify:
    def __init__(self, punctuator: Punctuator, chunk_tokens: int = 256,
                 no_punct_bias: float = -0.4, silence_gap: float = 1.0,
                 hysteresis: int = 20):
        self.p = punctuator
        self.chunk_tokens = chunk_tokens
        self.no_punct_bias = no_punct_bias
        self.silence_gap = silence_gap
        self.hysteresis = hysteresis

    # ------------------------------------------------------------------ API

    def punctuate_and_cut(
        self,
        cap_list: Sequence[str],
        start_list: Optional[Sequence[float]] = None,
        end_list: Optional[Sequence[float]] = None,
    ) -> Tuple[List[str], List[float], List[float]]:
        if start_list is not None:
            assert len(cap_list) == len(start_list) == len(end_list)
        else:
            start_list = np.zeros(len(cap_list))
            end_list = np.zeros(len(cap_list))

        punctuated_ratio = float(
            np.mean([("," in c) or ("." in c) for c in cap_list])
        )
        if punctuated_ratio < 0.5:
            sents = self._punctuate_path(cap_list, start_list, end_list)
        else:
            sents = self._already_punctuated_path(cap_list, start_list, end_list)
        return (
            [s[0] for s in sents],
            [s[1] for s in sents],
            [s[2] for s in sents],
        )

    # alias for the reference's release skew (process_htm.py calls
    # ``punctuate`` though the class defines punctuate_and_cut — SURVEY §2.9#6)
    punctuate = punctuate_and_cut

    # ------------------------------------------------------------ internals

    def _token_stream(self, cap_list, start_list, end_list):
        token_timestamps = []
        for cap, start, end in zip(cap_list, start_list, end_list):
            cap = (
                str(cap).replace(",", " ").replace(".", " ")
                .replace("!", " ").replace("?", " ").lower()
            )
            tokens = self.p.tokenize(cap)
            stamp = np.linspace(start, end, len(tokens) + 1)
            token_timestamps.extend(
                (w, s, e) for w, s, e in zip(tokens, stamp[:-1], stamp[1:])
            )
        return token_timestamps

    def _predict_labels(self, all_tokens: List[str]) -> np.ndarray:
        num_tokens = len(all_tokens)
        ids = self.p.convert_tokens_to_ids(all_tokens)
        chunks = np.array_split(np.asarray(ids), num_tokens // self.chunk_tokens + 1)
        rows = [[101] + c.tolist() + [102] for c in chunks]
        max_len = max(len(r) for r in rows)
        input_ids = np.zeros((len(rows), max_len), np.int64)
        for i, r in enumerate(rows):
            input_ids[i, : len(r)] = r
        attention_mask = (input_ids != 0).astype(np.int64)
        logits = self.p.predict(input_ids, attention_mask)
        prob = _softmax(logits)
        prob[:, :, 0:2] += self.no_punct_bias  # bias against no-punct (:82)
        pred = prob.argmax(-1)
        out = []
        for i in range(len(rows)):
            n_tok = int(attention_mask[i].sum())
            out.append(pred[i, 1 : n_tok - 1])  # strip [CLS]/[SEP]
        preds = np.concatenate(out)
        assert preds.shape[0] == num_tokens
        return preds

    def _punctuate_path(self, cap_list, start_list, end_list):
        token_timestamps = self._token_stream(cap_list, start_list, end_list)
        if not token_timestamps:
            return []
        preds = self._predict_labels([t[0] for t in token_timestamps])
        num_tokens = len(token_timestamps)

        sents = []
        buffer_count = 0
        str_buffer = ""
        start_buffer = token_timestamps[0][1]
        end_buffer = token_timestamps[0][2]
        for idx, ((tok, _, tok_end), pred) in enumerate(zip(token_timestamps, preds)):
            if tok.startswith("##"):
                str_buffer += tok[2:]
            elif tok == "'" or str_buffer.endswith("'"):
                str_buffer += tok
            else:
                str_buffer += f" {tok}"
            end_buffer = tok_end
            buffer_count += 1

            nxt = token_timestamps[idx + 1] if idx + 1 < num_tokens else None
            if nxt is not None and nxt[0].startswith("##"):
                continue  # never cut inside a wordpiece
            if tok == "'":
                continue
            cut = (
                (buffer_count < self.hysteresis and pred in FULL_STOP)
                or (buffer_count >= self.hysteresis and pred in PARTIAL_STOP)
                or (nxt is not None and nxt[1] - tok_end > self.silence_gap)
            )
            if cut:
                sents.append((str_buffer.strip(), start_buffer, end_buffer))
                str_buffer = ""
                buffer_count = 0
                if nxt is not None:
                    start_buffer, end_buffer = nxt[1], nxt[2]
        if str_buffer:
            sents.append((str_buffer.strip(), start_buffer, end_buffer))
        return sents

    def _already_punctuated_path(self, cap_list, start_list, end_list):
        word_timestamps = []
        for cap, start, end in zip(cap_list, start_list, end_list):
            words = str(cap).split()
            stamp = np.linspace(start, end, len(words) + 1)
            word_timestamps.extend(
                (w, s, e) for w, s, e in zip(words, stamp[:-1], stamp[1:])
            )
        if not word_timestamps:
            return []
        sents = []
        str_buffer = ""
        start_buffer = word_timestamps[0][1]
        end_buffer = word_timestamps[0][2]
        for idx, (word, _, w_end) in enumerate(word_timestamps):
            str_buffer += f" {word}"
            end_buffer = w_end
            if any(ch in word for ch in (".", "!", "?")):
                sents.append((str_buffer.strip(), start_buffer, end_buffer))
                str_buffer = ""
                if idx + 1 < len(word_timestamps):
                    start_buffer = word_timestamps[idx + 1][1]
                    end_buffer = word_timestamps[idx + 1][2]
        if str_buffer:
            sents.append((str_buffer.strip(), start_buffer, end_buffer))
        return sents


def _softmax(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)
