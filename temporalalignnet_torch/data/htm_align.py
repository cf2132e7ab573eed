"""HTM-Align eval dataset: full-video features + annotated sentences.

Counterpart of temporalalignnet_tpu/data/htm_align.py::HTMAlignDataset
(reference eval/eval_zeroshot_align.py:32-93):
- annotation json {vid: [[alignability, start, end, text], ...]}
  (htm_align/readme.md:17-20);
- full-length features as .npy or a torch .pth.tar tensor.

Yields the corpus items AlignmentEvaluator consumes:
{'vid', 'video': [vlen, C] f32, 'sentences': [{'aligned', 'start', 'end',
 'text', 'input_ids'}]}.

``HTMAlignTrainDataset`` (JAX data/htm_align.py:86-170; reference
data/loader_htm_align.py:38-164) samples train-style windows over the same
annotated videos, with per-sentence ``align`` labels.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, List

import numpy as np
import torch

from temporalalignnet_torch.data.padding import pad_tokens, pad_video_by_last


# feature files, in the order they are looked for: numpy arrays, then torch tensors
FEATURE_SUFFIXES = (".npy", ".mp4.npy", ".webm.npy", ".pth.tar", ".pth")


def _load_feature_any(feature_dir: str, vid: str) -> np.ndarray:
    for suffix in FEATURE_SUFFIXES:
        p = os.path.join(feature_dir, vid + suffix)
        if os.path.exists(p):
            if suffix.endswith(".npy"):
                return np.load(p)
            return torch.load(p, map_location="cpu", weights_only=True).numpy()
    raise FileNotFoundError(f"no feature for {vid} in {feature_dir}")


class HTMAlignDataset:
    def __init__(self, feature_dir: str, annotation_path: str, tokenizer=None,
                 max_words: int = 32):
        self.feature_dir = feature_dir
        with open(annotation_path) as f:
            self.anno: Dict[str, list] = json.load(f)
        self.vids: List[str] = sorted(self.anno.keys())
        self.tokenizer = tokenizer
        self.max_words = max_words

    def __len__(self) -> int:
        return len(self.vids)

    def _tokenize(self, text: str) -> np.ndarray:
        if self.tokenizer is None:
            return np.zeros(self.max_words, np.int32)
        ids = np.asarray(self.tokenizer(text)["input_ids"], np.int32).reshape(-1)
        return pad_tokens(ids, self.max_words)

    def __getitem__(self, index: int) -> Dict:
        vid = self.vids[index]
        video = _load_feature_any(self.feature_dir, vid).astype(np.float32)
        sentences = [
            {
                "aligned": int(aligned),
                "start": float(start),
                "end": float(end),
                "text": str(text),
                "input_ids": self._tokenize(str(text)),
            }
            for aligned, start, end, text in self.anno[vid]
        ]
        return {"vid": vid, "video": video, "sentences": sentences}

    def __iter__(self) -> Iterator[Dict]:
        for i in range(len(self)):
            yield self[i]


class HTMAlignTrainDataset(HTMAlignDataset):
    """Train-style windows over the annotated videos: HTMFeatureDataset's
    sample contract plus per-sentence ``align`` labels, for supervised probing
    of the alignability head.  A window starts at a random alignable
    sentence's start (or 0); alignable sentences enter by their annotated
    span cut to the window, the others over the whole window (they have no
    annotated span)."""

    def __init__(self, feature_dir, annotation_path, tokenizer=None, seq_len: int = 64,
                 max_sentences: int = 16, max_words: int = 32):
        super().__init__(feature_dir, annotation_path, tokenizer, max_words)
        self.seq_len = seq_len
        self.max_sentences = max_sentences

    def sample(self, index: int, rng: np.random.RandomState) -> Dict:
        item = self[index]
        video = item["video"]
        vlen = video.shape[0]
        T, N, W = self.seq_len, self.max_sentences, self.max_words

        anchors = [s for s in item["sentences"]
                   if s["aligned"] and s["start"] < max(vlen - T, 1)]
        start_ts = int(round(anchors[rng.randint(len(anchors))]["start"])) if anchors else 0
        start_ts = min(start_ts, max(vlen - T, 0))
        end_ts = start_ts + T
        cut, video_mask = pad_video_by_last(video[start_ts:end_ts].astype(np.float32), T)

        input_ids = np.zeros((N, W), np.int32)
        s_arr = np.zeros(N, np.float32)
        e_arr = np.zeros(N, np.float32)
        align = np.zeros(N, np.float32)
        text_pad = np.ones(N, bool)
        n = 0
        for s in item["sentences"]:
            if n == N:
                break
            st, en = s["start"], s["end"]
            if s["aligned"]:
                if en <= start_ts or st >= end_ts:
                    continue
                trim_s, trim_e = max(st - start_ts, 0.0), min(en - start_ts, float(T))
                if trim_e <= trim_s:
                    continue
            else:
                trim_s, trim_e = 0.0, float(T)
            input_ids[n] = s["input_ids"][:W]
            s_arr[n], e_arr[n] = trim_s, trim_e
            align[n] = s["aligned"]
            text_pad[n] = False
            n += 1
        if n == 0:  # no sentence in the window: one [UNK] over all of it
            input_ids[0] = self._tokenize("[UNK]")
            s_arr[0], e_arr[0] = 0, T
            text_pad[0] = False
            n = 1
        abs_pos = np.zeros((N, 2), np.float32)
        abs_pos[:n, 0] = (s_arr[:n] + start_ts) / max(vlen, 1)
        abs_pos[:n, 1] = (e_arr[:n] + start_ts) / max(vlen, 1)
        return {"video": cut, "video_padding_mask": video_mask, "input_ids": input_ids,
                "text_padding_mask": text_pad, "start": s_arr, "end": e_arr,
                "abs_text_pos": abs_pos, "align": align}
