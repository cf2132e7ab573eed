"""HTM-Align eval dataset: full-video features + annotated sentences.

Counterpart of temporalalignnet_tpu/data/htm_align.py::HTMAlignDataset
(reference eval/eval_zeroshot_align.py:32-93):
- annotation json {vid: [[alignability, start, end, text], ...]}
  (htm_align/readme.md:17-20);
- full-length features as .npy or a torch .pth.tar tensor.

Yields the corpus items AlignmentEvaluator consumes:
{'vid', 'video': [vlen, C] f32, 'sentences': [{'aligned', 'start', 'end',
 'text', 'input_ids'}]}.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, List

import numpy as np
import torch

from temporalalignnet_torch.data.padding import pad_tokens


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
