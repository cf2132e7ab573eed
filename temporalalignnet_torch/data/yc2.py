"""YouCook2 datasets: the retrieval eval clips and the training-style loader
(counterpart of temporalalignnet_tpu/data/yc2.py).

The eval side mirrors ``YouCook2_Feature`` (reference
eval/eval_zeroshot_retrieval.py:29-153): one item per clip annotation, the
video its full features (``eval.retrieval``'s window sampling picks the
windows), the documented four-video drop list (:62-64) and the duration
check (:108).  Consecutive clips of one video share one feature array.

``YC2TrainDataset`` completes the reference's unfinished training loader
(data/loader_yc2.py:20) as the JAX package does: the same split semantics
(half-sampling of val, the drop list) and HTM-style fixed-shape windows.

Annotation format: youcookii_annotations_trainval.json
  {"database": {vid: {"annotations": [{"segment": [s, e], "sentence": str}],
                      "subset": "training"|"validation", "duration": float, ...}}}
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, List

import numpy as np

from temporalalignnet_torch.core.config import DataConfig
from temporalalignnet_torch.data.htm_align import FEATURE_SUFFIXES, _load_feature_any
from temporalalignnet_torch.data.padding import pad_tokens, pad_video_by_last

# problematic video lengths (eval_zeroshot_retrieval.py:62-64)
DROP_LIST = ("FtHLUsOntqI", "HQtOXHghaL0", "ffoRmenLSLs", "wKHC2gbRdA0")

_SUBSET = {"train": "training", "val": "validation", "test": "validation"}


def _has_feature(feature_dir: str, vid: str) -> bool:
    return any(os.path.exists(os.path.join(feature_dir, vid + s)) for s in FEATURE_SUFFIXES)


def _select_vids(anno: Dict, feature_dir: str, mode: str) -> List[str]:
    """The split's videos, sorted, without the drop list and those without a
    feature file."""
    subset = _SUBSET[mode]
    return sorted(v for v, entry in anno.items()
                  if entry.get("subset", "validation") == subset and v not in DROP_LIST
                  and _has_feature(feature_dir, v))


class YC2RetrievalDataset:
    """One item per clip annotation, for ``RetrievalEvaluator.evaluate()``."""

    def __init__(self, feature_dir: str, annotation_path: str, mode: str = "val",
                 tokenizer=None, max_words: int = 32):
        with open(annotation_path) as f:
            anno = json.load(f)["database"]
        self.feature_dir = feature_dir
        self.tokenizer = tokenizer
        self.max_words = max_words
        self.clips: List[Dict] = []
        for vid in _select_vids(anno, feature_dir, mode):
            duration = anno[vid].get("duration")
            for seg in anno[vid]["annotations"]:
                s, e = seg["segment"]
                self.clips.append({"vid": vid, "start": float(s), "end": float(e),
                                   "sentence": str(seg["sentence"]), "duration": duration})
        self._last = (None, None)  # (vid, features): clips come grouped by video

    def __len__(self) -> int:
        return len(self.clips)

    def _tokenize(self, text: str) -> np.ndarray:
        if self.tokenizer is None:
            return np.zeros(self.max_words, np.int32)
        ids = np.asarray(self.tokenizer(text)["input_ids"], np.int32).reshape(-1)
        return pad_tokens(ids, self.max_words)

    def _video(self, vid: str) -> np.ndarray:
        if self._last[0] != vid:
            self._last = (vid, _load_feature_any(self.feature_dir, vid).astype(np.float32))
        return self._last[1]

    def __getitem__(self, index: int) -> Dict:
        clip = self.clips[index]
        video = self._video(clip["vid"])
        # 1 fps features: |frames - seconds| <= 2 (eval_zeroshot_retrieval.py:108)
        if clip["duration"] is not None and abs(video.shape[0] - clip["duration"]) > 2:
            raise ValueError(f"{clip['vid']}: {video.shape[0]} feature rows for a "
                             f"{clip['duration']} s video")
        return {"vid": clip["vid"], "video": video, "start": clip["start"], "end": clip["end"],
                "text": clip["sentence"], "input_ids": self._tokenize(clip["sentence"])}

    def __iter__(self) -> Iterator[Dict]:
        for i in range(len(self)):
            yield self[i]


class YC2TrainDataset:
    """The completed training loader: each sample a fixed-shape window around
    one clip annotation, with ``HTMFeatureDataset.sample``'s tensor contract,
    so the same train step consumes both.  Val half-sampling as
    loader_yc2.py:63-66."""

    def __init__(self, feature_dir: str, annotation_path: str, cfg: DataConfig = DataConfig(),
                 mode: str = "train", tokenizer=None):
        with open(annotation_path) as f:
            anno = json.load(f)["database"]
        self.feature_dir = feature_dir
        self.cfg = cfg
        self.tokenizer = tokenizer
        vids = _select_vids(anno, feature_dir, mode)
        if mode == "val":
            vids = vids[::2]  # half-sample val (loader_yc2.py:63-66)
        self.anno = anno
        self.video_ids = vids

    def __len__(self) -> int:
        return len(self.video_ids)

    def _tokenize(self, text: str) -> np.ndarray:
        if self.tokenizer is None:
            return np.asarray([1], np.int32)
        ids = np.asarray(self.tokenizer(text)["input_ids"], np.int32).reshape(-1)
        return ids[: self.cfg.max_words]

    def sample(self, index: int, rng: np.random.RandomState) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        T, N, W = cfg.seq_len, cfg.max_sentences, cfg.max_words
        vid = self.video_ids[index]
        feature = _load_feature_any(self.feature_dir, vid).astype(np.float32)
        vlen = feature.shape[0]
        segs = self.anno[vid]["annotations"]

        # anchor the window at a random clip annotation
        seg = segs[rng.randint(len(segs))]
        start_ts = max(0, min(int(round(seg["segment"][0])), max(vlen - T, 0)))
        end_ts = start_ts + T

        sent_tok, sent_s, sent_e = [], [], []
        for sg in segs:
            s, e = round(sg["segment"][0]), round(sg["segment"][1])
            if e <= start_ts or s >= end_ts:
                continue
            trim_s, trim_e = max(s - start_ts, 0), min(e - start_ts, T)
            if trim_e <= trim_s:
                continue
            sent_tok.append(self._tokenize(str(sg["sentence"])))
            sent_s.append(trim_s)
            sent_e.append(trim_e)
            if len(sent_tok) == N:
                break
        if not sent_tok:
            sent_tok, sent_s, sent_e = [self._tokenize("[UNK]")], [0], [T]

        video, video_mask = pad_video_by_last(feature[start_ts:end_ts], T)
        n = len(sent_tok)
        input_ids = np.zeros((N, W), np.int32)
        for i, tok in enumerate(sent_tok):
            input_ids[i] = pad_tokens(tok, W)
        s_arr, e_arr = np.zeros(N, np.float32), np.zeros(N, np.float32)
        s_arr[:n], e_arr[:n] = sent_s, sent_e
        text_pad = np.ones(N, bool)
        text_pad[:n] = False
        abs_pos = np.zeros((N, 2), np.float32)
        abs_pos[:n, 0] = (np.asarray(sent_s, np.float32) + start_ts) / max(vlen, 1)
        abs_pos[:n, 1] = (np.asarray(sent_e, np.float32) + start_ts) / max(vlen, 1)
        return {"video": video, "video_padding_mask": video_mask, "input_ids": input_ids,
                "text_padding_mask": text_pad, "start": s_arr, "end": e_arr,
                "abs_text_pos": abs_pos}
