"""HowTo100M feature dataset: sentence-anchored fixed-shape training windows
(counterpart of temporalalignnet_tpu/data/htm.py; reference
data/loader_htm.py:62-258).

- the reference's sampling algorithm (random caption anchor, a T-second
  window, sentence clamping and rounding, the [UNK] fallback), cited per step;
  the same files and the same ``np.random.RandomState`` give bit-equal
  samples to the JAX package's;
- every sample is fixed-shape ([T, C] video padded by its last frame,
  [N_max, W] tokens, [N_max] start/end and masks), so a batch is a plain
  np.stack;
- the vlen table the reference reads from a pre-built CSV is derived from the
  feature files when absent (``build_vlen_table``).
The JAX package's per-video host cache (memmaps, parsed captions, token ids)
is not ported: its own tests show it changes no sample.

File-system contract (the reference's layout):
  feature_dir/{vid}.mp4.npy  (fallback {vid}.webm.npy, loader_htm.py:137-144)
  captions: {vid: {"text": [...], "start": [...], "end": [...]}} as .json
  (sentencified_htm_370k.json, loader_htm.py:81-84) or one video per line as
  .jsonl (JsonlCaptionStore)
"""

from __future__ import annotations

import csv
import json
import os
from typing import Dict, Iterable, List, Optional, Sequence, Set

import numpy as np

from temporalalignnet_torch.core.config import DataConfig
from temporalalignnet_torch.data.padding import pad_tokens, pad_video_by_last

UNK_TEXT = "[UNK]"


# --------------------------------------------------------------------- helpers


def load_feature(feature_dir: str, vid: str, mmap: bool = False) -> np.ndarray:
    """{vid}.mp4.npy with .webm.npy fallback (loader_htm.py:137-144).

    ``mmap=True`` opens the array lazily (``np.load(mmap_mode='r')``) so a
    window sample reads only its T rows instead of the whole file."""
    for suffix in (".mp4.npy", ".webm.npy", ".npy"):
        path = os.path.join(feature_dir, vid + suffix)
        if os.path.exists(path):
            return np.load(path, mmap_mode="r" if mmap else None)
    raise FileNotFoundError(f"no feature file for {vid} in {feature_dir}")


def build_vlen_table(feature_dir: str, vids: Iterable[str], cache_path: Optional[str] = None) -> Dict[str, int]:
    """Derive {vid: vlen} from feature-file lengths.

    Replaces the missing data/htm_vlen.csv blob (loader_htm.py:47-52); result is
    cached as a 2-column csv compatible with the reference's table.
    """
    if cache_path and os.path.exists(cache_path):
        return load_vlen_table(cache_path)
    table = {}
    for vid in vids:
        try:
            # mmap: the vlen is in the npy header — don't pull 370k-video
            # corpora through RAM just to count rows
            table[vid] = int(load_feature(feature_dir, vid, mmap=True).shape[0])
        except FileNotFoundError:
            continue
    if cache_path:
        with open(cache_path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["vid", "vlen"])
            for vid, vlen in sorted(table.items()):
                w.writerow([vid, vlen])
    return table


def load_vlen_table(path: str) -> Dict[str, int]:
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    start = 1 if rows and rows[0][:2] == ["vid", "vlen"] else 0
    return {r[0]: int(float(r[1])) for r in rows[start:] if len(r) >= 2}


class JsonlCaptionStore:
    """Offset-indexed caption store over a ``.jsonl`` file (one video/line).

    The reference parses the whole ``sentencified_htm_370k.json`` dict at
    startup (loader_htm.py:81-84) — at 370k-video scale that is a multi-GB
    Python-object tree on the host before step 0.  This store makes startup
    O(corpus bytes) in IO and O(videos) in RSS: one sequential scan indexes
    ``{vid: byte offset}`` WITHOUT parsing JSON (each line starts
    ``{"vid": "..."`` as the JAX package's tools/convert_captions.py writes
    it; a full-parse fallback covers hand-written lines), and ``store[vid]`` parses
    exactly one line on demand.

    Mapping-compatible with the monolithic dict: iteration yields vids,
    ``store[vid]`` returns the ``{"text","start","end"}`` record (or the
    per-video csv path string for the htm-fe layout, stored as
    ``{"vid":..., "path": "..."}``).
    """

    _VID = None  # compiled lazily (class-level, shared)

    def __init__(self, path: str):
        import re

        if JsonlCaptionStore._VID is None:
            JsonlCaptionStore._VID = re.compile(
                rb'^\s*\{\s*"vid"\s*:\s*"((?:[^"\\]|\\.)+)"'
            )
        pat = JsonlCaptionStore._VID
        self.path = path
        self._index: Dict[str, int] = {}
        off = 0
        with open(path, "rb") as f:
            for line in f:
                if line.strip():
                    m = pat.match(line)
                    if m is not None and b"\\" not in m.group(1):
                        vid = m.group(1).decode("utf-8")
                    else:  # escaped or reordered keys: parse the whole line
                        vid = json.loads(line)["vid"]
                    self._index[vid] = off
                off += len(line)

    def __len__(self) -> int:
        return len(self._index)

    def __iter__(self):
        return iter(self._index)

    def __contains__(self, vid) -> bool:
        return vid in self._index

    def keys(self):
        return self._index.keys()

    def items(self):
        for vid in self._index:
            yield vid, self[vid]

    def __getitem__(self, vid: str):
        # open per call: sample() runs on loader threads, and a shared handle
        # would race on seek; the OS page cache makes reopen ~free
        with open(self.path, "rb") as f:
            f.seek(self._index[vid])
            rec = json.loads(f.readline())
        rec.pop("vid", None)
        if set(rec) == {"path"}:  # htm-fe per-video csv layout
            return rec["path"]
        return rec


def load_captions(path_or_dict):
    if isinstance(path_or_dict, str):
        if path_or_dict.endswith(".jsonl"):
            return JsonlCaptionStore(path_or_dict)
        with open(path_or_dict) as f:
            return json.load(f)
    return path_or_dict


def load_holdout(path_or_set) -> Set[str]:
    """80-video HTM-Align holdout (data/htm_holdout_vid.txt, loader_htm.py:40-44)."""
    if path_or_set is None:
        return set()
    if isinstance(path_or_set, str):
        with open(path_or_set) as f:
            return {line.strip() for line in f if line.strip()}
    return set(path_or_set)


# --------------------------------------------------------------------- dataset


class HTMFeatureDataset:
    """Training/val dataset over pre-extracted features + sentencified ASR."""

    def __init__(
        self,
        feature_dir: str,
        captions,
        cfg: DataConfig = DataConfig(),
        mode: str = "train",
        tokenizer=None,
        holdout=None,
        vlen_table: Optional[Dict[str, int]] = None,
        min_vlen: int = 64,
        max_vlen: int = 1000,
    ):
        assert mode in ("train", "val", "test")
        self.feature_dir = feature_dir
        self.cfg = cfg
        self.mode = mode
        self.tokenizer = tokenizer
        self.captions = load_captions(captions)

        holdout_set = load_holdout(holdout)
        vids = [v for v in self.captions if v not in holdout_set]

        if vlen_table is None:
            cache = os.path.join(feature_dir, "htm_vlen.generated.csv")
            vlen_table = build_vlen_table(feature_dir, vids, cache_path=cache)
        self.vlen_table = vlen_table

        # vlen filter, same bounds as MIL-NCE (loader_htm.py:96-98)
        vids = [
            v
            for v in vids
            if v in vlen_table and min_vlen < vlen_table[v] < max_vlen
        ]
        vids = sorted(vids)

        # first min(5%, 1000) vids = val (loader_htm.py:101-106)
        num_val = min(int(len(vids) * 0.05), 1000)
        self.video_ids: List[str] = vids[num_val:] if mode == "train" else vids[:num_val]

    def __len__(self) -> int:
        return len(self.video_ids)

    # ------------------------------------------------------------- sampling

    def _tokenize(self, text: str) -> np.ndarray:
        if self.tokenizer is None:
            return np.asarray([1], np.int32)  # degenerate tokenizer for tests
        return np.asarray(self.tokenizer(text)["input_ids"], np.int32).reshape(-1)[
            : self.cfg.max_words
        ]

    def _captions_for(self, vid: str) -> Dict[str, list]:
        """Caption record; the htm-fe layout maps vid -> a per-video CSV path
        (loader_htm.py:81-84,196-199) while htm-370k/1200k inline the record."""
        caps = self.captions[vid]
        if isinstance(caps, str):
            with open(caps, newline="") as f:
                rows = list(csv.DictReader(f))
            caps = {
                "text": [r["text"] for r in rows],
                "start": [float(r["start"]) for r in rows],
                "end": [float(r["end"]) for r in rows],
            }
        return caps

    def sample(self, index: int, rng: np.random.RandomState) -> Dict[str, np.ndarray]:
        """One fixed-shape training window (reference __getitem__ + _get_text,
        loader_htm.py:131-258)."""
        cfg = self.cfg
        T, N, W = cfg.seq_len, cfg.max_sentences, cfg.max_words
        vid = self.video_ids[index]
        # memmapped: the window reads only its T rows, the same bytes a full load holds
        feature = load_feature(self.feature_dir, vid, mmap=True)
        vlen = feature.shape[0]

        caps = self._captions_for(vid)
        starts = np.asarray(caps["start"], np.float64)
        ends = np.asarray(caps["end"], np.float64)
        texts = caps["text"]
        keep = ends < vlen  # (loader_htm.py:181)
        order = np.nonzero(keep)[0]

        no_caption = order.size == 0
        if not no_caption:
            last_ts = ends[order][-1]
            anchor_pool = order[starts[order] < last_ts - T - 1]  # (:188-190)
            no_caption = anchor_pool.size == 0

        sent_text, sent_tok, sent_s, sent_e = [], [], [], []
        if not no_caption:
            anchors = order[starts[order] < last_ts - T]  # (:191-193)
            anchor = int(rng.choice(anchors))
            start_ts = int(round(starts[anchor]))
            end_ts = start_ts + T

            pos = list(order)
            for idx in pos[pos.index(anchor):]:
                s, e = round(starts[idx]), round(ends[idx])
                text = str(texts[idx]).replace("\n", " ").strip()
                words = text.split()
                if len(words) > 256:  # (:212-213)
                    text = " ".join(words[:256])
                if s > end_ts or e - s < 1:  # (:214-215)
                    break
                e = min(e, end_ts)
                token = self._tokenize(text)
                trim_s = max(s - start_ts, 0)
                trim_e = min(e - start_ts, T)
                if trim_e == trim_s:  # (:222-223)
                    break
                if token.sum() == 0:  # all stop words (:225-226)
                    break
                sent_text.append(text)
                sent_tok.append(token)
                sent_s.append(trim_s)
                sent_e.append(trim_e)
                if len(sent_text) == N:
                    break  # fixed-shape cap (divergence: reference keeps ragged)

        if not sent_text:  # unlucky sampling -> [UNK] window (:230-239)
            sent_text = [UNK_TEXT]
            sent_tok = [self._tokenize(UNK_TEXT)]
            sent_s, sent_e = [0], [T]
            if no_caption:
                start_ts, end_ts = 0, T

        cut = feature[start_ts:end_ts].astype(np.float32)
        video, video_mask = pad_video_by_last(cut, T)

        n = len(sent_text)
        input_ids = np.zeros((N, W), np.int32)
        for i, tok in enumerate(sent_tok):
            input_ids[i] = pad_tokens(tok, W)
        s_arr = np.zeros(N, np.float32)
        e_arr = np.zeros(N, np.float32)
        s_arr[:n] = sent_s
        e_arr[:n] = sent_e
        text_pad = np.ones(N, bool)
        text_pad[:n] = False

        abs_pos = np.zeros((N, 2), np.float32)
        abs_pos[:n, 0] = (np.asarray(sent_s, np.float32) + start_ts) / max(vlen, 1)
        abs_pos[:n, 1] = (np.asarray(sent_e, np.float32) + start_ts) / max(vlen, 1)

        out = {
            "video": video,
            "video_padding_mask": video_mask,
            "input_ids": input_ids,
            "text_padding_mask": text_pad,
            "start": s_arr,
            "end": e_arr,
            "abs_text_pos": abs_pos,
        }
        if self.mode in ("val", "test"):
            out["cut_start"] = np.float32(start_ts)
            out["cut_end"] = np.float32(end_ts)
        return out


def stack_samples(samples: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Fixed shapes -> a batch is a plain stack (no ragged collate needed)."""
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}
