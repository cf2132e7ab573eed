"""HTM-AA raw-video clip dataset for the end-to-end S3D fine-tune
(counterpart of temporalalignnet_tpu/data/clips.py; reference
``HTM_ClipLoader``, end2end/video_loader.py:39-175):

- HTM-AA csv rows (vid, text, timestamp): the auto-aligned pairs a TAN
  produced (htm_aa_v1.csv; ``tools/generate_htm_aa.py`` writes them);
- per video, ``num_sample_per_video`` text-timestamp pairs, each decoded to
  ``num_frames`` frames at ``fps`` around the timestamp with a random
  (train) or center (eval) square crop of ``crop_size``²;
- a failed decode gives grey frames (0.5), the reference's own behaviour
  (video_loader.py:164-166);
- vlen filter 64 < vlen < 2000 (video_loader.py:71-73).

Samples are channel-last [n, T, H, W, 3] float32 in [0, 1] and [n, W] token
ids.  The rng is drawn in JAX's order (``rng.choice`` of the rows, then each
decode's crop draws), so the same seed gives the same, bit-equal, sample.
``synthetic_decode`` (pseudo-frames that depend only on the last two path
components and the timestamp) stands in for ffmpeg where there is none.
"""

from __future__ import annotations

import csv
import os
import subprocess
import zlib
from typing import Callable, Dict, List, Optional

import numpy as np

from temporalalignnet_torch.data.padding import pad_tokens

Decoder = Callable[..., np.ndarray]


def ffmpeg_decode(
    video_path: str,
    center_ts: float,
    num_frames: int,
    fps: int,
    crop_size: int,
    rng: Optional[np.random.RandomState] = None,
    center_crop_only: bool = False,
) -> np.ndarray:
    """Decode frames around ``center_ts`` via an ffmpeg subprocess
    (video_loader.py:139-174) -> [T, crop, crop, 3] float32 in [0, 1]."""
    duration = num_frames / fps
    start = max(center_ts - duration / 2.0, 0.0)
    # decode at a slightly larger short side, then crop
    decode_size = int(crop_size * 1.15)
    cmd = [
        "ffmpeg", "-ss", f"{start:.3f}", "-t", f"{duration + 0.5:.3f}",
        "-i", video_path, "-vf",
        f"fps={fps},scale={decode_size}:{decode_size}:force_original_aspect_ratio=increase",
        "-f", "rawvideo", "-pix_fmt", "rgb24", "-v", "error", "pipe:1",
    ]
    out = subprocess.run(cmd, capture_output=True, timeout=60).stdout
    # ffmpeg 'increase' scaling yields unknown exact dims; re-run probe-free by
    # assuming square decode; if the buffer does not factor, fail to grey.
    n_px = decode_size * decode_size * 3
    n = len(out) // n_px
    if n == 0:
        raise RuntimeError(f"ffmpeg produced no frames for {video_path}")
    frames = np.frombuffer(out[: n * n_px], np.uint8).reshape(
        n, decode_size, decode_size, 3
    )
    if n < num_frames:
        frames = np.concatenate(
            [frames, np.repeat(frames[-1:], num_frames - n, axis=0)], axis=0
        )
    frames = frames[:num_frames]
    h = w = decode_size
    if center_crop_only or rng is None:
        y = (h - crop_size) // 2
        x = (w - crop_size) // 2
    else:
        y = rng.randint(0, h - crop_size + 1)
        x = rng.randint(0, w - crop_size + 1)
    crop = frames[:, y : y + crop_size, x : x + crop_size]
    return crop.astype(np.float32) / 255.0


def synthetic_decode(
    video_path: str,
    center_ts: float,
    num_frames: int,
    fps: int,
    crop_size: int,
    rng: Optional[np.random.RandomState] = None,
    center_crop_only: bool = False,
) -> np.ndarray:
    """Deterministic pseudo-video frames from (video name, timestamp), as the
    JAX package makes them: a drop-in for ``ffmpeg_decode`` where there is no
    ffmpeg binary, and in tests.  The output is a function of the clip's
    identity alone, not of the caller's rng, and of the last TWO path
    components (dir1/a.mp4 and dir2/a.mp4 differ; the video root can move)."""
    norm = video_path.replace(os.sep, "/").rstrip("/")
    ident = "/".join(norm.split("/")[-2:])
    seed = zlib.crc32(f"{ident}@{center_ts:.3f}".encode()) & 0x7FFFFFFF
    frames = np.random.RandomState(seed).rand(
        num_frames, crop_size, crop_size, 3
    )
    return frames.astype(np.float32)


class HTMClipDataset:
    """sample(i, rng) -> {'clips': [n, T, S, S, 3], 'input_ids': [n, W]}."""

    def __init__(
        self,
        annotation_csv: str,
        video_root: str,
        tokenizer=None,
        vid_to_path: Optional[Dict[str, str]] = None,
        vlen_table: Optional[Dict[str, int]] = None,
        num_frames: int = 16,
        fps: int = 5,
        num_sample_per_video: int = 2,
        crop_size: int = 224,
        max_words: int = 32,
        center_crop_only: bool = False,
        decoder: Optional[Decoder] = None,
        check_existence: bool = True,
        min_vlen: int = 64,
        max_vlen: int = 2000,
    ):
        self.video_root = video_root
        self.tokenizer = tokenizer
        self.num_frames = num_frames
        self.fps = fps
        self.num_sample_per_video = num_sample_per_video
        self.crop_size = crop_size
        self.max_words = max_words
        self.center_crop_only = center_crop_only
        self.decoder = decoder or ffmpeg_decode
        self.vid_to_path = vid_to_path or {}

        anno: Dict[str, List[Dict]] = {}
        with open(annotation_csv, newline="") as f:
            for row in csv.DictReader(f):
                anno.setdefault(row["vid"], []).append(
                    {"text": row["text"], "timestamp": float(row["timestamp"])}
                )

        vids = sorted(anno.keys())
        if vlen_table:
            vids = [v for v in vids
                    if v in vlen_table and min_vlen < vlen_table[v] < max_vlen]
        if check_existence:
            vids = [v for v in vids if os.path.exists(self._path(v))]
        self.anno = anno
        self.vid_list = vids

    def _path(self, vid: str) -> str:
        rel = self.vid_to_path.get(vid, f"{vid}.mp4")
        return os.path.join(self.video_root, rel)

    def __len__(self) -> int:
        return len(self.vid_list)

    def _tokenize(self, text: str) -> np.ndarray:
        if self.tokenizer is None:
            return np.asarray([1], np.int32)
        try:
            ids = np.asarray(self.tokenizer(text)["input_ids"], np.int32).reshape(-1)
        except Exception:
            # tokenizer-failure [PAD] fallback (video_loader.py:118-121)
            ids = np.zeros(self.max_words, np.int32)
        return ids[: self.max_words]

    def sample(self, index: int, rng: np.random.RandomState) -> Dict[str, np.ndarray]:
        vid = self.vid_list[index]
        rows = self.anno[vid]
        n = self.num_sample_per_video
        replace = len(rows) < n
        picks = rng.choice(len(rows), size=n, replace=replace)

        T, S, W = self.num_frames, self.crop_size, self.max_words
        clips = np.zeros((n, T, S, S, 3), np.float32)
        input_ids = np.zeros((n, W), np.int32)
        for j, p in enumerate(picks):
            row = rows[int(p)]
            input_ids[j] = pad_tokens(self._tokenize(row["text"]), W)
            try:
                clips[j] = self.decoder(
                    self._path(vid),
                    row["timestamp"],
                    T,
                    self.fps,
                    S,
                    rng=rng,
                    center_crop_only=self.center_crop_only,
                )
            except Exception:
                clips[j] = 0.5  # grey-frame fallback (video_loader.py:164-166)
        return {"clips": clips, "input_ids": input_ids}
