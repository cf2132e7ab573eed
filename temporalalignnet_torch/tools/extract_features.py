"""Visual feature extraction (counterpart of
temporalalignnet_tpu/tools/extract_features.py; reference
htm_zoo/visual/extract_feature_template.py).

Decodes whole videos at ``fps`` and runs the frames, ``frames_per_feature``
at a time, through an ``encode_clip`` callable in batches of a fixed size,
writing one ``{vid}.npy`` (float16) per video; resumable, as the reference
is, by skipping existing outputs and a drop list (:329-379).  With the
defaults (16 fps, 16 frames per feature) that is one S3D feature per second,
the 1 fps features the TAN reads.

``make_s3d_encoder`` is S3D-G's 1024-d mixed_5c embedding from an
``s3d_howto100m.pth``-format file (the MIL-NCE release, or the end-to-end
trainer's ``params_latest.pth``) on ``device`` (the card unless the caller
asks for the CPU), in f32 or, with ``dtype=torch.bfloat16``, under autocast.
``make_clip_encoder`` runs the CLIP ViT (``models/clip_vit.py``) per frame
and averages a clip's frames (unit-normalized by default, CLIP's cosine
space); ``make_timesformer_encoder`` gives TimeSformer's class feature per
clip (``models/timesformer.py``).  Both take their tower's converted weights
(``checkpoint/clip_convert.py``, ``checkpoint/timesformer_convert.py``) and
uint8 frames, as in JAX.  The decode step is injectable (``decoder``), as in
``data/clips.py``.
"""

from __future__ import annotations

import os
import subprocess
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch


def ffmpeg_decode_video(path: str, fps: int, size: int) -> np.ndarray:
    """Whole-video decode -> [N, size, size, 3] float32 in [0, 1]
    (extract_feature_template.py:128-232)."""
    cmd = [
        "ffmpeg", "-i", path, "-vf", f"fps={fps},scale={size}:{size}",
        "-f", "rawvideo", "-pix_fmt", "rgb24", "-v", "error", "pipe:1",
    ]
    out = subprocess.run(cmd, capture_output=True, timeout=600).stdout
    n_px = size * size * 3
    n = len(out) // n_px
    if n == 0:
        raise RuntimeError(f"no frames decoded from {path}")
    return np.frombuffer(out[: n * n_px], np.uint8).reshape(n, size, size, 3).astype(
        np.float32) / 255.0


class FeatureExtractor:
    """``encode_clip``: [B, T, H, W, 3] -> [B, C]; ``extract_video`` gives
    [len(frames) // T, C] (a video shorter than one clip is padded with its
    last frame to one); the last batch is padded to ``batch_size`` so every
    call has one shape."""

    def __init__(self, encode_clip: Callable[[np.ndarray], np.ndarray], fps: int = 16,
                 frames_per_feature: int = 16, size: int = 224, batch_size: int = 8,
                 decoder: Optional[Callable[[str, int, int], np.ndarray]] = None):
        self.encode_clip = encode_clip
        self.fps = fps
        self.frames_per_feature = frames_per_feature
        self.size = size
        self.batch_size = batch_size
        self.decoder = decoder or ffmpeg_decode_video

    def extract_video(self, path: str) -> np.ndarray:
        frames = self.decoder(path, self.fps, self.size)
        T = self.frames_per_feature
        n_feat = len(frames) // T
        if n_feat == 0:  # pad a too-short video to one clip
            frames = np.concatenate([frames, np.repeat(frames[-1:], T - len(frames), 0)], 0)
            n_feat = 1
        clips = frames[: n_feat * T].reshape(n_feat, T, self.size, self.size, 3)
        feats = []
        B = self.batch_size
        for i in range(0, n_feat, B):
            chunk = clips[i:i + B]
            batch = chunk if len(chunk) == B else np.concatenate(
                [chunk, np.repeat(chunk[-1:], B - len(chunk), 0)], 0)
            feats.append(np.asarray(self.encode_clip(batch))[: len(chunk)])
        return np.concatenate(feats, 0)

    def run(self, videos: Dict[str, str], out_dir: str, bad_vids: Sequence[str] = ()
            ) -> List[str]:
        """{vid: path} -> the paths written, in vid order; skips existing
        outputs and ``bad_vids``; a video that fails is reported and skipped
        (extract_feature_template.py:329-379)."""
        os.makedirs(out_dir, exist_ok=True)
        done, bad = [], set(bad_vids)
        for vid, path in sorted(videos.items()):
            out_path = os.path.join(out_dir, f"{vid}.npy")
            if vid in bad or os.path.exists(out_path):
                continue
            try:
                feats = self.extract_video(path)
            except Exception as e:  # one bad video must not stop a corpus run
                print(f"[extract] {vid} failed: {e!r}")
                continue
            np.save(out_path, feats.astype(np.float16))
            done.append(out_path)
        return done


def make_s3d_encoder(weights: Union[str, Dict[str, torch.Tensor]], device: str = "cuda",
                     dtype: torch.dtype = torch.float32
                     ) -> Callable[[np.ndarray], np.ndarray]:
    """S3D's 1024-d embedding of [B, T, H, W, 3] clips in [0, 1] as a numpy
    callable.  ``weights``: a path (read by ``load_milnce_checkpoint``) or a
    state_dict in the S3D key space; its ``text_module`` keys, if any, are
    not used."""
    from temporalalignnet_torch.checkpoint import load_milnce_checkpoint, s3d_state_dict
    from temporalalignnet_torch.models.s3d import S3D

    if isinstance(weights, str):
        weights = s3d_state_dict(load_milnce_checkpoint(weights), text=False)
    dev = _encoder_device("make_s3d_encoder", device)
    model = S3D(num_classes=weights["fc.weight"].shape[0])
    model.load_state_dict(weights, strict=True)
    layout = torch.channels_last_3d if dev.type == "cuda" else torch.contiguous_format
    model = model.to(device=dev, memory_format=layout).eval()
    autocast = dtype != torch.float32

    @torch.inference_mode()
    def encode(clips: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(clips, np.float32)).to(dev)
        with torch.autocast(dev.type, dtype=dtype, enabled=autocast):
            emb = model(x.permute(0, 4, 1, 2, 3), return_embedding=True)
        return emb.float().cpu().numpy()

    return encode


def _encoder_device(name: str, device: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{name}: no CUDA device (pass device='cpu' for the CPU)")
    return dev


def make_clip_encoder(weights: Dict[str, torch.Tensor], device: str = "cuda",
                      dtype: torch.dtype = torch.float32, normalize: bool = True,
                      **tower_kwargs) -> Callable[[np.ndarray], np.ndarray]:
    """[B, T, H, W, 3] uint8 frames -> [B, E]: CLIP-ViT features of each
    frame, averaged over the clip's T frames (T is 1 at the reference's 1
    fps) and, with ``normalize``, unit-normalized (JAX
    tools/extract_features.py:138-170).  ``weights``: the tower's converted
    state_dict; ``tower_kwargs``: ``CLIPImageEncoder``'s sizes (default
    ViT-B/32)."""
    from temporalalignnet_torch.models.clip_vit import CLIPImageEncoder, preprocess_frames

    dev = _encoder_device("make_clip_encoder", device)
    model = CLIPImageEncoder(**tower_kwargs)
    model.load_state_dict(weights, strict=True)
    model = model.to(dev).eval()

    @torch.inference_mode()
    def encode(frames: np.ndarray) -> np.ndarray:
        B, T = frames.shape[:2]
        x = torch.from_numpy(np.ascontiguousarray(frames)).to(dev)
        x = preprocess_frames(x.reshape((B * T,) + x.shape[2:]))
        with torch.autocast(dev.type, dtype=dtype, enabled=dtype != torch.float32):
            feats = model(x)
        feats = feats.float().reshape(B, T, -1).mean(dim=1)
        if normalize:  # CLIP similarity is cosine (eval --baseline_sim cos)
            feats = feats / (feats.norm(dim=-1, keepdim=True) + 1e-8)
        return feats.cpu().numpy()

    return encode


def make_timesformer_encoder(weights: Dict[str, torch.Tensor], device: str = "cuda",
                             dtype: torch.dtype = torch.float32, **tower_kwargs
                             ) -> Callable[[np.ndarray], np.ndarray]:
    """[B, T, H, W, 3] uint8 clips -> [B, width]: TimeSformer's final-LN class
    token per clip, T the tower's ``frames`` (the reference extractor's
    8-frame clips at 8 fps; JAX tools/extract_features.py:173-200).
    ``weights``: the tower's converted state_dict; ``tower_kwargs``:
    ``TimeSformerEncoder``'s sizes (default the base model)."""
    from temporalalignnet_torch.models.timesformer import TimeSformerEncoder, preprocess_clip

    dev = _encoder_device("make_timesformer_encoder", device)
    model = TimeSformerEncoder(**tower_kwargs)
    model.load_state_dict(weights, strict=True)
    model = model.to(dev).eval()

    @torch.inference_mode()
    def encode(clips: np.ndarray) -> np.ndarray:
        x = preprocess_clip(torch.from_numpy(np.ascontiguousarray(clips)).to(dev))
        with torch.autocast(dev.type, dtype=dtype, enabled=dtype != torch.float32):
            feats = model(x)
        return feats.float().cpu().numpy()

    return encode
