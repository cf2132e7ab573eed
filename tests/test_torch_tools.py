"""The port's HTM-AA product tools against the JAX package's, f32 on the CPU:
generate_htm_aa (its CLI, on one reference checkpoint and one feature
directory), the S3D FeatureExtractor on the same weights and clips, and
the linear probe from JAX's initial weights."""

import csv
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_fixtures import (TINY, jax_s3d_variables, model_pair, write_feature_dir)
from temporalalignnet_torch.checkpoint import (Checkpointer, reference_checkpoint,
                                               s3d_state_dict_from_jax,
                                               save_reference_checkpoint)
from temporalalignnet_torch.data.clips import synthetic_decode
from temporalalignnet_torch.eval.linear_probe import _fit, linear_probe
from temporalalignnet_torch.tools import extract_features, generate_htm_aa
from temporalalignnet_tpu.eval.linear_probe import linear_probe as jax_linear_probe
from temporalalignnet_tpu.models.s3d import S3D as JaxS3D
from temporalalignnet_tpu.tools import extract_features as jax_extract
from temporalalignnet_tpu.tools import generate_htm_aa as jax_generate

torch.set_num_threads(2)

SCORE_TOL = 1e-5  # alignability scores, f32 on the CPU
FEATURE_ATOL, FEATURE_RTOL = 2e-4, 1e-3  # the S3D bar (tests/test_end2end.py:168-173)
PROBE_LOSS_TOL = 1e-5


# ---------------------------------------------------------- generate_htm_aa


def _read_rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _generate_args(root, ckpt, out):
    return ["--ckpt", str(ckpt), "--features", str(root / "features"),
            "--captions", str(root / "captions.json"), "--vocab", str(root / "vocab.npy"),
            "--out", str(out), "--video_embed_dim", str(TINY["video_embed_dim"]),
            "--width", str(TINY["width"]), "--heads", str(TINY["heads"]),
            "--num_encoder_layers", str(TINY["num_encoder_layers"]),
            "--num_joint_layers", str(TINY["num_joint_layers"]), "--max_words", "8",
            "--seq_len", "32"]


def test_generate_htm_aa_rows_equal_jax(tmp_path, capsys):
    """Both CLIs on one .pth.tar and one feature directory write the same
    (vid, text, timestamp) rows, scores within SCORE_TOL; the port also reads
    its trainer's experiment directory."""
    root = write_feature_dir(tmp_path)
    # the CLIs build the model at its default 1024 pos-enc slots
    _, _, model = model_pair(use_alignability_head=True, random_pos_start=False,
                             num_pos_embeds=1024)
    save_reference_checkpoint(str(root / "model.pth.tar"), model)
    jax_rows = jax_generate.main(_generate_args(root, root / "model.pth.tar", root / "jax.csv"))
    rows = generate_htm_aa.main(_generate_args(root, root / "model.pth.tar", root / "ours.csv")
                                + ["--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == {"videos": 7, "pairs": len(rows), "out": str(root / "ours.csv")}
    assert 0 < len(rows) == len(jax_rows)
    for a, b in zip(rows, jax_rows):
        assert (a["vid"], a["text"], a["timestamp"]) == (b["vid"], b["text"], b["timestamp"])
        assert abs(a["score"] - b["score"]) <= SCORE_TOL, (a, b)
    ours_csv, jax_csv = _read_rows(root / "ours.csv"), _read_rows(root / "jax.csv")
    assert [(r["vid"], r["text"], r["timestamp"]) for r in ours_csv] == [
        (r["vid"], r["text"], r["timestamp"]) for r in jax_csv]

    exp = tmp_path / "exp"  # a trainer's experiment directory: its newest checkpoint
    Checkpointer(str(exp)).save_epoch(reference_checkpoint(model, iteration=8), 0)
    from_dir = generate_htm_aa.main(_generate_args(root, exp, root / "dir.csv")
                                    + ["--device", "cpu"])
    assert from_dir == rows


def test_align_corpus_threshold():
    """A fixed threshold keeps the sentences at or above it; the timestamp is
    the argmax of the row with its zeros masked."""
    sim = np.array([[0.0, -1.0, -0.5], [0.2, 0.0, 0.1]], np.float32)

    class Fixed:
        def evaluate_video(self, item):
            return {"sim": sim, "align_score": np.array([0.3, 0.7])}

    items = [{"vid": "v", "sentences": [{"text": "a"}, {"text": "b"}]}]
    for mod in (generate_htm_aa, jax_generate):
        assert mod.align_corpus(Fixed(), items, threshold=0.5) == [
            {"vid": "v", "text": "b", "timestamp": 0.0, "score": 0.7}]
        assert [r["timestamp"] for r in mod.align_corpus(Fixed(), items, threshold=0.0)] == [
            2.0, 0.0]


# ----------------------------------------------------------- the extractor


def _whole_video_decoder(path, fps, size):
    """Synthetic whole videos of 2.5 clips' frames (the clip decoder's frames)."""
    return synthetic_decode(path, 0.0, 20, fps, size)


def test_feature_extractor_matches_jax(tmp_path):
    """The same S3D weights and synthetic videos: the port's S3D encoder (from
    a file, as params_latest.pth is read) writes features within the S3D
    bar of JAX's make_s3d_encoder; a second run skips what exists and the
    drop list."""
    x = jnp.zeros((3, 8, 32, 32, 3), jnp.float32)
    variables = jax.device_get(jax_s3d_variables(JaxS3D(), x, seed=4))
    torch.save(s3d_state_dict_from_jax(variables), tmp_path / "s3d.pth")
    videos = {f"v{i}": str(tmp_path / "videos" / f"v{i}.mp4") for i in range(3)}
    kw = dict(fps=8, frames_per_feature=8, size=32, batch_size=3,
              decoder=_whole_video_decoder)
    ref = jax_extract.FeatureExtractor(jax_extract.make_s3d_encoder(variables), **kw)
    ours = extract_features.FeatureExtractor(
        extract_features.make_s3d_encoder(str(tmp_path / "s3d.pth"), device="cpu"), **kw)
    assert ref.run(videos, str(tmp_path / "jax")) != []
    written = ours.run(videos, str(tmp_path / "ours"), bad_vids=["v2"])
    assert [p.split("/")[-1] for p in written] == ["v0.npy", "v1.npy"]
    for vid in ("v0", "v1"):
        got = np.load(tmp_path / "ours" / f"{vid}.npy")
        want = np.load(tmp_path / "jax" / f"{vid}.npy")
        assert got.shape == want.shape == (2, 1024) and got.dtype == np.float16
        np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32),
                                   atol=FEATURE_ATOL, rtol=FEATURE_RTOL)
    assert ours.run(videos, str(tmp_path / "ours"), bad_vids=["v2"]) == []


# --------------------------------------------------------------- the probe


def _probe_data(seed=0, C=5, D=16):
    rng = np.random.RandomState(seed)
    centers = rng.randn(C, D)

    def make(n):  # overlapping classes: neither all right nor all wrong
        y = np.repeat(np.arange(C), n)
        return (centers[y] + 3.0 * rng.randn(len(y), D)).astype(np.float32) + 3.0, y

    return make(12) + make(6)


def test_linear_probe_fit_equals_jax():
    """``_fit`` from JAX's initial w gives JAX's top-1 and top-5 and final
    loss; ``linear_probe`` (its own draw of w) lands near them."""
    Xtr, ytr, Xte, yte = _probe_data()
    C, D, steps = 5, 16, 300
    ref = jax_linear_probe(Xtr, ytr, Xte, yte, num_classes=C, steps=steps, seed=3)
    w0 = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (D, C)) * 0.01)
    got = _fit(w0, Xtr, ytr, Xte, yte, C, l2=1e-4, lr=1e-2, steps=steps, normalize=True,
               device="cpu")
    assert (got["top1"], got["top5"]) == (ref["top1"], ref["top5"])
    assert 0.2 < got["top1"] < 1.0
    np.testing.assert_allclose(got["final_train_loss"], ref["final_train_loss"],
                               atol=PROBE_LOSS_TOL, rtol=0)
    own = linear_probe(Xtr, ytr, Xte, yte, num_classes=C, steps=steps, seed=3, device="cpu")
    assert abs(own["final_train_loss"] - ref["final_train_loss"]) < 0.05
