"""The port's YouCook2 retrieval against the JAX package's, f32 on the CPU, on
the same weights (moved through state_dict_from_jax) and the same numpy
inputs: the window plans, the datasets, the evaluator's pooled clip and text
features and its 12 metrics, and the eval CLI's ``--task retrieval``."""

import json

import numpy as np
import pytest
import torch

from port_fixtures import TINY, VOCAB, WORDS, model_pair
from temporalalignnet_torch.core.config import DataConfig, EvalConfig
from temporalalignnet_torch.data import YC2RetrievalDataset, YC2TrainDataset
from temporalalignnet_torch.eval.retrieval import (RetrievalEvaluator, plan_clip_windows,
                                                   sample_clip_windows)
from temporalalignnet_torch.models.word2vec import Word2VecTokenizer
from temporalalignnet_tpu.core.config import DataConfig as JaxDataConfig
from temporalalignnet_tpu.core.config import EvalConfig as JaxEvalConfig
from temporalalignnet_tpu.data import yc2 as jax_yc2
from temporalalignnet_tpu.eval import retrieval as jax_retrieval
from temporalalignnet_tpu.models.word2vec import Word2VecTokenizer as JaxWord2VecTokenizer

torch.set_num_threads(2)

FEATURE_TOL = 2e-5  # the forward bar (tests/test_checkpoint.py::test_full_forward_parity)
SEQ_LEN = 64
# (video length, [(segment start, end)]): every (Lb, interpolate) group the
# evaluator forms here, windows that start before 0 and run past the end,
# and a segment longer than 256 s (the lag branch)
VIDEOS = [
    (120, [(0.4, 10.9), (3.0, 23.5), (100.0, 134.0)]),   # Lb 32; 64 (no interp); 96, past the end
    (360, [(5.0, 37.5), (200.0, 275.0), (20.0, 340.0)]),  # Lb 64 interp; Lb 160; lag, Lb 256
    (90, [(40.0, 52.0), (1.0, 80.5)]),                    # Lb 32; Lb 160
]


def _items(rng):
    items = []
    for v, (vlen, segs) in enumerate(VIDEOS):
        video = rng.randn(vlen, TINY["video_embed_dim"]).astype(np.float32)
        for s, e in segs:
            ids = np.zeros(WORDS, np.int32)
            n = rng.randint(1, WORDS + 1)
            ids[:n] = rng.randint(1, VOCAB + 1, n)
            items.append({"vid": f"v{v}", "video": video, "start": s, "end": e, "input_ids": ids})
    return items


@pytest.mark.parametrize("start,end", [(0.0, 5.0), (0.4, 10.9), (3.0, 23.5), (7.0, 39.0),
                                       (100.0, 134.0), (2.0, 130.0), (10.0, 200.0),
                                       (20.0, 300.5), (1.0, 600.0), (5.0, 5.2)])
def test_window_plans_equal_jax(start, end):
    ours = plan_clip_windows(start, end, 10)
    ref = jax_retrieval.plan_clip_windows(start, end, 10)
    assert ours[1] == ref[1]
    for a, b in zip(ours[::2] + ours[3:], ref[::2] + ref[3:]):
        np.testing.assert_array_equal(a, b)
    feature = np.arange(150 * 3, dtype=np.float32).reshape(150, 3)
    for a, b in zip(sample_clip_windows(feature, start, end, 7),
                    jax_retrieval.sample_clip_windows(feature, start, end, 7)):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def features():
    """Clip and text features and metrics of both evaluators on one corpus;
    the port in forward calls of two clips (20 windows), so a group of three
    clips runs as a full and a partial call."""
    rng = np.random.RandomState(0)
    jm, params, tm = model_pair()
    items = _items(rng)
    ref_ev = jax_retrieval.RetrievalEvaluator(jm, params, JaxEvalConfig(seq_len=SEQ_LEN))
    ours_ev = RetrievalEvaluator(tm, EvalConfig(seq_len=SEQ_LEN, batch_windows=20))
    ids = np.stack([it["input_ids"] for it in items])
    ref_text = np.asarray(ref_ev._text_feature(params, ids))
    return {"ours_clip": ours_ev.clip_features(items), "ref_clip": ref_ev.clip_features(items),
            "ours_text": ours_ev.text_features(ids), "ref_text": ref_text,
            "ours": ours_ev.evaluate(items), "ref": ref_ev.evaluate(items),
            "groups": {ours_ev._prepare_item(it)[2::3] for it in items}}


def test_corpus_covers_every_group(features):
    assert features["groups"] == {(32, False), (64, False), (64, True), (96, True),
                                  (160, True), (256, True)}


@pytest.mark.parametrize("which", ["clip", "text"])
def test_pooled_features_match_jax(features, which):
    ours, ref = features[f"ours_{which}"], features[f"ref_{which}"]
    assert ours.shape == ref.shape == (sum(len(s) for _, s in VIDEOS), TINY["width"])
    np.testing.assert_allclose(ours, ref, atol=FEATURE_TOL, rtol=0)


def test_metrics_equal_jax(features):
    assert len(features["ours"]) == 12
    assert features["ours"] == features["ref"]


def test_chunking_leaves_the_features_unchanged(features):
    """One forward call per group against calls of two clips."""
    _, _, tm = model_pair()
    whole = RetrievalEvaluator(tm, EvalConfig(seq_len=SEQ_LEN, batch_windows=1000))
    np.testing.assert_allclose(whole.clip_features(_items(np.random.RandomState(0))),
                               features["ours_clip"], atol=1e-6, rtol=0)


# ------------------------------------------------------------------ datasets


def _write_yc2(root, rng):
    """A YC2-format annotation over six videos: a drop-list video, one without
    features, a training one, a duration mismatch (vid_bad), and .npy,
    .mp4.npy and .pth.tar feature files."""
    words = [f"w{i}" for i in range(VOCAB)]
    np.save(root / "vocab.npy", np.array(words))
    feats = root / "features"
    feats.mkdir()
    db = {}
    spec = [("vid_a", "validation", 80, ".npy"), ("vid_b", "validation", 140, ".mp4.npy"),
            ("vid_c", "training", 90, ".npy"), ("vid_d", "validation", 60, ".pth.tar"),
            ("FtHLUsOntqI", "validation", 70, ".npy"), ("vid_missing", "validation", 50, None),
            ("vid_e", "training", 100, ".webm.npy"), ("vid_f", "validation", 66, ".npy")]
    for vid, subset, vlen, suffix in spec:
        feature = rng.randn(vlen, TINY["video_embed_dim"]).astype(np.float32)
        if suffix == ".pth.tar":
            torch.save(torch.from_numpy(feature), feats / f"{vid}{suffix}")
        elif suffix:
            np.save(feats / f"{vid}{suffix}", feature)
        t, annos = float(rng.randint(0, 5)), []
        while t < vlen - 6:
            d = float(rng.randint(3, 30))
            annos.append({"segment": [t, min(t + d, vlen)],
                          "sentence": " ".join(rng.choice(words, rng.randint(1, 6)))})
            t += d + rng.randint(0, 4)
        db[vid] = {"subset": subset, "duration": vlen + float(rng.rand() * 1.5),
                   "annotations": annos}
    (root / "anno.json").write_text(json.dumps({"database": db}))
    bad = dict(db, vid_bad={"subset": "validation", "duration": 75.0,
                            "annotations": [{"segment": [1, 5], "sentence": "w1"}]})
    np.save(feats / "vid_bad.npy", np.zeros((70, TINY["video_embed_dim"]), np.float32))
    (root / "anno_bad.json").write_text(json.dumps({"database": bad}))
    return root


@pytest.fixture(scope="module")
def yc2_dir(tmp_path_factory):
    return _write_yc2(tmp_path_factory.mktemp("yc2"), np.random.RandomState(0))


def _assert_items_equal(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                assert a[k] == b[k], k


@pytest.mark.parametrize("mode", ["val", "train"])
def test_retrieval_dataset_equals_jax(yc2_dir, mode):
    feats, anno = str(yc2_dir / "features"), str(yc2_dir / "anno.json")
    vocab = str(yc2_dir / "vocab.npy")
    ours = YC2RetrievalDataset(feats, anno, mode, Word2VecTokenizer(vocab, WORDS), WORDS)
    ref = jax_yc2.YC2RetrievalDataset(feats, anno, mode, JaxWord2VecTokenizer(vocab, WORDS), WORDS)
    assert ours.clips == ref.clips
    vids = {c["vid"] for c in ours.clips}
    assert vids == ({"vid_a", "vid_b", "vid_d", "vid_f"} if mode == "val" else {"vid_c", "vid_e"})
    _assert_items_equal(list(ours), list(ref))


def test_retrieval_dataset_checks_the_duration(yc2_dir):
    feats, anno = str(yc2_dir / "features"), str(yc2_dir / "anno_bad.json")
    ours = YC2RetrievalDataset(feats, anno, "val")
    bad = [i for i, c in enumerate(ours.clips) if c["vid"] == "vid_bad"]
    with pytest.raises(AssertionError):
        jax_yc2.YC2RetrievalDataset(feats, anno, "val")[bad[0]]
    with pytest.raises(ValueError, match="vid_bad"):
        ours[bad[0]]


@pytest.mark.parametrize("mode", ["train", "val"])
def test_train_dataset_samples_equal_jax(yc2_dir, mode):
    feats, anno = str(yc2_dir / "features"), str(yc2_dir / "anno.json")
    tok = Word2VecTokenizer(str(yc2_dir / "vocab.npy"), WORDS)
    jtok = JaxWord2VecTokenizer(str(yc2_dir / "vocab.npy"), WORDS)
    kw = dict(seq_len=32, max_sentences=4, max_words=WORDS)
    ours = YC2TrainDataset(feats, anno, DataConfig(**kw), mode, tok)
    ref = jax_yc2.YC2TrainDataset(feats, anno, JaxDataConfig(**kw), mode, jtok)
    assert ours.video_ids == ref.video_ids and len(ours) > 0
    for i in range(len(ours)):
        for seed in range(3):
            _assert_items_equal([ours.sample(i, np.random.RandomState(seed))],
                                [ref.sample(i, np.random.RandomState(seed))])


# ----------------------------------------------------------------------- CLI


def test_eval_cli_retrieval_equals_the_evaluator(yc2_dir, tmp_path, capsys):
    from temporalalignnet_torch.eval.cli import main as eval_main

    _, _, tm = model_pair(use_alignability_head=True, num_pos_embeds=1024)
    ckpt = str(tmp_path / "tan.pth.tar")
    torch.save({"epoch": 0, "state_dict": tm.state_dict(), "iteration": 0}, ckpt)
    feats, anno = str(yc2_dir / "features"), str(yc2_dir / "anno.json")
    vocab = str(yc2_dir / "vocab.npy")
    out = eval_main(["--task", "retrieval", "--ckpt", ckpt, "--features", feats, "--anno", anno,
                     "--vocab", vocab, "--device", "cpu", "--max_words", str(WORDS),
                     "--num_clips", "4", "--video_embed_dim", str(TINY["video_embed_dim"]),
                     "--width", str(TINY["width"]), "--heads", str(TINY["heads"]),
                     "--num_encoder_layers", str(TINY["num_encoder_layers"]),
                     "--num_joint_layers", str(TINY["num_joint_layers"])])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    items = list(YC2RetrievalDataset(feats, anno, "val", Word2VecTokenizer(vocab, WORDS), WORDS))
    assert out == RetrievalEvaluator(tm, EvalConfig(num_clips=4)).evaluate(items)
    assert len(out) == 12
