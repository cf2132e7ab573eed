"""The port's smaller pieces against the JAX package's, on the CPU: the
mask-driven sine positions, HTMAlignTrainDataset's windows, test_alignment,
the classification meters, Logger and denormalize."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_fixtures import make_corpus, model_pair
from temporalalignnet_torch.core.config import EvalConfig
from temporalalignnet_torch.data import HTMAlignTrainDataset
from temporalalignnet_torch.eval import align as align_mod
from temporalalignnet_torch.models import position_embedding_sine_from_mask
from temporalalignnet_torch.models.word2vec import Word2VecTokenizer
from temporalalignnet_torch.utils.logging import Logger, denormalize
from temporalalignnet_torch.utils.meters import ConfusionMeter, calc_topk_accuracy
from temporalalignnet_tpu.data import HTMAlignTrainDataset as JaxHTMAlignTrainDataset
from temporalalignnet_tpu.eval import align as jax_align_mod
from temporalalignnet_tpu.models.posenc import (
    position_embedding_sine_from_mask as jax_position_embedding_sine_from_mask)
from temporalalignnet_tpu.models.word2vec import Word2VecTokenizer as JaxWord2VecTokenizer
from temporalalignnet_tpu.utils.logging import Logger as JaxLogger
from temporalalignnet_tpu.utils.logging import denormalize as jax_denormalize
from temporalalignnet_tpu.utils.meters import ConfusionMeter as JaxConfusionMeter
from temporalalignnet_tpu.utils.meters import calc_topk_accuracy as jax_calc_topk_accuracy

torch.set_num_threads(2)

POSENC_TOL = 1e-6
WORDS = ["cut", "the", "onion", "mix", "well", "now"]


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("dim", [32, 48])
def test_mask_driven_sine_matches_jax(normalize, dim):
    rng = np.random.RandomState(dim)
    T = 16
    lengths = np.concatenate([[T, 8, 1, 0], rng.randint(0, T + 1, 4)])  # one row all pad
    pad = np.arange(T)[None] >= lengths[:, None]
    ours = position_embedding_sine_from_mask(torch.from_numpy(pad), feature_dim=dim,
                                             normalize=normalize)
    ref = jax_position_embedding_sine_from_mask(jnp.asarray(pad), feature_dim=dim,
                                                normalize=normalize)
    assert ours.shape == (len(lengths), T, dim) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=POSENC_TOL, rtol=0)
    if normalize:  # a valid prefix spans the range of a full row (JAX's test_robustness)
        np.testing.assert_allclose(ours[1, 7].numpy(), ours[0, 15].numpy(), atol=1e-5)


def _write_align_files(root, rng):
    """Features and an htm_align.json: a long video, one shorter than the
    window, one with no alignable sentence, one whose only alignable
    sentence has no length (no sentence enters its window) and one without
    sentences."""
    feat = root / "features"
    feat.mkdir()
    anno = {
        "long": [[1, 10.0, 20.0, "cut the onion"], [0, 0.0, 0.0, "unalignable chatter"],
                 [1, 40.0, 55.0, "mix well"], [1, 80.0, 96.5, "now cut"],
                 [0, 0.0, 0.0, "the end"], [1, 100.0, 118.0, "mix the onion well"]],
        "short": [[1, 2.0, 9.0, "cut"], [0, 0.0, 0.0, "well"], [1, 12.5, 30.0, "mix now"]],
        "unaligned": [[0, 0.0, 0.0, "cut the onion"], [0, 0.0, 0.0, "mix well"]],
        "empty_span": [[1, 10.0, 10.0, "cut"]],
        "no_sentences": [],
    }
    lengths = {"long": 120, "short": 20, "unaligned": 70, "empty_span": 50, "no_sentences": 40}
    for vid, n in lengths.items():
        np.save(feat / f"{vid}.npy", rng.randn(n, 16).astype(np.float32))
    path = root / "htm_align.json"
    path.write_text(json.dumps(anno))
    return str(feat), str(path)


@pytest.mark.parametrize("max_sentences", [4, 2])
def test_align_train_dataset_matches_jax(tmp_path, max_sentences):
    feat, anno = _write_align_files(tmp_path, np.random.RandomState(0))
    kw = dict(seq_len=32, max_sentences=max_sentences, max_words=6)
    ours = HTMAlignTrainDataset(feat, anno, Word2VecTokenizer(WORDS, max_words=6), **kw)
    ref = JaxHTMAlignTrainDataset(feat, anno, JaxWord2VecTokenizer(WORDS, max_words=6), **kw)
    assert len(ours) == len(ref) == 5
    seen_unk = False
    for seed in range(3):
        r_ours, r_ref = np.random.RandomState(seed), np.random.RandomState(seed)
        for index in range(len(ours)):
            a, b = ours.sample(index, r_ours), ref.sample(index, r_ref)
            assert list(a) == list(b)
            for key in b:
                assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape, key
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
            assert a["video"].shape == (32, 16) and a["align"].shape == (max_sentences,)
            seen_unk |= bool((~a["text_padding_mask"]).sum() == 1 and a["align"][0] == 0
                             and a["end"][0] == 32)
        assert r_ours.randint(1 << 30) == r_ref.randint(1 << 30)  # as many draws
    assert seen_unk


def test_test_alignment_is_the_evaluator_and_matches_jax(rng):
    jm, params, tm = model_pair(use_alignability_head=True)
    corpus = make_corpus(rng, num_videos=2, min_len=60, max_len=90)
    ours = align_mod.test_alignment(tm, corpus)
    assert ours == align_mod.AlignmentEvaluator(tm, EvalConfig()).evaluate(corpus)
    cfg = EvalConfig(method="global")
    assert align_mod.test_alignment(tm, corpus, cfg) == \
        align_mod.AlignmentEvaluator(tm, cfg).evaluate(corpus)
    ref = jax_align_mod.test_alignment(jm, params, corpus)
    assert ours["Recall"] == ref["Recall"]
    assert ours["AUC"] == pytest.approx(ref["AUC"], abs=1e-12)


@pytest.mark.parametrize("case", ["reference", "random"])
def test_meters_match_jax(case):
    if case == "reference":  # JAX's tests/test_misc.py example
        scores = np.array([[0.1, 0.9, 0.0], [0.8, 0.1, 0.1], [0.2, 0.3, 0.5]])
        targets, preds, topk = np.array([1, 0, 0]), np.array([1, 0, 2]), (1, 2)
    else:
        rng = np.random.RandomState(3)
        scores = rng.randn(50, 7)
        targets, preds, topk = rng.randint(0, 7, 50), rng.randint(0, 7, 50), (1, 3, 5, 7)
    ours = calc_topk_accuracy(scores, targets, topk)
    assert ours == jax_calc_topk_accuracy(scores, targets, topk)
    if case == "reference":
        assert ours == pytest.approx([2 / 3, 2 / 3])
    else:
        assert ours[-1] == 1.0
    cm, jcm = ConfusionMeter(scores.shape[1]), JaxConfusionMeter(scores.shape[1])
    assert cm.accuracy() == jcm.accuracy() == 0.0
    for c in (cm, jcm):
        c.update(preds, targets)
        c.update(targets, targets)
    np.testing.assert_array_equal(cm.mat, jcm.mat)
    assert cm.mat.dtype == jcm.mat.dtype
    assert cm.accuracy() == jcm.accuracy() and str(cm) == str(jcm)


def test_logger_and_denormalize_match_jax(tmp_path, capsys):
    for cls, name in ((Logger, "ours"), (JaxLogger, "jax")):
        lg = cls(str(tmp_path / name / "log.txt"))
        lg.log("hello")
        lg.log("second line")
        lg.close()
    printed = capsys.readouterr().out
    assert printed == "hello\nsecond line\n" * 2
    assert (tmp_path / "ours" / "log.txt").read_text() == \
        (tmp_path / "jax" / "log.txt").read_text() == "hello\nsecond line\n"
    frames = np.random.RandomState(4).randn(2, 5, 4, 3).astype(np.float32) * 2
    ours, ref = denormalize(frames), jax_denormalize(frames)
    assert ours.dtype == ref.dtype and ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_allclose(denormalize(np.zeros((2, 2, 3)))[0, 0], [0.485, 0.456, 0.406],
                               atol=1e-6)
