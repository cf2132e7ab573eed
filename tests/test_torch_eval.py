"""The port's HTM-Align evaluation against the JAX package's on the same
weights and the same synthetic corpus, f32 on the CPU; and the port's numpy
copies (metrics, tokenizer, packed table, dataset) against theirs."""

import copy
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_fixtures import make_corpus, model_pair
from temporalalignnet_torch.core.config import EvalConfig
from temporalalignnet_torch.data.htm_align import HTMAlignDataset
from temporalalignnet_torch.eval.align import AlignmentEvaluator
from temporalalignnet_torch.eval.metrics import retrieval_metrics, roc_auc_score
from temporalalignnet_torch.eval.pack import pack_video_table
from temporalalignnet_torch.models.word2vec import Word2VecTokenizer
from temporalalignnet_tpu.core.config import EvalConfig as JaxEvalConfig
from temporalalignnet_tpu.data.htm_align import HTMAlignDataset as JaxHTMAlignDataset
from temporalalignnet_tpu.eval import metrics as jax_metrics
from temporalalignnet_tpu.eval.align import AlignmentEvaluator as JaxAlignmentEvaluator
from temporalalignnet_tpu.eval.pack import pack_video_table as jax_pack_video_table
from temporalalignnet_tpu.models.word2vec import Word2VecTokenizer as JaxWord2VecTokenizer

torch.set_num_threads(2)

CANVAS_TOL = 2e-4  # logits / 0.07, summed over up to 4 windows


@pytest.mark.parametrize("use_head", [True, False])
@pytest.mark.parametrize("method", ["overlap-seq", "global"])
def test_evaluator_matches_jax(rng, method, use_head):
    jm, params, tm = model_pair(use_alignability_head=use_head, num_joint_layers=3)
    corpus = make_corpus(rng, num_videos=3, min_len=60, max_len=150)
    corpus.append(copy.deepcopy(corpus[0]))  # a repeated 'vid' shares one table copy
    for i, item in enumerate(corpus):
        item["vid"] = f"v{i % 3}"
    jax_ev = JaxAlignmentEvaluator(jm, params, JaxEvalConfig(seq_len=32, method=method,
                                                             global_buckets=2))
    # small chunks so windows of several videos share a forward call
    ours_ev = AlignmentEvaluator(tm, EvalConfig(seq_len=32, method=method, global_buckets=2,
                                                batch_windows=5))
    if method == "global":
        ref = jax_ev.evaluate_corpus_global(corpus)
    else:
        ref = jax_ev.evaluate_corpus_batched(corpus)
    ours = ours_ev.evaluate_corpus(corpus)
    for a, b in zip(ours, ref):
        assert a["sim"].shape == b["sim"].shape
        np.testing.assert_allclose(a["sim"], b["sim"], atol=CANVAS_TOL, rtol=0)
        np.testing.assert_allclose(a["align_score"], b["align_score"], atol=CANVAS_TOL, rtol=0)
    m_ours, m_ref = ours_ev.evaluate(corpus), jax_ev.evaluate(corpus)
    assert m_ours["Recall"] == m_ref["Recall"]
    assert m_ours["AUC"] == pytest.approx(m_ref["AUC"], abs=1e-12)
    # the single-video entry point is the corpus path on one item
    one = ours_ev.evaluate_video(corpus[1])
    np.testing.assert_allclose(one["sim"], ours[1]["sim"], atol=1e-5, rtol=0)


@pytest.mark.parametrize("use_head", [True, False])
def test_global_method_runs_no_dual_encoder(rng, use_head):
    """The global method reads only the joint sim and the joint head, so it
    runs the joint encoder alone: no call reaches the dual encoder, while
    overlap-seq still calls it; the metrics equal JAX's, whose jit drops the
    dual encoder the same way."""
    jm, params, tm = model_pair(use_alignability_head=use_head)
    corpus = make_corpus(rng, num_videos=3, min_len=60, max_len=150)
    calls = {"video": 0, "joint": 0}
    for name in calls:
        enc = getattr(tm, f"{name}_temporal_encoder")
        enc.register_forward_hook(lambda *_, n=name: calls.__setitem__(n, calls[n] + 1))
    cfg = dict(seq_len=32, method="global", global_buckets=2)
    ours = AlignmentEvaluator(tm, EvalConfig(**cfg)).evaluate(corpus)
    assert calls["video"] == 0 and calls["joint"] > 0
    ref = JaxAlignmentEvaluator(jm, params, JaxEvalConfig(**cfg)).evaluate(corpus)
    assert ours["Recall"] == ref["Recall"]
    assert ours["AUC"] == pytest.approx(ref["AUC"], abs=1e-12)
    AlignmentEvaluator(tm, EvalConfig(seq_len=32)).evaluate(corpus[:1])
    assert calls["video"] > 0


def test_global_pad_invariance_across_bucket_sizes(rng, monkeypatch):
    """The same video at two video-axis buckets (Tb and Tb + 64) gives the
    same canvases: pad rows gather the last real row and are key-masked, so
    they never contribute (the port's copy of tests/test_eval.py's check)."""
    import temporalalignnet_torch.eval.align as align_mod

    _, _, tm = model_pair(use_alignability_head=True)
    corpus = make_corpus(rng, num_videos=1, min_len=70, max_len=70)
    ev = AlignmentEvaluator(tm, EvalConfig(seq_len=32, method="global"))
    base = ev.evaluate_corpus_global(corpus)[0]
    orig = align_mod._round_up
    monkeypatch.setattr(align_mod, "_round_up",
                        lambda x, m: orig(x, m) + (64 if m == 64 else 0))
    wide = ev.evaluate_corpus_global(corpus)[0]
    assert wide["sim"].shape == base["sim"].shape
    # only the reductions over the padded key axis change order
    np.testing.assert_allclose(wide["sim"], base["sim"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(wide["align_score"], base["align_score"], atol=1e-5, rtol=0)


def test_roc_auc_and_retrieval_metrics_match_jax(rng):
    y = (rng.rand(300) > 0.6).astype(int)
    s = np.round(rng.randn(300), 1)  # ties
    assert roc_auc_score(y, s) == jax_metrics.roc_auc_score(y, s)
    sim = rng.randn(12, 12)
    assert retrieval_metrics(sim, "C-") == jax_metrics.retrieval_metrics(sim, "C-")


def test_tokenizer_matches_jax():
    vocab = ["cut", "the", "onion", "don't", "stir", "pan"]
    sents = ["Cut THE onion, don't burn it!", "", "stir stir stir the pan " * 3, "unknown"]
    ours = Word2VecTokenizer(vocab, max_words=6)(sents)
    ref = JaxWord2VecTokenizer(vocab, max_words=6)(sents)
    for k in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(ours[k], ref[k])
    assert Word2VecTokenizer(vocab).vocab_size == 7


@pytest.mark.parametrize("bf16", [False, True])
def test_pack_video_table_matches_jax(rng, bf16):
    videos = [rng.randn(n, 8).astype(np.float32) for n in (5, 17, 3)]
    table, offs = pack_video_table(videos, torch.bfloat16 if bf16 else torch.float32)
    ref, ref_offs = jax_pack_video_table(videos, jnp.bfloat16 if bf16 else jnp.float32)
    assert table.dtype == (torch.bfloat16 if bf16 else torch.float32)
    np.testing.assert_array_equal(offs, ref_offs)
    np.testing.assert_array_equal(table.float().numpy(), np.asarray(ref, np.float32))


def test_htm_align_dataset_matches_jax(tmp_path, rng):
    feat = tmp_path / "features"
    feat.mkdir()
    np.save(feat / "b.npy", rng.randn(30, 4).astype(np.float32))
    torch.save(torch.randn(20, 4), feat / "a.pth.tar")
    anno = {"b": [[1, 2.0, 7.5, "cut the onion"], [0, 0.0, 0.0, "don't stir"]],
            "a": [[0, 1.0, 3.0, "the pan"]]}
    (tmp_path / "htm_align.json").write_text(json.dumps(anno))
    vocab = ["cut", "the", "onion", "don't", "stir", "pan"]
    args = (str(feat), str(tmp_path / "htm_align.json"))
    ours = list(HTMAlignDataset(*args, Word2VecTokenizer(vocab, 5), 5))
    ref = list(JaxHTMAlignDataset(*args, JaxWord2VecTokenizer(vocab, 5), 5))
    assert [i["vid"] for i in ours] == ["a", "b"] == [i["vid"] for i in ref]
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a["video"], b["video"])
        for sa, sb in zip(a["sentences"], b["sentences"]):
            np.testing.assert_array_equal(sa.pop("input_ids"), sb.pop("input_ids"))
            assert sa == sb
    assert ours[0]["video"].shape == (20, 4)
