"""The port's raw-feature MIL-NCE baseline against the JAX package's, f32 on
the CPU: RawFeatureBaseline on the same weights and numpy inputs, the
MIL-NCE checkpoint reader on one synthetic s3d_howto100m.pth-format file,
and the eval CLI's baseline mode (no --ckpt, --milnce_ckpt) against the JAX
eval CLI on the same files."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_fixtures import TINY, VOCAB, WORDS, to_torch, write_milnce_checkpoint
from test_torch_retrieval import _write_yc2
from temporalalignnet_torch.checkpoint import load_milnce_checkpoint
from temporalalignnet_torch.core.config import ModelConfig
from temporalalignnet_torch.models.baseline import RawFeatureBaseline
from temporalalignnet_tpu.checkpoint import load_milnce_checkpoint as jax_load_milnce_checkpoint
from temporalalignnet_tpu.core.config import ModelConfig as JaxModelConfig
from temporalalignnet_tpu.eval.cli import main as jax_eval_main
from temporalalignnet_tpu.models.baseline import RawFeatureBaseline as JaxRawFeatureBaseline

torch.set_num_threads(2)

TOL = 2e-5
C = TINY["video_embed_dim"]


def _cfg_kw(sim):
    return dict(num_encoder_layers=0, num_joint_layers=1, video_embed_dim=C, sim=sim,
                use_alignability_head=False, random_pos_start=False)


def _baselines(sim, proj):
    """The JAX baseline's init (PRNGKey 0) and the port's with its weights."""
    jm = JaxRawFeatureBaseline(JaxModelConfig(**_cfg_kw(sim)), vocab_size=VOCAB + 1,
                               use_visual_proj=proj)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, C)),
                                    jnp.zeros((1, 2, WORDS), jnp.int32))["params"])
    tm = RawFeatureBaseline(ModelConfig(**_cfg_kw(sim)), vocab_size=VOCAB + 1,
                            use_visual_proj=proj)
    lang = params["lang_model"]
    sd = {"lang_model.word_embd.weight": to_torch(lang["word_embd"]["embedding"])}
    for fc in ("fc1", "fc2"):
        sd[f"lang_model.{fc}.weight"] = to_torch(lang[fc]["kernel"].T)
        sd[f"lang_model.{fc}.bias"] = to_torch(lang[fc]["bias"])
    if proj:
        sd["visual_proj.weight"] = to_torch(params["visual_proj"]["kernel"].T)
        sd["visual_proj.bias"] = to_torch(params["visual_proj"]["bias"])
    tm.load_state_dict(sd, strict=True)
    return jm, params, tm.eval()


@pytest.mark.parametrize("proj", [True, False], ids=["visual_proj", "no_proj"])
@pytest.mark.parametrize("sim", ["dot", "cos"])
def test_baseline_matches_jax(rng, sim, proj):
    jm, params, tm = _baselines(sim, proj)
    video = rng.randn(3, 16, C).astype(np.float32)
    ids = rng.randint(0, VOCAB + 1, (3, 5, WORDS)).astype(np.int32)
    ids[:, :, 0] = 1 + rng.randint(0, VOCAB, (3, 5))
    apply = lambda method, *a: jax.device_get(jm.apply({"params": params}, *a, method=method))
    text_ref = apply("encode_text", jnp.asarray(ids), jnp.asarray((ids != 0).astype(np.int32)))
    ref = apply("text_visual_sims", jnp.asarray(video), jnp.asarray(text_ref))
    ref_fwd = jax.device_get(jm.apply({"params": params}, jnp.asarray(video), jnp.asarray(ids)))
    with torch.no_grad():
        tids = to_torch(ids).long()
        text = tm.encode_text(tids, (tids != 0).int())
        ours = tm.text_visual_sims(to_torch(video), text)
        fwd = tm(to_torch(video), tids)
        feat = tm.visual_feature(to_torch(video))
    close = lambda a, b, what: np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL,
                                                          rtol=TOL, err_msg=what)
    close(text, text_ref, "encode_text")
    assert set(ours) == set(ref) and set(fwd) == set(ref_fwd)
    for k in ref:
        assert ours[k].shape == (3, 1, 16, 5) and ours[k].dtype == torch.float32
        close(ours[k], ref[k], k)
    for k in ref_fwd:
        close(fwd[k], ref_fwd[k], k)
    close(feat, apply("visual_feature", jnp.asarray(video)), "visual_feature")
    assert tm.textual_feature(text) is text


def test_load_milnce_checkpoint_matches_jax(tmp_path, capsys):
    path = str(tmp_path / "s3d_howto100m.pth")
    text = write_milnce_checkpoint(path, VOCAB + 1, C)
    ours = load_milnce_checkpoint(path)
    ours_out = capsys.readouterr().out
    ref = jax_load_milnce_checkpoint(path)
    assert capsys.readouterr().out == ours_out  # the same [s3d_convert] lines
    assert ours["report"] == ref["report"] and len(ours["report"]) == 3
    tp = ref["text_params"]
    expect = {"word_embd.weight": tp["word_embd"]["embedding"],
              **{f"{fc}.{leaf}": (tp[fc]["kernel"].T if leaf == "weight" else tp[fc]["bias"])
                 for fc in ("fc1", "fc2") for leaf in ("weight", "bias")}}
    assert set(ours["text"]) == set(expect) == set(text)
    for k, v in expect.items():
        np.testing.assert_array_equal(ours["text"][k].numpy(), v, err_msg=k)
        np.testing.assert_array_equal(ours["text"][k].numpy(), text[k].numpy(), err_msg=k)
    fc = ref["params"]["fc"]
    np.testing.assert_array_equal(ours["fc"]["weight"].numpy(), fc["kernel"].T)
    np.testing.assert_array_equal(ours["fc"]["bias"].numpy(), fc["bias"])
    # the S3D conv and BN tensors are read and set aside: as many as JAX converts
    n_ref = len(jax.tree_util.tree_leaves(ref["params"])) - 2 + len(
        jax.tree_util.tree_leaves(ref["batch_stats"]))
    assert len(ours["s3d"]) == n_ref == 5


# -------------------------------------------------------------------- CLI


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """An HTM-Align corpus, a YC2 one, a vocab and a MIL-NCE checkpoint."""
    root = tmp_path_factory.mktemp("baseline")
    rng = np.random.RandomState(0)
    _write_yc2(root, rng)  # features/, anno.json, vocab.npy
    words = np.load(root / "vocab.npy")
    feat = root / "align_features"
    feat.mkdir()
    anno = {}
    for v in range(3):
        vlen = int(rng.randint(70, 140))
        np.save(feat / f"vid{v}.npy", rng.randn(vlen, C).astype(np.float32))
        sents, t = [], 2.0
        while t < vlen - 8 and len(sents) < 9:
            text = " ".join(rng.choice(words, size=rng.randint(2, 6)))
            sents.append([int(rng.rand() < 0.6), t, t + 6.0, text])
            t += float(rng.randint(7, 14))
        anno[f"vid{v}"] = sents
    (root / "htm_align.json").write_text(json.dumps(anno))
    write_milnce_checkpoint(str(root / "s3d_howto100m.pth"), VOCAB + 1, C)
    return root


def _cli_args(root, task):
    feats, anno = (("align_features", "htm_align.json") if task == "align"
                   else ("features", "anno.json"))
    return ["--task", task, "--features", str(root / feats), "--anno", str(root / anno),
            "--vocab", str(root / "vocab.npy"), "--max_words", str(WORDS), "--seq_len", "32",
            "--video_embed_dim", str(C), "--num_clips", "4"]


@pytest.mark.parametrize("task,method,sim", [
    ("align", "overlap-seq", "dot"), ("align", "global", "dot"), ("align", "overlap-seq", "cos"),
    ("retrieval", None, "dot")])
def test_eval_cli_baseline_equals_jax_cli(files, task, method, sim, capsys):
    from temporalalignnet_torch.eval.cli import main as eval_main

    args = _cli_args(files, task) + ["--milnce_ckpt", str(files / "s3d_howto100m.pth"),
                                     "--baseline_sim", sim]
    if method:
        args += ["--method", method]
    ours = eval_main(args + ["--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == ours
    assert any(l.startswith("[s3d_convert] unrecognized key") for l in out)
    ref = jax_eval_main(args + ["--f32"])
    assert set(ours) == set(ref) and len(ours) == (2 if task == "align" else 12)
    for k in ref:
        assert ours[k] == pytest.approx(ref[k], abs=1e-12), k


def test_eval_cli_baseline_without_milnce_ckpt_scores_raw_features(files, capsys):
    """No --milnce_ckpt: no projection, a text tower of random weights whose
    output has the features' width."""
    from temporalalignnet_torch.eval.cli import main as eval_main

    out = eval_main(_cli_args(files, "align") + ["--device", "cpu", "--baseline_sim", "cos"])
    assert 0.0 <= out["Recall"] <= 1.0 and 0.0 <= out["AUC"] <= 1.0
