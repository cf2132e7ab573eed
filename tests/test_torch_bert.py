"""The port's BERT text tower against the JAX package's (FlaxBertModule inside
temporalalignnet_tpu/models/net.py::BertEncoder) and against transformers'
BertTokenizer, f32 on the CPU: the tokenizer's ids, the encoder, the BERT
TAN's forward and its Stage-1 and cotrain steps on the same weights (moved
through state_dict_from_jax), the JAX exporter's checkpoint loaded strict,
the weight-directory readers (pytorch_model.bin, model.safetensors), the
optimizer's masks, and the train and eval CLIs against the JAX eval CLI."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from transformers import BertConfig as HFBertConfig
from transformers import BertTokenizer as HFBertTokenizer

from port_fixtures import CLI_SHAPE, TINY, VOCAB, WORDS, to_torch, write_feature_dir
from test_torch_retrieval import _write_yc2
from temporalalignnet_torch.checkpoint import (bert_state_dict_from_jax, load_reference_checkpoint,
                                               state_dict_from_jax)
from temporalalignnet_torch.core.config import LossConfig, ModelConfig, TrainConfig
from temporalalignnet_torch.models.bert import (BertConfig, BertEncoder, BertTokenizer,
                                                load_bert_dir, write_bert_dir)
from temporalalignnet_torch.models.net import TANWithText
from temporalalignnet_torch.train import EMATwin, Optimizer, make_train_step
from temporalalignnet_torch.train.optimizer import no_decay, trainable
from temporalalignnet_tpu.checkpoint.torch_convert import (params_to_torch,
                                                           save_reference_checkpoint)
from temporalalignnet_tpu.core import config as jcfg
from temporalalignnet_tpu.data.synthetic import synthetic_batch
from temporalalignnet_tpu.eval.cli import main as jax_eval_main
from temporalalignnet_tpu.models.net import BertEncoder as JaxBertEncoder
from temporalalignnet_tpu.models.net import TANWithText as JaxTANWithText
from temporalalignnet_tpu.train import optimizer as jax_optimizer
from temporalalignnet_tpu.train.train_step import create_train_state
from temporalalignnet_tpu.train.train_step import make_train_step as jax_make_train_step

torch.set_num_threads(2)

TOL = 2e-5  # the forward bar (tests/test_checkpoint.py::test_full_forward_parity)
LOSS_TOL = 2e-4  # whole steps (tests/test_torch_train.py)
PARAM_ATOL, PARAM_RTOL = 2e-4, 1e-3
SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
WORDLIST = SPECIALS + [f"w{i}" for i in range(VOCAB)]  # the feature fixtures' words
BERT = dict(vocab_size=len(WORDLIST), hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64, max_position_embeddings=16)
MODEL = dict(TINY, language_model="bert")


def _jax_bert():
    return JaxBertEncoder(hf_config=HFBertConfig(**BERT))


def _ids(rng, B=6, W=12):
    """Token ids with ragged padding, one row fully padded (a padded sentence slot)."""
    ids = rng.randint(1, BERT["vocab_size"], (B, W)).astype(np.int32)
    for b, n in enumerate(rng.randint(1, W + 1, B)):
        ids[b, n:] = 0
    ids[-1] = 0
    return ids


# -------------------------------------------------------------- tokenizer


TOKENIZER_VOCAB = SPECIALS + [
    "the", "cafe", "caf", "##e", "un", "##aff", "##able", "hello", "world", ",", "!", ".", "'",
    "s", "don", "t", "中", "国", "resume", "naive", "x", "##x", "a", "b", "12", "##3", "½", "é",
    "Hello", "Café", "ο", "##δ", "##ο", "##σ", "##ς"]
TOKENIZER_TEXTS = [
    "Hello, World!", "Café unaffable naïve résumé", "中国 is 中国人", "don't stop.",
    "ΟΔΟΣ οδος", "x" * 101, "x" * 100, "xxxxx", "a\tb c\x00d​", "hello [MASK] world[SEP]x",
    "12³ ½ ²", "😀 emoji", "[mask] lower", "   ", "ﬁne", "unaffable!!!", "Hello Café"]


@pytest.mark.parametrize("do_lower_case", [True, False], ids=["uncased", "cased"])
def test_tokenizer_ids_equal_transformers(tmp_path, do_lower_case):
    """Accents, punctuation, CJK, unknown and over-long words, special tokens
    in the text; from a directory (vocab.txt + tokenizer_config.json)."""
    write_bert_dir(str(tmp_path), BertConfig(**BERT), TOKENIZER_VOCAB, do_lower_case=do_lower_case)
    ref = HFBertTokenizer.from_pretrained(str(tmp_path))
    ours = BertTokenizer.from_dir(str(tmp_path))
    assert ours.vocab_size == ref.vocab_size == len(TOKENIZER_VOCAB)
    for text in TOKENIZER_TEXTS:
        want = ref(text)
        got = ours(text)
        assert got["input_ids"] == want["input_ids"], text
        assert got["attention_mask"] == want["attention_mask"], text
    assert ours(TOKENIZER_TEXTS[:3])["input_ids"] == ref(TOKENIZER_TEXTS[:3])["input_ids"]


# ---------------------------------------------------------------- encoder


def test_encoder_matches_jax(rng):
    """Last hidden state and pooler, fully padded rows included."""
    ids = _ids(rng)
    mask = (ids != 0).astype(np.int32)
    jb = _jax_bert()
    params = jax.device_get(jb.init(jax.random.PRNGKey(0), jnp.asarray(ids),
                                    jnp.asarray(mask))["params"])
    ref = jax.device_get(jb.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask)))
    ours = BertEncoder(BertConfig(**BERT))
    ours.load_state_dict(bert_state_dict_from_jax(params["bert"]), strict=True)
    with torch.no_grad():
        out = ours(to_torch(ids).long(), to_torch(mask))
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=TOL, rtol=TOL,
                                   err_msg=k)
    assert np.isfinite(out["last_hidden_state"][-1].numpy()).all()


def _jax_tan(**kw):
    cfg = jcfg.ModelConfig(**{**MODEL, **kw})
    model = JaxTANWithText(cfg, bert_config=HFBertConfig(**BERT))
    key = jax.random.PRNGKey(0)
    params = model.init({"params": key, "pos": key}, jnp.zeros((1, 16, cfg.video_embed_dim)),
                        jnp.zeros((1, 2, WORDS), jnp.int32), deterministic=True)["params"]
    return model, jax.device_get(params)


def _port_tan(params, **kw):
    model = TANWithText(ModelConfig(**{**MODEL, **kw}), bert_config=BertConfig(**BERT))
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return model.eval()


def _batch(seed=0, B=4, T=32, N=4):
    return synthetic_batch(np.random.RandomState(seed), batch_size=B, seq_len=T,
                           max_sentences=N, feature_dim=TINY["video_embed_dim"],
                           vocab_size=VOCAB, max_words=WORDS)


@pytest.mark.parametrize("fused", [False, True])
def test_tan_forward_matches_jax(fused):
    kw = dict(use_alignability_head=True, random_pos_start=False, fused_milnce=fused)
    jm, params = _jax_tan(**kw)
    tm = _port_tan(params, **kw)
    b = _batch()
    assert (b["input_ids"] == 0).all(-1).any()  # padded sentence slots: fully masked rows
    ref = jax.device_get(jm.apply(
        {"params": params}, jnp.asarray(b["video"]), jnp.asarray(b["input_ids"]),
        jnp.asarray(b["video_padding_mask"]), jnp.asarray(b["text_padding_mask"]),
        deterministic=True))
    with torch.no_grad():
        out = tm(to_torch(b["video"]), to_torch(b["input_ids"]).long(),
                 to_torch(b["video_padding_mask"]), to_torch(b["text_padding_mask"]),
                 deterministic=True)
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=TOL, rtol=TOL,
                                   err_msg=k)


# ----------------------------------------------------------- train steps


@pytest.mark.parametrize("model", ["init", "cotrain"])
def test_train_steps_match_jax(model):
    """Two Stage-1 or cotrain steps of the BERT TAN from the same weights on
    the same batch: metrics, then the online (and target) params."""
    cotrain = model == "cotrain"
    loss_kw = dict(use_fused_milnce=True)
    if cotrain:
        loss_kw.update(model="cotrain", learn_agreement=True, use_alignability_head=True)
    model_kw = dict(MODEL, fused_milnce=True, random_pos_start=False,
                    use_alignability_head=cotrain)
    train_kw = dict(lr=1e-3, warmup_iterations=2, total_iterations=100, ema_momentum=0.9)
    batch = _batch()

    jm = JaxTANWithText(jcfg.ModelConfig(**model_kw), bert_config=HFBertConfig(**BERT))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jtrain, jloss = jcfg.TrainConfig(**train_kw), jcfg.LossConfig(**loss_kw)
    state, tx = create_train_state(jm, jtrain, jloss, jbatch, seed=0)
    jstep = jax_make_train_step(jm, tx, jtrain, jloss)

    tm = TANWithText(ModelConfig(**model_kw), bert_config=BertConfig(**BERT))
    tm.load_state_dict(state_dict_from_jax(jax.device_get(state.params)), strict=True)
    tcfg = TrainConfig(**train_kw)
    twin = EMATwin(tm, tcfg) if cotrain else None
    opt = Optimizer(tm, tcfg)
    step = make_train_step(tm, opt, tcfg, LossConfig(**loss_kw), twin=twin)
    tbatch = {k: to_torch(v) for k, v in batch.items()}
    init = {k: v.clone() for k, v in tm.state_dict().items()}
    for _ in range(2):
        state, ref_m = jstep(state, jbatch)
        ours_m = step(tbatch)
        assert set(ours_m) == set(ref_m)
        assert abs(ours_m["loss"].item() - float(ref_m["loss"])) <= LOSS_TOL
        for k in ref_m:
            np.testing.assert_allclose(ours_m[k].item(), float(ref_m[k]), atol=5e-4, rtol=1e-3,
                                       err_msg=k)
    pairs = [("online", state.params, tm)]
    if cotrain:
        pairs.append(("target", state.ema_params, twin.model))
    for name, ref_params, module in pairs:
        ref = state_dict_from_jax(jax.device_get(ref_params))
        ours = module.state_dict()
        assert set(ref) == set(ours)
        for k in ref:
            np.testing.assert_allclose(ours[k].numpy(), ref[k].numpy(), atol=PARAM_ATOL,
                                       rtol=PARAM_RTOL, err_msg=f"{name} {k}")
    word = "bert.embeddings.word_embeddings.weight"
    assert not torch.equal(tm.state_dict()[word], init[word])  # BERT trains whole


# -------------------------------------------------- checkpoints and masks


def test_jax_exporter_checkpoint_loads_strict(tmp_path):
    """JAX params_to_torch's BERT keys are the port's: a Stage-1 and a twin
    .pth.tar written by the JAX exporter load with strict=True."""
    _, params = _jax_tan(use_alignability_head=True, num_pos_embeds=TINY["num_pos_embeds"])
    exported = params_to_torch(params)
    direct = state_dict_from_jax(params)
    assert set(exported) == set(direct) and any(k.startswith("bert.encoder.") for k in direct)
    for k, v in exported.items():
        np.testing.assert_array_equal(np.asarray(v), direct[k].numpy(), err_msg=k)
    target = jax.tree_util.tree_map(lambda x: np.asarray(x) * 0.5, params)
    for ema in (None, target):
        path = str(tmp_path / f"ckpt_{ema is None}.pth.tar")
        save_reference_checkpoint(path, params, ema_params=ema)
        model = TANWithText(ModelConfig(**MODEL, use_alignability_head=True),
                            bert_config=BertConfig(**BERT))
        load_reference_checkpoint(path, model, verbose=False)
        for k, v in model.state_dict().items():
            np.testing.assert_array_equal(v.numpy(), direct[k].numpy(), err_msg=k)


def _write_weights(path, params, fmt):
    """HF-style BERT weights of the JAX params: ``bert.*``, a ``cls.*`` head,
    the position-id buffer; pytorch_model.bin with the old LayerNorm names
    gamma/beta, or model.safetensors (the safetensors package writes it)."""
    sd = {f"bert.{k}": v for k, v in bert_state_dict_from_jax(params["bert"]).items()}
    sd["cls.predictions.bias"] = torch.zeros(BERT["vocab_size"])
    sd["cls.seq_relationship.weight"] = torch.zeros(2, BERT["hidden_size"])
    sd["bert.embeddings.position_ids"] = torch.arange(BERT["max_position_embeddings"])[None]
    if fmt == "pytorch_model.bin":
        sd = {k.replace("LayerNorm.weight", "LayerNorm.gamma").replace(
            "LayerNorm.bias", "LayerNorm.beta"): v for k, v in sd.items()}
        torch.save(sd, path / fmt)
    else:
        from safetensors.torch import save_file

        save_file({k: v.contiguous() for k, v in sd.items()}, str(path / fmt))


@pytest.mark.parametrize("fmt", ["pytorch_model.bin", "model.safetensors"])
def test_load_bert_dir_matches_jax(tmp_path, rng, fmt):
    ids = _ids(rng)
    mask = (ids != 0).astype(np.int32)
    jb = _jax_bert()
    params = jax.device_get(jb.init(jax.random.PRNGKey(1), jnp.asarray(ids),
                                    jnp.asarray(mask))["params"])
    ref = jax.device_get(jb.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask)))
    write_bert_dir(str(tmp_path), BertConfig(**BERT), WORDLIST)
    _write_weights(tmp_path, params, fmt)
    loaded = load_bert_dir(str(tmp_path))
    assert loaded.config == BertConfig(**BERT) and loaded.weight_file.endswith(fmt)
    assert sorted(loaded.report) == [f"dropped (pre-training head): cls.{k}" for k in
                                     ("predictions.bias", "seq_relationship.weight")]
    model = BertEncoder(loaded.config)
    model.load_state_dict(loaded.weights, strict=True)
    with torch.no_grad():
        out = model(to_torch(ids).long(), to_torch(mask))
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=TOL, rtol=TOL,
                                   err_msg=k)
    assert loaded.tokenizer("w3 w7")["input_ids"] == [2, 8, 12, 3]


def test_load_bert_dir_refuses_flax_msgpack_and_reads_a_config_only_dir(tmp_path):
    write_bert_dir(str(tmp_path), BertConfig(**BERT), WORDLIST)
    loaded = load_bert_dir(str(tmp_path))
    assert loaded.weights is None and loaded.weight_file is None
    (tmp_path / "flax_model.msgpack").write_bytes(b"\x80")
    with pytest.raises(ValueError, match="flax_model.msgpack"):
        load_bert_dir(str(tmp_path))


def test_decay_and_trainable_masks_match_jax():
    """BERT trains whole (word_embeddings too); its biases skip decay and its
    LayerNorm weights take it, as JAX's '.ln_'-pattern masks say."""
    _, params = _jax_tan()
    sd = state_dict_from_jax(params)
    for path, _ in jax.tree_util.tree_leaves_with_path(params["lang_model"]["bert"]):
        jpath = "lang_model/bert/" + "/".join(str(p.key) for p in path)
        parts = [str(p.key) for p in path]
        leaf = {"kernel": "weight", "scale": "weight", "embedding": "weight"}.get(parts[-1],
                                                                                  parts[-1])
        name = "bert." + ".".join(parts[:-1] + [leaf])
        assert name in sd, name
        assert no_decay(name) == jax_optimizer._no_decay(jpath), name
        assert trainable(name, "default") == jax_optimizer._trainable(jpath, "default"), name
    assert trainable("bert.embeddings.word_embeddings.weight", "default")
    assert not no_decay("bert.encoder.layer.0.output.LayerNorm.weight")
    assert no_decay("bert.encoder.layer.0.output.LayerNorm.bias")
    model = TANWithText(ModelConfig(**MODEL), bert_config=BertConfig(**BERT))
    opt = Optimizer(model, TrainConfig())
    assert len(opt.params) == sum(1 for _ in model.parameters())


# ---------------------------------------------------------------- the CLIs


@pytest.fixture(scope="module")
def bert_files(tmp_path_factory):
    """The tiny feature directory, an HTM-Align corpus over it, and a BERT
    directory with pytorch_model.bin weights from the JAX init."""
    root = write_feature_dir(tmp_path_factory.mktemp("bert_cli"))
    (root / "yc2").mkdir()
    _write_yc2(root / "yc2", np.random.RandomState(1))
    anno = {f"vid{v}": [[1, 3.0, 9.0, "w1 w2"], [0, 12.0, 20.0, "w3 w40"],
                        [1, 30.0, 41.0, "w4 w5, w9!"]] for v in (0, 2, 3)}
    (root / "anno.json").write_text(json.dumps(anno))
    jb = _jax_bert()
    params = jax.device_get(jb.init(jax.random.PRNGKey(2), jnp.zeros((1, WORDS), jnp.int32),
                                    jnp.ones((1, WORDS), jnp.int32))["params"])
    write_bert_dir(str(root / "bert"), BertConfig(**BERT), WORDLIST)
    _write_weights(root / "bert", params, "pytorch_model.bin")
    return root


def _train_args(root, tmp_path):
    return ["--feature_dir", str(root / "features"), "--captions", str(root / "captions.json"),
            "--language_model", "bert", "--bert_dir", str(root / "bert"), "--device", "cpu",
            "--batch_size", "2", "--seq_len", "32", "--max_sentences", "4", "--max_steps", "2",
            "--log_every", "1", "--num_workers", "2", "--prefix", str(tmp_path), *CLI_SHAPE]


def _eval_args(root, ckpt, task="align", data=None):
    data = data or root
    return ["--task", task, "--ckpt", ckpt, "--features", str(data / "features"),
            "--anno", str(data / "anno.json"), "--language_model", "bert",
            "--bert_dir", str(root / "bert"), "--seq_len", "32", "--use_alignability_head", "1",
            *CLI_SHAPE]


def test_train_and_eval_clis_with_bert_equal_jax_eval(bert_files, tmp_path, capsys,
                                                      monkeypatch):
    """Stage 1 from the directory's weights, then --model cotrain --pretrain;
    the port's eval CLI on each checkpoint prints the JAX eval CLI's metrics."""
    from temporalalignnet_torch.eval.cli import main as eval_main
    from temporalalignnet_torch.train.cli import main as train_main

    file_weights = load_bert_dir(str(bert_files / "bert")).weights
    seen = {}

    def spy(model, *a, twin=None, **kw):  # the weights as the first step sees them
        seen["online"] = {k: v.clone() for k, v in model.bert.state_dict().items()}
        if twin is not None:
            seen["target"] = {k: v.clone() for k, v in twin.model.bert.state_dict().items()}
        return make_train_step(model, *a, twin=twin, **kw)

    monkeypatch.setattr("temporalalignnet_torch.train.train_step.make_train_step", spy)
    stage1 = train_main(_train_args(bert_files, tmp_path) + ["--use_alignability_head", "1"])
    printed = capsys.readouterr().out.splitlines()
    for k, v in file_weights.items():
        assert torch.equal(seen["online"][k], v), k
    cotrain = train_main(_train_args(bert_files, tmp_path)
                         + ["--model", "cotrain", "--pretrain", stage1["checkpoint"]])
    assert "[bert] dropped (pre-training head): cls.predictions.bias" in printed
    assert not [l for l in printed if l.startswith("[bert] missing")]
    assert stage1["loss_finite"] and cotrain["loss_finite"] and cotrain["final_step"] == 2
    assert "cotrain_bert" in cotrain["checkpoint"]
    s1 = torch.load(stage1["checkpoint"], map_location="cpu", weights_only=True)["state_dict"]
    for k in seen["target"]:  # the twin starts as a copy of the merged online model
        assert torch.equal(seen["target"][k], s1[f"bert.{k}"]), k
    for ckpt in (stage1["checkpoint"], cotrain["checkpoint"]):
        ours = eval_main(_eval_args(bert_files, ckpt) + ["--device", "cpu"])
        ref = jax_eval_main(_eval_args(bert_files, ckpt) + ["--f32"])
        assert ours["Recall"] == ref["Recall"]
        assert ours["AUC"] == pytest.approx(ref["AUC"], abs=1e-9)
    # YouCook2 retrieval (--max_words sets W) on the Stage-1 checkpoint
    args = _eval_args(bert_files, stage1["checkpoint"], "retrieval", bert_files / "yc2")
    args += ["--num_clips", "4"]
    ours = eval_main(args + ["--device", "cpu"])
    ref = jax_eval_main(args + ["--f32"])
    assert set(ours) == set(ref) and len(ours) == 12
    for k in ref:
        assert ours[k] == pytest.approx(ref[k], abs=1e-9), k


def test_train_cli_bert_without_weights_and_refusals(bert_files, tmp_path, capsys):
    from temporalalignnet_torch.train.cli import main as train_main

    cfg_only = tmp_path / "cfg_only"
    write_bert_dir(str(cfg_only), BertConfig(**BERT), WORDLIST)
    args = _train_args(bert_files, tmp_path)
    args[args.index("--bert_dir") + 1] = str(cfg_only)
    out = train_main(args + ["--max_steps", "1"])
    assert f"[bert] no weight file in {cfg_only}; training from scratch" in (
        capsys.readouterr().out.splitlines())
    assert out["loss_finite"]
    (cfg_only / "flax_model.msgpack").write_bytes(b"\x80")
    with pytest.raises(SystemExit, match="flax_model.msgpack"):
        train_main(args)
    with pytest.raises(SystemExit, match="requires --bert_dir"):
        train_main(["--feature_dir", "f", "--captions", "c", "--language_model", "bert",
                    "--device", "cpu"])
