"""The port's CLIP towers against the JAX package's, f32 on the CPU: the BPE
tokenizer's ids on non-ASCII text, the text and vision towers on HF-key-space
weights (through each package's converter, and against transformers' own
modules), the raw-feature baseline in CLIP mode, the eval CLI's CLIP
baseline against the JAX eval CLI, and make_clip_encoder against JAX's."""

import gzip
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from transformers import (CLIPConfig, CLIPModel, CLIPTextConfig, CLIPTextModelWithProjection,
                          CLIPVisionConfig, CLIPVisionModelWithProjection)

from test_clip_text import _tiny_bpe_files
from test_torch_retrieval import _write_yc2
from temporalalignnet_torch.checkpoint import clip_text_state_dict, clip_vision_state_dict
from temporalalignnet_torch.checkpoint.clip_convert import clip_text_geometry
from temporalalignnet_torch.core.config import ModelConfig
from temporalalignnet_torch.models.baseline import RawFeatureBaseline
from temporalalignnet_torch.models.clip_text import CLIPTextEncoder, CLIPTokenizer
from temporalalignnet_torch.models.clip_vit import CLIPImageEncoder
from temporalalignnet_torch.ops.attention import multihead_attention
from temporalalignnet_torch.tools.extract_features import make_clip_encoder
from temporalalignnet_tpu.checkpoint import (clip_text_torch_to_params,
                                             clip_vision_torch_to_params, neq_merge)
from temporalalignnet_tpu.core.config import ModelConfig as JaxModelConfig
from temporalalignnet_tpu.eval.cli import main as jax_eval_main
from temporalalignnet_tpu.models.baseline import RawFeatureBaseline as JaxRawFeatureBaseline
from temporalalignnet_tpu.models.clip_text import CLIPTextEncoder as JaxCLIPTextEncoder
from temporalalignnet_tpu.models.clip_text import CLIPTokenizer as JaxCLIPTokenizer
from temporalalignnet_tpu.models.clip_vit import CLIPImageEncoder as JaxCLIPImageEncoder
from temporalalignnet_tpu.tools.extract_features import make_clip_encoder as jax_make_clip_encoder

torch.set_num_threads(2)

TOL = 2e-5
# the text projection is the YC2 fixture's feature width (TINY's video_embed_dim)
TEXT = dict(vocab_size=99, hidden_size=32, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, max_position_embeddings=16, projection_dim=32,
            attention_dropout=0.0, eos_token_id=98, bos_token_id=97, pad_token_id=98)
VISION = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128,
              image_size=32, patch_size=16, projection_dim=32)
VISION_KW = dict(width=32, layers=2, heads=4, patch_size=16, embed_dim=32)


def _hf_text(seed=0, **over):
    torch.manual_seed(seed)
    return CLIPTextModelWithProjection(CLIPTextConfig(**{**TEXT, **over})).eval()


def _hf_vision(act="quick_gelu", seed=0):
    torch.manual_seed(seed)
    return CLIPVisionModelWithProjection(CLIPVisionConfig(**VISION, hidden_act=act)).eval()


def _text_ids(rng, B=4, L=12):
    """BOS-led rows with one EOS (98, the highest id) each: both poolings agree."""
    ids = rng.randint(1, 96, size=(B, L)).astype(np.int64)
    ids[:, 0] = TEXT["bos_token_id"]
    for b, pos in enumerate(rng.randint(2, L, size=B)):
        ids[b, pos] = TEXT["eos_token_id"]
        ids[b, pos + 1:] = 0
    return ids


# -------------------------------------------------------------- tokenizer


NON_ASCII = ["Café crème brûlée, naïve résumé", "x² + y² = z², ½ cup, ¾ tsp", "中文字幕 日本語 한국어",
             "emoji 😀👍🏽 time!!", "don't we'll I'M he'd it's", "Ⅻ ⅷ ① 12345",
             "&amp;quot;hello&quot; world", "  tabs\tand\nnew lines here ",
             "<|startoftext|>hello<|endoftext|>", "straße ǅ İstanbul"]


def test_tokenizer_ids_equal_jax(tmp_path):
    vf, mf, merges = _tiny_bpe_files(str(tmp_path))
    ours, ref = CLIPTokenizer(vf, mf, context_length=16), JaxCLIPTokenizer(vf, mf, context_length=16)
    assert ours.vocab_size == ref.vocab_size
    for text in NON_ASCII + ["Hello, world!", "hello" * 20]:
        assert ours.encode(text) == ref.encode(text), text
    got, want = ours(NON_ASCII), ref(NON_ASCII)
    for k in want:  # fixed context, truncation keeping EOT, the mask from the lengths
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    obpe = tmp_path / "bpe_simple_vocab_16e6.txt.gz"
    with gzip.open(obpe, "wt", encoding="utf-8") as f:
        f.write("banner\n" + "\n".join(" ".join(m) for m in merges) + "\n")
    a, b = CLIPTokenizer.from_openai_bpe(str(obpe)), JaxCLIPTokenizer.from_openai_bpe(str(obpe))
    assert a.encoder == b.encoder and a.bpe_ranks == b.bpe_ranks
    assert [a.encode(t) for t in NON_ASCII] == [b.encode(t) for t in NON_ASCII]


# ----------------------------------------------------------------- towers


@pytest.mark.parametrize("hidden_act", ["quick_gelu", "gelu"])
@pytest.mark.parametrize("pooling", ["hf_eos", "openai_argmax"])
def test_text_tower_matches_jax(rng, hidden_act, pooling):
    hf = _hf_text(hidden_act=hidden_act)
    report = []
    sd = clip_text_state_dict(hf.state_dict(), report)
    assert report == []
    eos = TEXT["eos_token_id"] if pooling == "hf_eos" else None
    geometry = clip_text_geometry(sd)
    assert geometry == dict(vocab_size=99, context_length=16, width=32, layers=2, embed_dim=32)
    ours = CLIPTextEncoder(**geometry, heads=4, hidden_act=hidden_act, eos_token_id=eos)
    ours.load_state_dict(sd, strict=True)
    ids = _text_ids(rng)
    jm = JaxCLIPTextEncoder(vocab_size=99, context_length=16, width=32, layers=2, heads=4,
                            embed_dim=32, hidden_act=hidden_act, eos_token_id=eos)
    ref = np.asarray(jm.apply({"params": clip_text_torch_to_params(hf.state_dict())},
                              jnp.asarray(ids.astype(np.int32))))
    before = multihead_attention.causal_calls
    with torch.no_grad():
        out = ours(torch.from_numpy(ids)).numpy()
        hf_out = hf(input_ids=torch.from_numpy(ids)).text_embeds.numpy()
    assert multihead_attention.causal_calls - before == 2  # one per block, plain
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(out, hf_out, atol=TOL, rtol=1e-4)


@pytest.mark.parametrize("hidden_act", ["quick_gelu", "gelu"])
def test_vision_tower_matches_jax(rng, hidden_act):
    hf = _hf_vision(hidden_act)
    report = []
    sd = clip_vision_state_dict(hf.state_dict(), report)
    assert report == []
    ours = CLIPImageEncoder(**VISION_KW, image_size=32, hidden_act=hidden_act)
    ours.load_state_dict(sd, strict=True)
    imgs = rng.randn(3, 32, 32, 3).astype(np.float32)
    ref = np.asarray(JaxCLIPImageEncoder(**VISION_KW, hidden_act=hidden_act).apply(
        {"params": clip_vision_torch_to_params(hf.state_dict())}, jnp.asarray(imgs)))
    with torch.no_grad():
        out = ours(torch.from_numpy(imgs)).numpy()
        hf_out = hf(pixel_values=torch.from_numpy(imgs.transpose(0, 3, 1, 2))).image_embeds
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(out, hf_out.numpy(), atol=TOL, rtol=1e-4)


def test_whole_clipmodel_state_dict_feeds_both_towers():
    """A CLIPModel state_dict: each converter takes its tower and skips the
    other's keys and logit_scale; an unknown key is reported."""
    torch.manual_seed(0)
    cfg = CLIPConfig(text_config=TEXT, vision_config=VISION, projection_dim=32)
    sd = CLIPModel(cfg).eval().state_dict()
    sd["vision_model.encoder.layers.0.extra.weight"] = torch.zeros(2)
    text_report, vision_report = [], []
    text = clip_text_state_dict(sd, text_report)
    vision = clip_vision_state_dict(sd, vision_report)
    assert text_report == []
    assert vision_report == ["unrecognized clip key: vision_model.encoder.layers.0.extra.weight"]
    CLIPTextEncoder(**clip_text_geometry(text), heads=4).load_state_dict(text, strict=True)
    CLIPImageEncoder(**VISION_KW, image_size=32).load_state_dict(vision, strict=True)
    np.testing.assert_array_equal(text["proj.weight"].numpy(), sd["text_projection.weight"])
    np.testing.assert_array_equal(vision["proj.weight"].numpy(), sd["visual_projection.weight"])


def test_baseline_clip_mode_matches_jax(rng):
    """RawFeatureBaseline(text_tower=...): cosine of raw features and the CLIP
    text tower's embeddings, against JAX's on the same weights."""
    hf = _hf_text()
    E = TEXT["projection_dim"]
    kw = dict(num_encoder_layers=0, num_joint_layers=1, video_embed_dim=E, sim="cos",
              use_alignability_head=False, random_pos_start=False)
    tower = dict(vocab_size=99, context_length=16, width=32, layers=2, heads=4, embed_dim=E,
                 eos_token_id=TEXT["eos_token_id"])
    jm = JaxRawFeatureBaseline(JaxModelConfig(**kw), vocab_size=99, use_visual_proj=False,
                               text_tower=lambda: JaxCLIPTextEncoder(**tower))
    ids = _text_ids(rng, B=8).reshape(2, 4, 12).astype(np.int32)
    video = rng.randn(2, 6, E).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(video), jnp.asarray(ids))["params"]
    params, _ = neq_merge(jax.device_get(params),
                          {"lang_model": clip_text_torch_to_params(hf.state_dict())})
    ref = jax.device_get(jm.apply({"params": params}, jnp.asarray(video), jnp.asarray(ids)))
    tm = RawFeatureBaseline(ModelConfig(**kw), vocab_size=99, use_visual_proj=False,
                            text_tower=lambda: CLIPTextEncoder(**tower))
    tm.lang_model.load_state_dict(clip_text_state_dict(hf.state_dict()), strict=True)
    assert tm.dtype == torch.float32
    with torch.no_grad():
        out = tm(torch.from_numpy(video), torch.from_numpy(ids).long())
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=TOL, rtol=TOL,
                                   err_msg=k)


# -------------------------------------------------------------- eval CLI


@pytest.fixture(scope="module")
def clip_files(tmp_path_factory):
    """A tiny BPE vocab (HF files and OpenAI's .gz), an HF CLIP text
    checkpoint whose vocab is the tokenizer's (EOT the highest id), and an
    HTM-Align and a YC2 corpus of CLIP-width features."""
    root = tmp_path_factory.mktemp("clip_cli")
    vf, mf, merges = _tiny_bpe_files(str(root))
    with gzip.open(root / "bpe.txt.gz", "wt", encoding="utf-8") as f:
        f.write("banner\n" + "\n".join(" ".join(m) for m in merges) + "\n")
    tok = CLIPTokenizer(vf, mf, context_length=16)
    hf = _hf_text(vocab_size=tok.vocab_size, bos_token_id=tok.sot_id, eos_token_id=tok.eot_id,
                  pad_token_id=tok.eot_id)
    torch.save(hf.state_dict(), root / "clip_text.pth")
    rng = np.random.RandomState(0)
    E = TEXT["projection_dim"]
    (root / "features").mkdir()
    words = ["hello", "world", "café", "x²", "½", "don't", "中文", "pan!"]
    anno = {}
    for v in range(3):
        vlen = int(rng.randint(70, 100))
        np.save(root / "features" / f"clip{v}.npy", (rng.randn(vlen, E) * 0.5).astype(np.float32))
        sents, t = [], 2.0
        for _ in range(5):
            end = min(t + float(rng.randint(4, 10)), vlen - 1.0)
            sents.append([int(rng.rand() < 0.5), t, end, " ".join(rng.choice(words, 4))])
            t = end + 2.0
        sents[0][0], sents[-1][0] = 1, 0
        anno[f"clip{v}"] = sents
    (root / "htm_align.json").write_text(json.dumps(anno))
    (root / "yc2").mkdir()
    _write_yc2(root / "yc2", rng)
    return root


def _clip_args(root, task, tokenizer):
    data = (["--features", str(root / "features"), "--anno", str(root / "htm_align.json")]
            if task == "align" else
            ["--features", str(root / "yc2" / "features"), "--anno", str(root / "yc2/anno.json"),
             "--num_clips", "4", "--seq_len", "32"])
    tok = (["--clip_bpe", str(root / "bpe.txt.gz")] if tokenizer == "openai_bpe" else
           ["--clip_vocab", str(root / "vocab.json"), "--clip_merges", str(root / "merges.txt")])
    return ["--task", task, *data, "--clip_text_ckpt", str(root / "clip_text.pth"), *tok,
            "--clip_context", "16", "--clip_text_heads", "4", "--clip_hidden_act", "quick_gelu",
            "--baseline_sim", "cos", "--video_embed_dim", str(TEXT["projection_dim"])]


@pytest.mark.parametrize("task,tokenizer", [("align", "hf_files"), ("align", "openai_bpe"),
                                            ("retrieval", "hf_files")])
def test_eval_cli_clip_baseline_equals_jax_cli(clip_files, task, tokenizer, capsys):
    from temporalalignnet_torch.eval.cli import main as eval_main

    args = _clip_args(clip_files, task, tokenizer)
    ours = eval_main(args + ["--device", "cpu"])
    printed = capsys.readouterr().out.splitlines()
    assert json.loads(printed[-1]) == ours and not [l for l in printed if "[baseline]" in l]
    ref = jax_eval_main(args + ["--f32"])
    assert set(ours) == set(ref)
    for k in ref:
        assert ours[k] == pytest.approx(ref[k], abs=1e-9), k


# ------------------------------------------------------------- extractor


def test_make_clip_encoder_matches_jax(rng):
    """uint8 frames -> per-frame features averaged per clip, unit norm."""
    hf = _hf_vision()
    frames = (rng.rand(2, 3, 32, 32, 3) * 255).astype(np.uint8)
    ours = make_clip_encoder(clip_vision_state_dict(hf.state_dict()), device="cpu",
                             image_size=32, **VISION_KW)(frames)
    ref = np.asarray(jax_make_clip_encoder(clip_vision_torch_to_params(hf.state_dict()),
                                           **VISION_KW)(frames))
    assert ours.shape == (2, 32) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(np.linalg.norm(ours, axis=-1), 1.0, atol=1e-5)
    raw = make_clip_encoder(clip_vision_state_dict(hf.state_dict()), device="cpu",
                            normalize=False, image_size=32, **VISION_KW)(frames)
    np.testing.assert_allclose(ours, raw / np.linalg.norm(raw, axis=-1, keepdims=True),
                               atol=1e-6)


def test_encoders_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_clip_encoder({}, image_size=32, **VISION_KW)
