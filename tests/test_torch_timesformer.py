"""The port's TimeSformer tower against the JAX package's, f32 on the CPU, on
HF TimesformerModel weights (each package's converter, and transformers'
own module): the sequence and the class feature, the divided space-time
routing included; the classification checkpoint and unknown keys; and
make_timesformer_encoder against JAX's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from transformers import TimesformerConfig, TimesformerForVideoClassification, TimesformerModel

from temporalalignnet_torch.checkpoint import timesformer_state_dict
from temporalalignnet_torch.models.timesformer import TimeSformerEncoder
from temporalalignnet_torch.ops.attention import attention_reference
from temporalalignnet_torch.tools.extract_features import make_timesformer_encoder
from temporalalignnet_tpu.checkpoint import timesformer_torch_to_params
from temporalalignnet_tpu.models import TimeSformerEncoder as JaxTimeSformerEncoder
from temporalalignnet_tpu.tools.extract_features import (
    make_timesformer_encoder as jax_make_timesformer_encoder)

torch.set_num_threads(2)

TOL = 2e-5
TINY = dict(image_size=32, patch_size=16, num_channels=3, num_frames=2, hidden_size=32,
            num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
            attention_type="divided_space_time", hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0, drop_path_rate=0.0)
KW = dict(width=32, layers=2, heads=4, patch_size=16, frames=2, mlp_width=64)


def _hf(seed=0, cls=TimesformerModel, **over):
    torch.manual_seed(seed)
    model = cls(TimesformerConfig(**TINY, **over)).eval()
    emb = model.embeddings if cls is TimesformerModel else model.timesformer.embeddings
    with torch.no_grad():  # zero-init tables would hide a layout error
        for p in (emb.cls_token, emb.position_embeddings, emb.time_embeddings):
            p.normal_(0.0, 0.02)
    return model


def test_tower_matches_jax(rng, monkeypatch):
    hf = _hf()
    report = []
    sd = timesformer_state_dict(hf.state_dict(), report)
    assert report == []
    ours = TimeSformerEncoder(**KW, image_size=32)
    ours.load_state_dict(sd, strict=True)
    clip = rng.randn(3, 2, 32, 32, 3).astype(np.float32)
    jm = JaxTimeSformerEncoder(**KW)
    params = timesformer_torch_to_params(hf.state_dict())
    ref_seq = np.asarray(jm.apply({"params": params}, jnp.asarray(clip), return_cls=False))
    ref_cls = np.asarray(jm.apply({"params": params}, jnp.asarray(clip)))
    shapes = []

    def spy(q, k, v, mask=None, causal=False):
        shapes.append(tuple(q.shape))
        return attention_reference(q, k, v, mask, causal)

    monkeypatch.setattr("temporalalignnet_torch.ops.attention.attention_reference", spy)
    with torch.no_grad():
        seq = ours(torch.from_numpy(clip), return_cls=False).numpy()
        cls = ours(torch.from_numpy(clip)).numpy()
        hf_seq = hf(pixel_values=torch.from_numpy(clip.transpose(0, 1, 4, 2, 3)))
    assert seq.shape == ref_seq.shape == (3, 1 + 4 * 2, 32)
    np.testing.assert_allclose(seq, ref_seq, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(cls, ref_cls, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(seq, hf_seq.last_hidden_state.numpy(), atol=TOL, rtol=1e-4)
    # per layer: temporal [B P, H, T, hd], then spatial [B T, H, 1 + P, hd]
    assert shapes[:4] == [(12, 4, 2, 8), (6, 4, 5, 8)] * 2


def test_classification_state_dict_and_unknown_keys():
    """A TimesformerForVideoClassification state_dict: the timesformer. prefix
    stripped, the classifier skipped; keys outside the layout are reported."""
    hf = _hf(cls=TimesformerForVideoClassification, num_labels=5)
    report = []
    sd = timesformer_state_dict(hf.state_dict(), report)
    assert report == [] and sd["cls_token"].shape == (32,)
    TimeSformerEncoder(**KW, image_size=32).load_state_dict(sd, strict=True)
    report = []
    out = timesformer_state_dict(
        {"encoder.layer.0.attention.attention.query.weight": torch.zeros(4, 4),
         "encoder.layer.0.attention.relative_position": torch.zeros(4)}, report)
    assert out == {} and len(report) == 2
    assert all(r.startswith("unrecognized timesformer key") for r in report)


def test_make_timesformer_encoder_matches_jax(rng):
    hf = _hf(seed=1)
    clips = (rng.rand(2, 2, 32, 32, 3) * 255).astype(np.uint8)
    ours = make_timesformer_encoder(timesformer_state_dict(hf.state_dict()), device="cpu",
                                    image_size=32, **KW)(clips)
    ref = np.asarray(jax_make_timesformer_encoder(timesformer_torch_to_params(hf.state_dict()),
                                                  **KW)(clips))
    assert ours.shape == (2, 32) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, atol=TOL, rtol=TOL)
    with pytest.raises(ValueError, match="expected 2 frames"):
        make_timesformer_encoder(timesformer_state_dict(hf.state_dict()), device="cpu",
                                 image_size=32, **KW)(clips[:, :1])


def test_bf16_token_sequence_before_the_first_block_equals_jax(rng, monkeypatch):
    """In bf16 the class token is cls_token + position_embedding[0] added in
    f32 and rounded once, as JAX adds them: the whole sequence that enters the
    first block (class token, patches with their position and time tables)
    equals JAX's to the bit.  The patch tokens are made exact in bf16 (pixels,
    weights and their tables of few bits), so that the two frameworks' other
    roundings cannot differ; the class token and its position are random
    normals, which the old order of rounding (each to bf16, then the sum)
    moves."""
    import temporalalignnet_tpu.models.timesformer as jax_tsf

    hf = _hf(seed=2)
    eighths = lambda shape, lo=-8, hi=9: torch.from_numpy(rng.randint(lo, hi, shape) / 8.0)
    with torch.no_grad():  # every patch token a multiple of 1/8 below 8: exact in bf16
        emb = hf.embeddings
        conv = emb.patch_embeddings.projection
        conv.weight.copy_(eighths(conv.weight.shape, -1, 2) * (rng.rand(*conv.weight.shape) < 0.02))
        conv.bias.copy_(eighths(conv.bias.shape, -4, 5))
        emb.position_embeddings[:, 1:] = eighths(emb.position_embeddings[:, 1:].shape)
        emb.time_embeddings.copy_(eighths(emb.time_embeddings.shape))
    clip = rng.randint(-1, 2, (2, 2, 32, 32, 3)).astype(np.float32)
    ours = TimeSformerEncoder(**KW, image_size=32)
    ours.load_state_dict(timesformer_state_dict(hf.state_dict()), strict=True)
    seen = []
    ours.layers[0].register_forward_pre_hook(lambda mod, args: seen.append(args[0]))
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        ours(torch.from_numpy(clip))

    class Spy:  # the JAX module's jnp, recording the sequence it concatenates
        def __getattr__(self, name):
            return getattr(jnp, name)

        def concatenate(self, xs, axis=0):
            out = jnp.concatenate(xs, axis=axis)
            jax_seen.append(np.asarray(out.astype(jnp.float32)))
            return out

    jax_seen = []
    monkeypatch.setattr(jax_tsf, "jnp", Spy())
    jm = JaxTimeSformerEncoder(**KW, dtype=jnp.bfloat16)
    jm.apply({"params": timesformer_torch_to_params(hf.state_dict())}, jnp.asarray(clip))
    seq = seen[0]
    assert seq.dtype == torch.bfloat16 and seq.shape == (2, 1 + 4 * 2, 32)
    np.testing.assert_array_equal(seq.float().numpy(), jax_seen[0])
    # the rounding this order avoids: the two tables rounded to bf16 first
    sd = ours.state_dict()
    old = (sd["cls_token"].bfloat16() + sd["position_embedding"][0].bfloat16()).float().numpy()
    assert (old != jax_seen[0][0, 0]).any()
