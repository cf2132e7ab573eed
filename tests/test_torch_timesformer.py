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
