"""The port's TANWithText against the JAX package's on the same weights
(moved through state_dict_from_jax) and the same numpy inputs, f32 on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_fixtures import VOCAB, WORDS, jax_model, model_pair, port_model, to_torch
from temporalalignnet_torch.checkpoint import load_reference_checkpoint, state_dict_from_jax
from temporalalignnet_torch.models.posenc import linear_interpolate, sine_position_embedding
from temporalalignnet_tpu.checkpoint import params_to_torch, save_reference_checkpoint
from temporalalignnet_tpu.models import posenc as jax_posenc
from temporalalignnet_tpu.models.net import TANWithText as JaxTANWithText

torch.set_num_threads(2)

TOL = 2e-5  # the bar of tests/test_checkpoint.py::test_full_forward_parity


def _ids(rng, *lead):
    ids = rng.randint(1, VOCAB + 1, (*lead, WORDS)).astype(np.int32)
    ids[..., WORDS // 2:] *= rng.rand(*lead, 1) < 0.5  # ragged sentence lengths
    ids.reshape(-1, WORDS)[1] = 0  # an all-pad sentence keeps every position
    return ids


def _encode(jm, params, tm, ids):
    mask = (ids != 0).astype(np.int32)
    ours = tm.encode_text(to_torch(ids).long(), to_torch(mask)).detach().numpy()
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask),
                              method=JaxTANWithText.encode_text))
    return ours, ref


def test_state_dict_from_jax_is_params_to_torch(rng):
    _, params = jax_model(use_alignability_head=True)
    ours = state_dict_from_jax(params)
    ref = params_to_torch(params)
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k].numpy(), ref[k], err_msg=k)


def test_encode_text(rng):
    jm, params, tm = model_pair()
    ours, ref = _encode(jm, params, tm, _ids(rng, 3, 5))
    assert ours.shape == (3, 5, 512)
    np.testing.assert_allclose(ours, ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("use_head", [True, False])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_text_visual_sims_every_output_and_layer(rng, use_pallas, use_head):
    jm, params = jax_model(use_pallas=use_pallas, use_alignability_head=use_head)
    tm = port_model(params, use_alignability_head=use_head)
    B, T, N = 3, 24, 6
    video = rng.randn(B, T, 32).astype(np.float32)
    text = rng.randn(B, N, 512).astype(np.float32)
    vpad = np.zeros((B, T), bool)
    vpad[1, 17:] = True
    tpad = np.zeros((B, N), bool)
    tpad[0, 4:] = True
    tpad[2, 1:] = True
    ref = jm.apply({"params": params}, jnp.asarray(video), jnp.asarray(text),
                   jnp.asarray(vpad), jnp.asarray(tpad), method=JaxTANWithText.text_visual_sims)
    with torch.no_grad():
        ours = tm.text_visual_sims(to_torch(video), to_torch(text), to_torch(vpad),
                                   to_torch(tpad))
    assert set(ours) == set(ref)
    for key in ref:
        assert ours[key].shape == ref[key].shape, key
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(ref[key]), atol=TOL, rtol=0,
                                   err_msg=key)


def test_interpolated_pos_enc_with_effective_len(rng):
    """The global method's path: pos-enc interpolated from 32 slots onto each
    video's true length inside a padded bucket.  The port takes one
    effective_len per batch row; the JAX model one per call."""
    jm, params, tm = model_pair(use_alignability_head=True)
    T, N = 64, 8
    vlens = np.array([64, 45], np.int32)
    video = rng.randn(2, T, 32).astype(np.float32)
    text = rng.randn(2, N, 512).astype(np.float32)
    vpad = np.arange(T)[None] >= vlens[:, None]
    with torch.no_grad():
        ours = tm.text_visual_sims(to_torch(video), to_torch(text), to_torch(vpad),
                                   interpolate_from=32, effective_len=to_torch(vlens))
    for b in range(2):
        ref = jm.apply({"params": params}, jnp.asarray(video[b:b + 1]),
                       jnp.asarray(text[b:b + 1]), jnp.asarray(vpad[b:b + 1]),
                       interpolate_from=32, effective_len=jnp.asarray(vlens[b]),
                       method=JaxTANWithText.text_visual_sims)
        for key in ref:
            np.testing.assert_allclose(ours[key][b:b + 1].numpy(), np.asarray(ref[key]),
                                       atol=TOL, rtol=0, err_msg=f"{key} row {b}")


@pytest.mark.parametrize("eff", [None, 20, 37])
def test_posenc_matches_jax(rng, eff):
    table = rng.randn(40, 16).astype(np.float32)
    ours = linear_interpolate(to_torch(table), 48, None if eff is None else torch.tensor(eff))
    ref = jax_posenc.linear_interpolate(jnp.asarray(table), 48, eff)
    # one f32 ulp of a source coordinate near 40 is 4e-6, times table steps of ~3
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=TOL, rtol=0)
    np.testing.assert_allclose(sine_position_embedding(64, 100).numpy(),
                               np.asarray(jax_posenc.sine_position_embedding(64, 100)),
                               atol=1e-5, rtol=0)


def test_strict_load_of_a_twin_reference_checkpoint(tmp_path, rng):
    """A Stage-2 twin .pth.tar written by the JAX exporter (online.* / target.*
    plus the bert.* alias) loads strict into the port, keeping the online
    half; the reference's unused keys are dropped with a report."""
    jm, params = jax_model(use_alignability_head=True)
    ema = {k: v for k, v in params.items()}
    ema["aligner"] = dict(params["aligner"], video_pre_proj={
        "kernel": params["aligner"]["video_pre_proj"]["kernel"] + 1.0})
    path = str(tmp_path / "twin.pth.tar")
    save_reference_checkpoint(path, params, ema_params=ema)
    ckpt = torch.load(path, weights_only=True)
    ckpt["state_dict"]["online.mlp.weight"] = torch.zeros(4, 4)
    ckpt["state_dict"]["online.logit_scale"] = torch.zeros(())
    # the lang_model.* spelling of the language model is accepted too
    sd = ckpt["state_dict"]
    for k in [k for k in sd if k.startswith("bert.")]:
        sd["lang_model." + k[len("bert."):]] = sd.pop(k)
    torch.save(ckpt, path)

    tm = port_model(params, use_alignability_head=True)
    with torch.no_grad():
        for p in tm.parameters():
            p.zero_()
    report = load_reference_checkpoint(path, tm, verbose=False)
    assert any("mlp.weight" in r for r in report) and any("logit_scale" in r for r in report)
    assert any("target" in r for r in report)
    ours = tm.state_dict()
    ref = state_dict_from_jax(params)
    assert set(ours) == set(ref)
    for k in ref:
        torch.testing.assert_close(ours[k], ref[k], rtol=0, atol=0, msg=k)
    ours_e, ref_e = _encode(jm, params, tm, _ids(rng, 2, 3))
    np.testing.assert_allclose(ours_e, ref_e, atol=TOL, rtol=0)
