"""The port's agreement self-labelling (losses/agreement.py) against the JAX
package's, f32 on the CPU, on the same numpy inputs.

The targets are discrete: an argmax over window scores and ``>=`` gates
against quantiles.  Where two windows' scores (or a score and its gate) lie
within rounding of each other the two packages may legitimately choose
differently; every differing entry must lie in a batch element holding such
a near-tie, and the number of them is printed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_fixtures import to_torch
from temporalalignnet_torch.core.config import LossConfig
from temporalalignnet_torch.losses import agreement as ours
from temporalalignnet_torch.losses.masked import masked_quantile
from temporalalignnet_tpu.core.config import LossConfig as JaxLossConfig
from temporalalignnet_tpu.losses import agreement as ref

torch.set_num_threads(2)

B, S, T, N = 4, 2, 32, 6
METRIC_TOL = 1e-6
# a decision whose two sides differ, but by less than this (relative), is a
# near-tie; an exact tie resolves the same way in both (the first index)
NEAR_TIE = 1e-6


def _spans(rng, B=B, N=N, T=T):
    """Binary ASR targets [B, N, T] of durations 1..T, the last sentence of
    each video and all but two of the last video's padded."""
    raw = np.zeros((B, N, T), np.float32)
    for b in range(B):
        for n in range(N):
            d = int(rng.choice([1, 2, 3, 5, 8, T]))
            s = int(rng.randint(0, T))
            raw[b, n, s:s + d] = 1.0
    text_pad = np.zeros((B, N), bool)
    text_pad[:, -1] = True
    text_pad[-1, 2:] = True
    raw[text_pad] = 0.0
    return raw, text_pad


def _inputs(seed):
    """Joint and dual same-video logits that mostly agree (a shared part plus
    noise), padded video positions, and the spans above."""
    rng = np.random.RandomState(seed)
    shared = 3.0 * rng.randn(B, S, T, N)
    joint = (shared + rng.randn(B, S, T, N)).astype(np.float32)
    dual = (shared + rng.randn(B, S, T, N)).astype(np.float32)
    video_pad = np.zeros((B, T), bool)
    video_pad[1, 24:] = True
    video_pad[2, 20:] = True
    raw, text_pad = _spans(rng)
    return joint, dual, video_pad, text_pad, raw


def test_circulant_last_equals_jax(rng):
    x = rng.randn(3, 5, T).astype(np.float32)
    np.testing.assert_array_equal(ours.circulant_last(to_torch(x)).numpy(),
                                  np.asarray(ref.circulant_last(jnp.asarray(x))))


def test_window_kernel_bank_equals_jax(rng):
    raw, text_pad = _spans(rng)
    np.testing.assert_array_equal(
        ours._window_kernel_bank(to_torch(raw), to_torch(text_pad)).numpy(),
        np.asarray(ref._window_kernel_bank(jnp.asarray(raw), jnp.asarray(text_pad))))


def _near_tied_videos(joint, dual, video_pad, text_pad, raw, cfg):
    """[B] bool: the videos with a decision of the port's within NEAR_TIE of
    flipping: the two best windows of a sentence, or a sentence's best mean
    logit and its confidence quantile."""
    tp = to_torch(text_pad)
    C = ours._window_kernel_bank(to_torch(raw), tp)
    tied = torch.zeros(B, N, dtype=torch.bool)
    for x in (joint, dual):
        x = ours.pad_fill(to_torch(x), to_torch(video_pad), tp, cfg.mask_value)
        top2 = ours.window_scores(x, C, cfg.temperature).topk(2, dim=-1).values
        gap = top2[..., 0] - top2[..., 1]
        tied |= (gap > 0) & (gap <= NEAR_TIE * top2[..., 0])
        _, _, max_logits = ours._best_window_circulant(x, C, cfg.temperature)
        gap = (max_logits - masked_quantile(max_logits, ~tp, cfg.confidence_quantile)).abs()
        tied |= (gap > 0) & (gap <= NEAR_TIE * (1.0 + max_logits.abs()))
    return (tied & ~tp).any(-1).numpy()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("atype", ["i", "u", "keep", "keep-joint"])
def test_agreement_self_labelling_matches_jax(atype, seed):
    joint, dual, video_pad, text_pad, raw = _inputs(seed)
    cfg = LossConfig(learn_agreement=True, temporal_agreement_type=atype)
    jcfg = JaxLossConfig(learn_agreement=True, temporal_agreement_type=atype)
    want, want_m = ref.agreement_self_labelling(*map(jnp.asarray, (joint, dual, video_pad,
                                                                   text_pad, raw)), jcfg)
    got, got_m = ours.agreement_self_labelling(*map(to_torch, (joint, dual, video_pad,
                                                               text_pad, raw)), cfg)
    want = np.asarray(want)
    assert got.dtype == torch.float32 and got.shape == want.shape == (B, T, N)
    differ = got.numpy() != want
    tied = _near_tied_videos(joint, dual, video_pad, text_pad, raw, cfg)
    print(f"{atype} seed {seed}: {int(differ.sum())} target entries differ, "
          f"{int(tied.sum())} videos hold a near-tie")
    assert not differ[~tied].any(), "targets differ away from any near-tie"
    assert set(got_m) == set(want_m)
    for k in want_m:
        np.testing.assert_allclose(got_m[k].item(), float(want_m[k]), atol=METRIC_TOL,
                                   rtol=0, err_msg=k)
    # the inputs exercise the self-labels, not only the fallback to the spans
    if atype in ("keep", "keep-joint"):
        assert not np.array_equal(got.numpy(), raw.transpose(0, 2, 1))


def test_cumsum_path_equals_circulant_path():
    joint, _, video_pad, text_pad, raw = _inputs(2)
    x = to_torch(joint).masked_fill(to_torch(video_pad)[:, None, :, None], -6.0e4)
    tp = to_torch(text_pad)
    C = ours._window_kernel_bank(to_torch(raw), tp)
    tgt_c, prob_c, logit_c = ours._best_window_circulant(x, C, 0.07)
    durations = to_torch(raw).sum(-1).clamp(min=1.0).masked_fill(tp, 0.0)
    tgt_s, prob_s, logit_s = ours._best_window_cumsum(x, durations, 0.07)
    torch.testing.assert_close(prob_s, prob_c, atol=1e-6, rtol=0)
    # the mean logits sum padded positions' -6e4 in another order
    torch.testing.assert_close(logit_s, logit_c, atol=1e-5, rtol=1e-6)
    torch.testing.assert_close(tgt_s, tgt_c, atol=0, rtol=0)
