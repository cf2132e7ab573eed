"""The port's cross-attention decoder stack (models/transformer.py
TemporalDecoder) against the JAX package's, f32 on the CPU: the same weights
through checkpoint.convert.decoder_state_dict_from_jax, loaded strict, and
the same inputs from a numpy seed.  The taps with and without each padding
mask, the gradients of one scalar of the taps against jax.grad, and the
padded memory's invariance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from temporalalignnet_torch.checkpoint import decoder_state_dict_from_jax
from temporalalignnet_torch.models import TemporalDecoder
from temporalalignnet_torch.ops.attention import cross_attention
from temporalalignnet_tpu.models.transformer import TemporalDecoder as JaxTemporalDecoder

torch.set_num_threads(2)

TAP_TOL = 2e-5  # each tap, max |a - b|
# each gradient (every parameter, x and the memory), max |a - b| over
# max(1, max |b|): the f32 sums of the forward and the backward in two orders
GRAD_TOL = 1e-4
WIDTH, LAYERS, HEADS = 32, 3, 4
B, S, M = 3, 7, 5


def _case(seed=0):
    """(JAX params with every leaf drawn from the seed, so that a LayerNorm
    or a bias mapped to the wrong key shows; x, memory, both masks)."""
    rng = np.random.RandomState(seed)
    dec = JaxTemporalDecoder(width=WIDTH, layers=LAYERS, heads=HEADS)
    shapes = jax.eval_shape(dec.init, jax.random.PRNGKey(0), jnp.zeros((1, S, WIDTH)),
                            jnp.zeros((1, M, WIDTH)))["params"]
    params = jax.tree_util.tree_map(
        lambda s: (rng.randn(*s.shape) * (0.3 if len(s.shape) > 1 else 0.1)).astype(np.float32),
        shapes)
    x = rng.randn(B, S, WIDTH).astype(np.float32)
    mem = rng.randn(B, M, WIDTH).astype(np.float32)
    # ragged padding at the ends, no row fully padded
    tgt_pad = np.arange(S)[None] >= np.array([S, 4, 5])[:, None]
    mem_pad = np.arange(M)[None] >= np.array([M, 2, 3])[:, None]
    return dec, params, x, mem, tgt_pad, mem_pad


def _port(params):
    model = TemporalDecoder(WIDTH, LAYERS, HEADS)
    model.load_state_dict(decoder_state_dict_from_jax(params), strict=True)
    return model


def _masks(which, tgt_pad, mem_pad):
    return (tgt_pad if which in ("tgt", "both") else None,
            mem_pad if which in ("memory", "both") else None)


@pytest.mark.parametrize("which", ["none", "tgt", "memory", "both"])
def test_taps_match_jax(which):
    dec, params, x, mem, tgt_pad, mem_pad = _case()
    tgt, mpad = _masks(which, tgt_pad, mem_pad)
    ref = jax.jit(dec.apply)({"params": params}, jnp.asarray(x), jnp.asarray(mem),
                             None if tgt is None else jnp.asarray(tgt),
                             None if mpad is None else jnp.asarray(mpad))
    model = _port(params)
    calls = cross_attention.calls
    with torch.no_grad():
        ours = model(torch.from_numpy(x), torch.from_numpy(mem),
                     None if tgt is None else torch.from_numpy(tgt),
                     None if mpad is None else torch.from_numpy(mpad))
    assert cross_attention.calls - calls == LAYERS  # plain, once a block
    assert len(ours) == len(ref) == LAYERS
    for a, b in zip(ours, ref):
        assert a.shape == (B, S, WIDTH)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TAP_TOL, rtol=0)


@pytest.mark.parametrize("which", ["none", "both"])
def test_gradients_match_jax_grad(which):
    dec, params, x, mem, tgt_pad, mem_pad = _case(seed=1)
    tgt, mpad = _masks(which, tgt_pad, mem_pad)
    weights = [np.random.RandomState(10 + i).randn(B, S, WIDTH).astype(np.float32)
               for i in range(LAYERS)]

    def jax_scalar(p, xx, mm):
        taps = dec.apply({"params": p}, xx, mm, None if tgt is None else jnp.asarray(tgt),
                         None if mpad is None else jnp.asarray(mpad))
        return sum(jnp.sum(t * w) for t, w in zip(taps, weights))

    g_params, g_x, g_mem = jax.jit(jax.grad(jax_scalar, argnums=(0, 1, 2)))(
        params, jnp.asarray(x), jnp.asarray(mem))
    ref = {**decoder_state_dict_from_jax(jax.device_get(g_params)),
           "x": torch.from_numpy(np.array(g_x)), "memory": torch.from_numpy(np.array(g_mem))}

    model = _port(params)
    xt = torch.from_numpy(x).requires_grad_()
    mt = torch.from_numpy(mem).requires_grad_()
    taps = model(xt, mt, None if tgt is None else torch.from_numpy(tgt),
                 None if mpad is None else torch.from_numpy(mpad))
    sum((t * torch.from_numpy(w)).sum() for t, w in zip(taps, weights)).backward()
    ours = {**{n: p.grad for n, p in model.named_parameters()}, "x": xt.grad, "memory": mt.grad}
    assert set(ours) == set(ref)
    for name, b in ref.items():
        err = (ours[name] - b).abs().max().item() / max(1.0, b.abs().max().item())
        assert err <= GRAD_TOL, (name, err)


def test_padded_memory_does_not_move_the_output():
    """JAX's check (tests/test_misc.py:24-29) in the port: the padded memory
    rows set to 999 leave every tap as it was."""
    _, params, x, mem, tgt_pad, mem_pad = _case(seed=2)
    model = _port(params)
    mem2 = np.where(mem_pad[..., None], np.float32(999.0), mem)
    with torch.no_grad():
        a = model(torch.from_numpy(x), torch.from_numpy(mem), torch.from_numpy(tgt_pad),
                  torch.from_numpy(mem_pad))
        b = model(torch.from_numpy(x), torch.from_numpy(mem2), torch.from_numpy(tgt_pad),
                  torch.from_numpy(mem_pad))
    for ta, tb in zip(a, b):
        np.testing.assert_allclose(ta.numpy(), tb.numpy(), atol=1e-5, rtol=0)


def test_init_weights_draws_from_the_generator():
    a = TemporalDecoder(WIDTH, 2, HEADS).init_weights(torch.Generator().manual_seed(0))
    b = TemporalDecoder(WIDTH, 2, HEADS).init_weights(torch.Generator().manual_seed(0))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q) and torch.isfinite(p).all(), name
        if "ln_" in name:
            assert torch.all(p == (1.0 if name.endswith("weight") else 0.0)), name
    w = a.resblocks[0].attn.in_proj_weight
    assert abs(w.std().item() - WIDTH ** -0.5) < 0.02
