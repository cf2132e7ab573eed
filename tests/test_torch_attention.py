"""The port's attention against the JAX package's: attention_reference vs the
Pallas kernel (interpret mode on the CPU, as tests/test_pallas.py runs it) and
the XLA path.  The device dispatch and the Hopper kernel are held in
tests/test_torch_kernels.py, which imports no JAX so it also runs on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_fixtures import to_torch
from temporalalignnet_torch.ops.attention import attention_reference
from temporalalignnet_tpu.ops.attention import _attention_xla
from temporalalignnet_tpu.ops.pallas_attention import fused_attention

torch.set_num_threads(2)

TOL = 1e-5  # f32 on the CPU: only the order of the sums differs


def _inputs(rng, B, H, S, D, masked):
    q, k, v = (rng.randn(B, H, S, D).astype(np.float32) for _ in range(3))
    mask = None
    if masked:
        mask = rng.rand(B, S) < 0.3
        mask[:, 0] = False
        mask[-1] = True  # a fully padded row: finite, averages V uniformly
    return q, k, v, mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("S", [16, 24, 40])
def test_reference_matches_jax(rng, S, masked):
    q, k, v, mask = _inputs(rng, 3, 4, S, 16, masked)
    jmask = None if mask is None else jnp.asarray(mask)
    ours = attention_reference(to_torch(q), to_torch(k), to_torch(v),
                               None if mask is None else to_torch(mask)).numpy()
    pallas = np.asarray(fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jmask))
    xla = np.asarray(_attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jmask))
    np.testing.assert_allclose(ours, pallas, atol=TOL, rtol=0)
    np.testing.assert_allclose(ours, xla, atol=TOL, rtol=0)
    if masked:  # the fully padded row is the mean of V over all keys
        np.testing.assert_allclose(ours[-1], np.broadcast_to(v[-1].mean(1, keepdims=True),
                                                             ours[-1].shape), atol=TOL)


def test_causal_reference_matches_jax(rng):
    q, k, v, mask = _inputs(rng, 2, 4, 24, 16, True)
    mask[-1] = False  # with a causal mask a fully padded row has no common meaning
    ours = attention_reference(to_torch(q), to_torch(k), to_torch(v), to_torch(mask),
                               causal=True).numpy()
    ref = np.asarray(_attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    jnp.asarray(mask), causal=True))
    np.testing.assert_allclose(ours, ref, atol=TOL, rtol=0)


def test_reference_bf16_keeps_dtype_and_matches_jax(rng):
    q, k, v, mask = _inputs(rng, 2, 4, 24, 16, True)
    tq, tk, tv = (to_torch(x).bfloat16() for x in (q, k, v))
    ours = attention_reference(tq, tk, tv, to_torch(mask))
    assert ours.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (tq, tk, tv))
    pallas = np.asarray(fused_attention(jq, jk, jv, jnp.asarray(mask)), np.float32)
    # both round P and the output to bf16; the exp/sum orders differ
    np.testing.assert_allclose(ours.float().numpy(), pallas, atol=2e-2)
