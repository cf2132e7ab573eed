"""The port's MIL-NCE plain version (ops/milnce.py::milnce_reference, what a
CPU tensor takes) against the JAX package's fused_milnce_elements, whose
Pallas kernels and custom VJP run in interpret mode on the CPU as
tests/test_fused_milnce.py runs them.  The Hopper kernels are held against
the plain version on the card in tests/test_torch_kernels.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_fixtures import to_torch
from temporalalignnet_torch.ops.milnce import fused_milnce_elements, milnce_reference
from temporalalignnet_tpu.ops.pallas_milnce import fused_milnce_elements as jax_milnce

torch.set_num_threads(2)

MV = -6.0e4
INV_TEMP = 1.0 / 0.07
FWD_TOL = 2e-5  # tests/test_fused_milnce.py:49
GRAD_TOL = 5e-4  # tests/test_fused_milnce.py:85 (interpret mode)


def _problem(rng, S=3, R=16, K=12, C=32, shared=False):
    """R a multiple of 8: the JAX package takes its kernel only then."""
    v = rng.randn(S, R, C).astype(np.float32)
    t = rng.randn(K, C).astype(np.float32) if shared else rng.randn(S, K, C).astype(np.float32)
    cv = rng.rand(K) < 0.8  # padded columns
    pm = (rng.rand(R, K) < 0.2) & cv[None]
    pm[3] = False  # a row with no positive
    return v, t, pm, cv


@pytest.mark.parametrize("shared", [False, True])
def test_forward_matches_jax(rng, shared):
    v, t, pm, cv = _problem(rng, shared=shared)
    ours = milnce_reference(to_torch(v), to_torch(t), to_torch(pm), to_torch(cv), MV, INV_TEMP)
    ref = jax_milnce(jnp.asarray(v), jnp.asarray(t), jnp.asarray(pm), jnp.asarray(cv), MV,
                     INV_TEMP)
    for a, b in zip(ours, ref):
        assert np.isfinite(a.numpy()).all()
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=FWD_TOL, rtol=1e-5)


@pytest.mark.parametrize("shared", [False, True])
def test_grads_match_jax_custom_vjp(rng, shared):
    """The plain version's autograd against the JAX backward kernel: the
    zero-gradient routing of a row with no positive, and the sum of the
    shared text's gradient over the layers."""
    v, t, pm, cv = _problem(rng, shared=shared)
    w1, w2 = rng.randn(3, 16).astype(np.float32), rng.randn(3, 12).astype(np.float32)

    def jax_loss(v, t):
        a, b = jax_milnce(v, t, jnp.asarray(pm), jnp.asarray(cv), MV, INV_TEMP)
        return jnp.sum(a * w1) + jnp.sum(b * w2)

    ref = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(v), jnp.asarray(t))
    tv, tt = to_torch(v).requires_grad_(), to_torch(t).requires_grad_()
    a, b = fused_milnce_elements(tv, tt, to_torch(pm), to_torch(cv), MV, INV_TEMP)
    ((a * to_torch(w1)).sum() + (b * to_torch(w2)).sum()).backward()
    for ours, theirs, name in ((tv.grad, ref[0], "dv"), (tt.grad, ref[1], "dt")):
        assert ours.shape == theirs.shape, name
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=GRAD_TOL,
                                   rtol=6 * GRAD_TOL, err_msg=name)


def test_bf16_features_give_f32_elements(rng):
    v, t, pm, cv = _problem(rng)
    tv, tt = (to_torch(x).bfloat16() for x in (v, t))
    a, b = fused_milnce_elements(tv, tt, to_torch(pm), to_torch(cv), MV, INV_TEMP)
    assert a.dtype == b.dtype == torch.float32
    ref = milnce_reference(tv.float(), tt.float(), to_torch(pm), to_torch(cv), MV, INV_TEMP)
    torch.testing.assert_close(a, ref[0], rtol=0, atol=0)
