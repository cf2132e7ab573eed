"""CPU emulation of the split-TF32 ("3xTF32") f32 routes of the Hopper
attention kernels, held against the JAX package's Pallas kernels in f32
(Precision.HIGHEST, interpret mode, as tests/test_torch_schedules.py runs
them) at the limits of the card's own checks (chip_smoke.py: ``F32_TOL`` for
the forward, ``GRAD_TOL["float32"]`` per element for the gradients).

- ``tf32`` rounds an f32 word to TF32 by bit arithmetic as the kernels do
  (csrc/tf32x3.cuh::split, the rounding of ``cvt.rna.tf32.f32``: to nearest,
  ties away from zero); ``mm3`` is a product as the kernels compute it: each
  operand split into big = tf32(x) and small = x - big truncated to TF32,
  and per 8-deep k-step (one mma.sync m16n8k8) big·small + small·big summed
  apart, added in f32, then big·big.
- ``f32_fwd_schedule`` follows csrc/mha_fwd_f32.cu: up to S = 128
  mha_fwd_f32_head_kernel (the whole head, its rows zero-filled to the
  staged count, the exact softmax of whole rows in the log2 domain); past it
  mha_fwd_f32_kernel (64-key tiles up to the last 8-key chunk holding a key
  < S, the online softmax, key splits from ``ops.mha_fwd.f32_key_splits``
  over 64-query blocks, merged in split order as mha_fwd_merge_kernel does).
- ``f32_bwd_schedule`` follows csrc/mha_bwd_f32.cu: up to S = 128
  mha_bwd_f32_fused_kernel (exact softmax of whole rows, dQ from dS, then
  dK and dV per 16 keys in 32-query steps from the rows' statistics); past
  it the dq kernel's two online passes over 64-key tiles and the dkdv
  kernel's 32-query steps.
- ``f32_fwd_milnce_schedule`` follows csrc/milnce_fwd.cu's f32 route
  (milnce_fwd_f32_kernel) and milnce_colmerge_kernel: 64-row blocks,
  128-column tiles, sim over all C channels with each 16-channel step's
  products summed apart (``mm_steps``, ``depth=16``); in the log2 domain
  (mask_value where masked, -inf past R or K) each thread's running
  (max, sum) of its 8 columns a tile for each of its rows, merged over the
  quad (lanes t ^ 1, then t ^ 2) and then over the 4 column warps in order;
  each column's (max, sum) over each row warp's 32 rows, the two merged,
  in natural-log terms to the partials, which ``colmerge_schedule`` folds.
  Held against the JAX forward kernels (``_fwd_call``, ``_fwd_call_tiled``)
  and the plain version at ``MILNCE_LSE_F32_TOL`` (``lse_err``).
- ``f32_grad_schedule`` follows csrc/milnce_grad_f32.cu (milnce_dv and
  milnce_dt in f32): 32 outer entries a block, 32-entry inner tiles, the
  channels zero-padded to 32 NQ; sim summed over the four channel quarters
  in quarter order, dsim in f32 with the probabilities re-masked, the
  product over 8-deep k-steps of the inner entries, every short partial sum
  added to its running sum in f32 (``mm_steps``); inner splits from
  ``ops.milnce._wave_splits`` over 32-entry tiles, their partials summed in
  split order; a shared text's gradient summed over the layers in the block.

The planted fault: the same schedules with single-pass TF32 products
(big·big alone) must exceed the limits, which shows the limits tell TF32
from f32 accuracy.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import F32_TOL, GRAD_TOL, MILNCE_LSE_F32_TOL, elem_err, lse_err
from temporalalignnet_torch.ops import milnce
from temporalalignnet_torch.ops import mha_fwd as fwd
from temporalalignnet_torch.ops.attention import NEG_INF
from temporalalignnet_torch.ops.mha_bwd import FUSED_MAX_S
from temporalalignnet_tpu.ops import pallas_attention, pallas_milnce
from test_torch_schedules import _jax_fwd, colmerge_schedule

torch.set_num_threads(2)

LOG2E = math.log2(math.e)
KT, QT = 64, 32  # keys per forward tile; queries per key-side step of the backward
SMS = 132  # an H100 SXM's SMs (the key-split chooser's card)


def tf32(x):
    """The kernels' big part (tf32x3.cuh::split), cvt.rna.tf32.f32 in integer
    arithmetic on the f32 word: the low 13 bits rounded off, ties away from
    zero (the sign sits apart from the magnitude bits)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_rz(x):
    """The kernels' small part: the low 13 bits cut off (toward zero)."""
    return (x.float().contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split(x):
    big = tf32(x)
    return big, tf32_rz(x - big)


def mm_steps(a, b, passes=3, depth=8):
    """a @ b as csrc/milnce_grad_f32.cu forms it: each 8-deep k-step's three
    products (big·small + small·big + big·big) summed into a short partial,
    the partials added in f32 in k order (``passes=1``: big·big alone).  The
    kernel's gradient product keeps a 32-entry tile's four k-steps in one
    mma accumulator before that add, which an f32 emulation cannot tell
    apart; the forward (csrc/milnce_fwd.cu) keeps two (``depth=16``)."""
    (ab, as_), (bb, bs) = split(a), split(b)
    c = torch.zeros(*a.shape[:-1], b.shape[-1])
    for k0 in range(0, a.shape[-1], depth):
        ks = slice(k0, k0 + depth)
        x = ab[..., ks] @ bb[..., ks, :]
        if passes == 3:
            x = ab[..., ks] @ bs[..., ks, :] + as_[..., ks] @ bb[..., ks, :] + x
        c = c + x
    return c


def mm3(a, b, passes=3):
    """a @ b over 8-deep k-steps, each one mma.sync m16n8k8 .tf32 (mma3): the
    cross products summed apart and added in f32, then the big one
    (``passes=1``: big·big alone, plain TF32)."""
    (ab, as_), (bb, bs) = split(a), split(b)
    c = torch.zeros(*a.shape[:-1], b.shape[-1])
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        if passes == 3:
            c = c + (ab[..., ks] @ bs[..., ks, :] + as_[..., ks] @ bb[..., ks, :])
        c = c + ab[..., ks] @ bb[..., ks, :]
    return c


def _rows(x, n):
    """[B, H, S, D] -> [B, H, n, D], zero past S (cp.async zero-fills them)."""
    out = torch.zeros(*x.shape[:2], n, x.shape[3])
    out[:, :, :x.shape[2]] = x
    return out


def _key_bias(mask, B, S, n):
    """[B, n] log2-domain key bias: 0 real, -1e30 log2(e) padded, -inf past S."""
    bias = torch.full((B, n), -math.inf)
    bias[:, :S] = 0.0 if mask is None else torch.where(mask, NEG_INF * LOG2E, 0.0)
    return bias


def head_rows(S):
    """Rows the whole-head kernels stage (S <= 128): 16 a warp, the warps
    rounded up to the instantiated 2, 4, 5, 6 or 8."""
    warps = -(-S // 16)
    return 16 * min(w for w in (2, 4, 5, 6, 8) if w >= warps)


def tile_rows(S, i, tile=KT):
    return min(tile, -(-(S - tile * i) // 8) * 8)


def f32_fwd_schedule(q, k, v, mask, passes=3):
    """out as mha_fwd_f32_head_kernel (S <= 128) or mha_fwd_f32_kernel and
    the merge kernel compute it."""
    B, H, S, D = q.shape
    scale2 = LOG2E / math.sqrt(D)
    if S <= fwd.SHORT_MAX_S:  # the whole head at once, its rows zero-filled past S
        R = head_rows(S)
        K, V = _rows(k, R), _rows(v, R)
        x = mm3(q, K.transpose(-1, -2), passes) * scale2 + _key_bias(mask, B, S, R)[:, None, None]
        p = torch.exp2(x - x.amax(-1, keepdim=True))
        return mm3(p, V, passes) / p.sum(-1, keepdim=True)
    ktiles = -(-S // KT)
    splits = 1
    if S > fwd.SHORT_MAX_S:
        splits = fwd.f32_key_splits(B * H * -(-S // fwd.F32_LONG_QUERIES), ktiles, SMS)
    per = -(-ktiles // splits)
    splits = -(-ktiles // per)
    K, V = _rows(k, ktiles * KT), _rows(v, ktiles * KT)
    bias = _key_bias(mask, B, S, ktiles * KT)
    parts = []
    for sp in range(splits):
        m = torch.full((B, H, S, 1), -math.inf)
        l = torch.zeros(B, H, S, 1)
        o = torch.zeros(B, H, S, D)
        for i in range(sp * per, min(sp * per + per, ktiles)):
            ks = slice(KT * i, KT * i + tile_rows(S, i))  # 8-key chunks up to a key < S
            x = mm3(q, K[:, :, ks].transpose(-1, -2), passes) * scale2 + bias[:, None, None, ks]
            mx = torch.maximum(m, x.amax(-1, keepdim=True))
            corr = torch.exp2(m - mx)  # 0 on the first tile
            p = torch.exp2(x - mx)
            l = l * corr + p.sum(-1, keepdim=True)
            o = o * corr + mm3(p, V[:, :, ks], passes)
            m = mx
        parts.append((m, l, o))
    if splits == 1:
        return o / l
    M = torch.stack([pm for pm, _, _ in parts]).amax(0)  # mha_fwd_merge_kernel<float>
    L, O = torch.zeros_like(l), torch.zeros_like(o)
    for pm, pl_, po in parts:
        w = torch.exp2(pm - M)
        L, O = L + pl_ * w, O + po * w
    return O / L


def _keys_side(Q, K, V, dO, kb, m2, linv, delta, steps, scale2, passes):
    """dK / scale and dV over the query steps (slices) from the rows' (log2
    max, 1 / sum, delta), all 0 past S: what keys_step accumulates."""
    dk, dv = torch.zeros_like(K), torch.zeros_like(V)
    for qs in steps:
        st = mm3(K, Q[:, :, qs].transpose(-1, -2), passes)  # S^T [key][query]
        dpt = mm3(V, dO[:, :, qs].transpose(-1, -2), passes)  # dP^T
        p = torch.exp2(st * scale2 + kb[..., None] - m2[:, :, None, qs]) * linv[:, :, None, qs]
        ds = p * (dpt - delta[:, :, None, qs])
        dv = dv + mm3(p, dO[:, :, qs], passes)
        dk = dk + mm3(ds, Q[:, :, qs], passes)
    return dk, dv


def f32_bwd_schedule(q, k, v, mask, dout, passes=3):
    """(dq, dk, dv) as the f32 route of csrc/mha_bwd_f32.cu computes them."""
    B, H, S, D = q.shape
    scale = 1.0 / math.sqrt(D)
    scale2 = LOG2E * scale
    R = head_rows(S) if S <= FUSED_MAX_S else -(-S // KT) * KT  # staged rows
    Q, K, V, dO = (_rows(x, R) for x in (q, k, v, dout))
    bias = _key_bias(mask, B, S, R)
    live = (torch.arange(R) < S)[:, None]
    if S <= FUSED_MAX_S:  # mha_bwd_f32_fused_kernel, phase 1: whole rows
        x = mm3(Q, K.transpose(-1, -2), passes) * scale2 + bias[:, None, None, :]
        dp = mm3(dO, V.transpose(-1, -2), passes)
        m2 = x.amax(-1, keepdim=True)
        p = torch.exp2(x - m2)
        linv = torch.where(live, 1.0 / p.sum(-1, keepdim=True), 0.0)
        p = p * linv
        delta = (p * dp).sum(-1, keepdim=True)
        dq = mm3(p * (dp - delta), K, passes)
    else:  # mha_bwd_f32_dq_kernel: two online passes over 64-key tiles
        m2 = torch.full((B, H, R, 1), -math.inf)
        l, a = torch.zeros(B, H, R, 1), torch.zeros(B, H, R, 1)
        tiles = [slice(KT * i, KT * i + tile_rows(S, i)) for i in range(-(-S // KT))]
        scores = []
        for ks in tiles:
            x = mm3(Q, K[:, :, ks].transpose(-1, -2), passes) * scale2 + bias[:, None, None, ks]
            dp = mm3(dO, V[:, :, ks].transpose(-1, -2), passes)
            mx = torch.maximum(m2, x.amax(-1, keepdim=True))
            corr = torch.exp2(m2 - mx)
            e = torch.exp2(x - mx)
            l, a = l * corr + e.sum(-1, keepdim=True), a * corr + (e * dp).sum(-1, keepdim=True)
            m2 = mx
            scores.append((ks, x, dp))
        linv = torch.where(live, 1.0 / l, 0.0)
        delta = torch.where(live, a / l, 0.0)
        m2 = torch.where(live, m2, 0.0)
        dq = torch.zeros(B, H, R, D)
        for ks, x, dp in scores:  # the second pass recomputes the same values
            p = torch.exp2(x - m2) * linv
            dq = dq + mm3(p * (dp - delta), K[:, :, ks], passes)
    m2 = torch.where(live, m2, 0.0)[..., 0]
    if S <= FUSED_MAX_S:  # every staged row in 32-query steps, the last 16 alone
        steps = [slice(s0, min(s0 + QT, R)) for s0 in range(0, R, QT)]
    else:  # mha_bwd_f32_dkdv_kernel: 64-query tiles in 32-query steps
        steps = [slice(KT * i + s0, KT * i + min(s0 + QT, tile_rows(S, i)))
                 for i in range(-(-S // KT)) for s0 in range(0, tile_rows(S, i), QT)]
    dk, dv = _keys_side(Q, K, V, dO, bias[:, None, :], m2, linv[..., 0], delta[..., 0], steps,
                        scale2, passes)
    return (dq * scale)[:, :, :S], (dk * scale)[:, :, :S], dv[:, :, :S]


def _problem(seed, B, H, S, D=64):
    """Inputs from a numpy seed; a ragged key mask with one fully padded row."""
    rng = np.random.RandomState(seed)
    q, k, v, g = (rng.randn(B, H, S, D).astype(np.float32) for _ in range(4))
    mask = rng.rand(B, S) < 0.3
    mask[:, 0] = False
    mask[-1] = True
    return q, k, v, g, mask


def _bias(mask):
    return jnp.asarray(np.where(mask, NEG_INF, 0.0).astype(np.float32)[:, None, :])


def test_tf32_rounds_to_nearest_ties_away_and_the_split_restores_f32():
    one = 1.0 + 2.0 ** -11  # exactly halfway between two TF32 values
    x = torch.tensor([one, -one, 1.0 + 2.0 ** -12, 1.0 + 3 * 2.0 ** -12, 3.0, -0.0])
    assert tf32(x).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0, 1.0 + 2.0 ** -10,
                                3.0, -0.0]
    assert tf32_rz(x).tolist() == [1.0, -1.0, 1.0, 1.0, 3.0, -0.0]
    y = torch.from_numpy(np.random.RandomState(0).randn(4096).astype(np.float32))
    big, small = split(y)
    assert bool(((tf32(big) == big) & (tf32_rz(small) == small)).all())
    assert ((big + small - y).abs() <= y.abs() * 2.0 ** -20).all()
    assert ((big - y).abs() > y.abs() * 2.0 ** -18).any()  # TF32 alone is coarser


@pytest.mark.parametrize("S", [37, 64, 80, 200])
def test_f32_fwd_schedule_matches_jax_kernel_and_plain_tf32_does_not(S):
    """S = 37, 64, 80 in one block of the whole head; S = 200 in 64-query
    blocks over four key tiles (unsplit); ragged masks, a fully padded row."""
    q, k, v, _, mask = _problem(S + 3, 2, 2, S)
    jax_out = np.asarray(pallas_attention._fused_attention_call(
        *(jnp.asarray(x) for x in (q, k, v)), _bias(mask), interpret=True, group=1))
    tq, tk, tv, tm = (torch.from_numpy(x) for x in (q, k, v, mask))
    ours = f32_fwd_schedule(tq, tk, tv, tm)
    fault = f32_fwd_schedule(tq, tk, tv, tm, passes=1)
    assert bool(torch.isfinite(ours).all())
    assert np.abs(ours.numpy() - jax_out).max() <= F32_TOL
    assert np.abs(fault.numpy() - jax_out).max() > F32_TOL


@pytest.mark.parametrize("blocks,key_tiles,expected", [
    (8 * 17, 17, 5),  # the global method: [1, 8, 1088, 64], 17 blocks of 64 queries a head
    (48 * 5, 5, 1),   # the punctuator's [4, 12, 258, 64]: 5 key tiles a block
    (80 * 4, 4, 1), (2 * 10, 10, 3), (2 * 9, 9, 3), (2 * 8, 8, 1),
    (264, 17, 1), (263, 17, 5)])  # two blocks per SM fill the card
def test_f32_key_splits_cut_only_long_key_walks_of_short_grids(blocks, key_tiles, expected):
    splits = fwd.f32_key_splits(blocks, key_tiles, SMS)
    assert splits == expected
    per = -(-key_tiles // splits)
    assert (splits - 1) * per < key_tiles  # the last split holds a key tile


def test_f32_fwd_key_splits_merge_in_f32():
    """A grid short of the card with long key walks (as the global method's):
    the key range splits in parts of 4 tiles, and the merge keeps f32
    accuracy."""
    S = 600
    assert fwd.f32_key_splits(1 * 2 * -(-S // fwd.F32_LONG_QUERIES), -(-S // KT), SMS) == 3
    q, k, v, _, mask = _problem(S, 1, 2, S)
    mask[0, :] = False
    mask[0, 7::5] = True
    jax_out = np.asarray(pallas_attention._fused_attention_call(
        *(jnp.asarray(x) for x in (q, k, v)), _bias(mask), interpret=True, group=1))
    ours = f32_fwd_schedule(*(torch.from_numpy(x) for x in (q, k, v, mask)))
    assert np.abs(ours.numpy() - jax_out).max() <= F32_TOL


@pytest.mark.parametrize("S", [37, 64, 80, 200])
def test_f32_bwd_schedule_matches_jax_kernel_and_plain_tf32_does_not(S):
    """The fused kernel's pass at S = 37, 64, 80; the two-kernel plan at
    S = 200; per element against the JAX kernel's gradients."""
    q, k, v, g, mask = _problem(S, 2, 2, S)
    jax_out = pallas_attention._fused_attention_bwd_call(
        *(jnp.asarray(x) for x in (q, k, v)), _bias(mask), jnp.asarray(g), interpret=True,
        group=1)
    ref = [torch.from_numpy(np.array(x, np.float32)) for x in jax_out]
    args = [torch.from_numpy(x) for x in (q, k, v, mask, g)]
    ours = f32_bwd_schedule(*args)
    fault = f32_bwd_schedule(*args, passes=1)
    tol = GRAD_TOL["float32"]
    for a, b, name in zip(ours, ref, ("dq", "dk", "dv")):
        assert bool(torch.isfinite(a).all()), name
        assert elem_err(a, b) <= tol, name
    assert max(elem_err(a, b) for a, b in zip(fault, ref)) > tol


# ------------------------------------------------------ MIL-NCE gradients

MV, INV_TEMP = -6.0e4, 1.0 / 0.07


def f32_grad_schedule(v, t, pm, cv, lse, gv, gt, inv_temp, rows_outer, sms=SMS, passes=3):
    """dv (``rows_outer``) or dt as milnce_grad_f32_kernel computes it, block
    by block, in its order of sums."""
    vnum, vden, tnum, tden = (x.float() for x in lse)
    S, R, C = v.shape
    shared = t.dim() == 2
    K = t.shape[-2]
    text = (lambda s: t) if shared else (lambda s: t[s])
    out_layers = S if rows_outer or not shared else 1
    layers = S // out_layers
    nO, nI = (R, K) if rows_outer else (K, R)
    nq = 4 if C <= 128 else 8 if C <= 256 else 16
    cp, quarter = 32 * nq, 8 * nq
    itiles = -(-nI // 32)
    splits = milnce._wave_splits(-(-nO // 32) * out_layers, itiles, sms)
    per = -(-itiles // splits)
    splits = -(-itiles // per)

    def staged(x, n):  # [m, C] -> [n, cp], zero-filled as cp.async fills
        out = torch.zeros(n, cp)
        out[:x.shape[0], :C] = x.float()
        return out

    nOp, nIp = 32 * -(-nO // 32), 32 * itiles
    out = torch.zeros(out_layers, nO, C)
    for y in range(out_layers):
        O = staged(v[y * layers] if rows_outer else text(y * layers), nOp)
        parts = []
        for sp in range(splits):
            acc = torch.zeros(nOp, cp)
            for s in range(y * layers, (y + 1) * layers):
                I = staged(text(s) if rows_outer else v[s], nIp)
                for it in range(sp * per, min(sp * per + per, itiles)):
                    ins = slice(32 * it, 32 * it + 32)
                    sim = torch.zeros(nOp, 32)
                    for q in range(4):  # the channel quarters, reduced in quarter order
                        cs = slice(q * quarter, q * quarter + quarter)
                        sim = sim + mm_steps(O[:, cs], I[ins, cs].T, passes)
                    o = torch.arange(nOp)[:, None]
                    i = torch.arange(32 * it, 32 * it + 32)[None, :]
                    live = (o < nO) & (i < nI)
                    r, k = ((o, i) if rows_outer else (i, o))
                    r, k = r.clamp(max=R - 1).expand(nOp, 32), k.clamp(max=K - 1).expand(nOp, 32)
                    x = sim * inv_temp
                    zero = torch.zeros(())
                    d = torch.where(pm[r, k], -(gv[s][r] * torch.exp(x - vnum[s][r])
                                                + gt[s][k] * torch.exp(x - tnum[s][k])), zero)
                    d = d + torch.where(cv[k], gv[s][r] * torch.exp(x - vden[s][r])
                                        + gt[s][k] * torch.exp(x - tden[s][k]), zero)
                    d = torch.where(live, d * inv_temp, zero)
                    acc = acc + mm_steps(d, I[ins], passes)
            parts.append(acc[:nO, :C])
        total = torch.zeros(nO, C)
        for p in parts:  # split order
            total = total + p
        out[y] = total
    return out[0] if not rows_outer and shared else out


def _milnce_problem(seed, S, R, K, C, shared):
    rng = np.random.RandomState(seed)
    unit = lambda *s: (lambda x: x / np.linalg.norm(x, axis=-1, keepdims=True))(
        rng.randn(*s).astype(np.float32))
    v = unit(S, R, C)
    t = unit(K, C) if shared else unit(S, K, C)
    cv = rng.rand(K) < 0.8
    pm = (rng.rand(R, K) < 0.1) & cv[None]
    pm[3] = False  # a row with no positive
    gv, gt = rng.randn(S, R).astype(np.float32), rng.randn(S, K).astype(np.float32)
    return v, t, pm, cv, gv, gt


def _jax_milnce_bwd(v, t, pm, cv, lse, gv, gt, tiled):
    """(dv, dt) of the JAX backward kernel in f32 (the untiled _bwd_call or the
    column-tiled _bwd_call_tiled), interpret mode; a shared text is broadcast
    and its gradient summed over the layers, as fused_milnce_elements does."""
    S = v.shape[0]
    K = t.shape[-2]
    tt = np.broadcast_to(t, (S,) + t.shape) if t.ndim == 2 else t
    vnum, vden, tnum, tden = (jnp.asarray(x.numpy()) for x in lse)
    args = (jnp.asarray(v), jnp.asarray(np.ascontiguousarray(tt)),
            jnp.asarray(pm.astype(np.float32)), jnp.asarray(cv.astype(np.float32))[None],
            vnum, vden, tnum, tden, jnp.asarray(-gv), jnp.asarray(gv), jnp.asarray(-gt),
            jnp.asarray(gt))
    if tiled:
        dv, dt = pallas_milnce._bwd_call_tiled(*args, True, INV_TEMP, MV, 8, K // 2)
    else:
        dv, dt = pallas_milnce._bwd_call(*args, True, INV_TEMP, MV, 8)
    dt = np.array(dt, np.float32)
    return np.array(dv, np.float32), dt.sum(0) if t.ndim == 2 else dt


@pytest.mark.parametrize("shape", [(2, 96, 70, 192), (2, 64, 96, 512)])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("tiled", [False, True])
def test_f32_milnce_grad_schedule_matches_jax_kernels_and_plain_tf32_does_not(shape, shared,
                                                                                 tiled):
    """Ragged R and K (32-entry tiles), C = 192 (zero-padded to 256 channels,
    quarters of 64) and 512; inner splits (a card of 4 SMs); per element
    against the JAX kernels' gradients at GRAD_TOL["float32"], which the
    single-pass TF32 products exceed."""
    S, R, K, C = shape
    v, t, pm, cv, gv, gt = _milnce_problem(R + int(shared) + 2 * int(tiled), S, R, K, C, shared)
    tv, tt, tpm, tcv, tgv, tgt = (torch.from_numpy(x) for x in (v, t, pm, cv, gv, gt))
    lse = milnce.milnce_lse_reference(tv, tt, tpm, tcv, MV, INV_TEMP)
    ref = [torch.from_numpy(x) for x in _jax_milnce_bwd(v, t, pm, cv, lse, gv, gt, tiled)]
    tol = GRAD_TOL["float32"]
    faults = []
    for rows_outer, b in zip((True, False), ref):
        args = (tv, tt, tpm, tcv, lse, tgv, tgt, INV_TEMP, rows_outer)
        ours = f32_grad_schedule(*args, sms=4)
        assert ours.shape == b.shape and bool(torch.isfinite(ours).all())
        assert elem_err(ours, b) <= tol, ("dv" if rows_outer else "dt")
        faults.append(elem_err(f32_grad_schedule(*args, sms=4, passes=1), b))
    assert max(faults) > tol, faults


# ------------------------------------------------------- MIL-NCE forward

LOG2E_F = math.log2(math.e)


def f32_fwd_milnce_schedule(v, t, pm, cv, mv, inv_temp, passes=3):
    """(vnum, vden [S, R], tnum, tden [S, K]) as milnce_fwd_f32_kernel and
    milnce_colmerge_kernel compute them, in their tiles and order of sums."""
    S, R, C = v.shape
    K = t.shape[-2]
    rp, kp = 64 * -(-R // 64), 128 * -(-K // 128)  # rows and columns padded to the tiles
    c2, mv2, ln2 = inv_temp * LOG2E_F, mv * LOG2E_F, math.log(2.0)
    zero = torch.zeros(())
    ref = lambda m: torch.where(m == -math.inf, zero, m)  # ex2_ref

    def merge(m, s, m2, s2):  # merge2, log2 domain
        mx = torch.maximum(m, m2)
        r = ref(mx)
        return mx, s * torch.exp2(m - r) + s2 * torch.exp2(m2 - r)

    live = torch.zeros(rp, kp, dtype=torch.bool)
    live[:R, :K] = True
    pmp = torch.zeros(rp, kp, dtype=torch.bool)
    pmp[:R, :K] = pm
    cvp = torch.zeros(kp, dtype=torch.bool)
    cvp[:K] = cv
    vnum, vden = torch.zeros(S, R), torch.zeros(S, R)
    part = torch.zeros(4, S, rp // 64, K)
    for s in range(S):
        text = t if t.dim() == 2 else t[s]
        sim = torch.zeros(rp, kp)
        sim[:R, :K] = mm_steps(v[s].float(), text.float().T, passes, depth=16)
        x = sim * c2
        xs = [torch.where(live, torch.where(keep, x, torch.tensor(mv2)), -math.inf)
              for keep in (pmp, cvp[None].expand(rp, kp))]
        rows_out = []
        for q, xq in enumerate(xs):
            # rows: lane t of column warp wc folds its 8 columns of each tile
            xt = xq.reshape(rp, kp // 128, 4, 4, 8)  # [row, tile, wc, t, 8]
            m = torch.full((rp, 4, 4), -math.inf)
            ssum = torch.zeros(rp, 4, 4)
            for it in range(kp // 128):  # fold8
                tm = torch.maximum(m, xt[:, it].amax(-1))
                r = ref(tm)
                ssum = ssum * torch.exp2(m - r) + torch.exp2(xt[:, it] - r[..., None]).sum(-1)
                m = tm
            for off in (1, 2):  # the quad's butterfly
                pair = [i ^ off for i in range(4)]
                m, ssum = merge(m, ssum, m[..., pair], ssum[..., pair])
            m, ssum = m[..., 0], ssum[..., 0]  # [row, wc], every lane alike
            mr, sr = m[:, 0], ssum[:, 0]
            for wc in range(1, 4):
                mr, sr = merge(mr, sr, m[:, wc], ssum[:, wc])
            rows_out.append(((mr + torch.log2(sr)) * ln2)[:R])
            # columns: each row warp's 32 rows, then the two merged
            xw = xq.reshape(rp // 64, 2, 32, kp)  # [row block, wr, 32 rows, column]
            mw = xw.amax(2)
            sw = torch.exp2(xw - ref(mw)[:, :, None]).sum(2)
            mc, sc = merge(mw[:, 0], sw[:, 0], mw[:, 1], sw[:, 1])
            part[2 * q, s] = (mc * ln2)[:, :K]
            part[2 * q + 1, s] = sc[:, :K]
        vnum[s], vden[s] = rows_out
    return (vnum, vden) + colmerge_schedule(part)


@pytest.mark.parametrize("shape", [(2, 96, 70, 192), (2, 64, 96, 512)])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("tiled", [False, True])
def test_f32_milnce_fwd_schedule_matches_jax_kernels_and_plain_tf32_does_not(shape, shared,
                                                                              tiled):
    """Ragged R and K (a 32-row second block; one 128-column tile whose upper
    column warps lie past K), C = 192 and 512, a row without a positive,
    padded columns; the four logsumexps per element (lse_err) against the
    JAX kernels and the plain version at MILNCE_LSE_F32_TOL, which the
    single-pass TF32 products exceed."""
    S, R, K, C = shape
    v, t, pm, cv, _, _ = _milnce_problem(R + K + int(shared) + 2 * int(tiled), S, R, K, C, shared)
    tv, tt, tpm, tcv = (torch.from_numpy(x) for x in (v, t, pm, cv))
    ours = f32_fwd_milnce_schedule(tv, tt, tpm, tcv, MV, INV_TEMP)
    fault = f32_fwd_milnce_schedule(tv, tt, tpm, tcv, MV, INV_TEMP, passes=1)
    plain = milnce.milnce_lse_reference(tv, tt, tpm, tcv, MV, INV_TEMP)
    jax_ref = [torch.from_numpy(np.array(x)) for x in _jax_fwd(v, t, pm, cv, tiled)]
    for a, b, c, name in zip(ours, plain, jax_ref, ("vnum", "vden", "tnum", "tden")):
        assert a.shape == b.shape and bool(torch.isfinite(a).all()), name
        assert lse_err(a, b) <= MILNCE_LSE_F32_TOL, name
        assert lse_err(a, c) <= MILNCE_LSE_F32_TOL, name
    assert max(lse_err(a, b) for a, b in zip(fault, plain)) > MILNCE_LSE_F32_TOL
