"""Blocked CPU emulations of the Hopper kernels' tile schedules, held against
the JAX package's Pallas kernels (interpret mode, as tests/test_pallas.py and
tests/test_fused_milnce.py run them) and against the port's plain versions.

- ``fused_mha_bwd_schedule`` follows csrc/mha_bwd.cu::mha_bwd_fused_kernel:
  one head at a time, query rows padded to 64-row warpgroup tiles and keys to
  16-key chunks (zero-filled past S, as TMA fills them), exact softmax of
  whole rows, P and dS through the bf16 "panels" (64 keys x the queries),
  dQ over key chunks, dV and dK per 64-key warpgroup over 16-query steps.
- ``long_mha_bwd_schedule`` follows csrc/mha_bwd.cu's long route:
  mha_bwd_long_dq_kernel per 64-query tile, the 64-key tiles (zero-filled
  past S) streamed twice, an online (max, sum, sum of e^x dP) in the log2
  domain, then dS rounded to the input dtype into dQ; each row's m, 1 / sum
  and rowsum(dP P) to a per-tile scratch (1 / sum = 0 past S); then
  mha_bwd_long_dkdv_kernel per 64-key tile, the query tiles streamed with
  their statistics, P^T and dS^T from the transposed products, rounded, into
  dV and dK.
- ``mha_fwd_schedule`` follows csrc/mha_fwd.cu::mha_fwd_wgmma_kernel: 64-query
  warpgroup tiles, 64-key tiles zero-filled past S (16-key chunks up to the
  last key < S), the online softmax in the log2 domain with the unnormalised
  P rounded to the value dtype before P V, and the key range split into
  parts whose (max, sum, O) merge in split order (mha_fwd_merge_kernel).
- ``dt_schedule`` and ``dv_schedule`` follow csrc/milnce_wgmma.cu, one template
  over the orientation: 64 outer entries a block (text columns for dt, video
  rows for dv), 64-entry inner tiles, sim summed over the two consumers'
  channel chunks, dsim rounded to the feature dtype, the product split over
  the same chunks, inner splits chosen by ``ops.milnce._wave_splits``, and
  their f32 partials summed in split order (milnce_reduce_kernel); one split
  goes out without partials.
- ``milnce_fwd_schedule`` follows the same file's milnce_fwd_wgmma_kernel and
  milnce_colmerge_kernel: 64-row blocks, 64-column tiles zero-filled past R
  and K, sim summed over the two consumers' channel chunks, the masked
  entries in the log2 domain (mask_value where masked, -inf where dead), row
  (max, sum) pairs per consumer half merged at the end, column partials per
  row block in natural-log terms, merged as milnce_colmerge_kernel merges
  them (``colmerge_schedule``: eight groups of row blocks, each in order,
  then the groups in order).

Also the route selection of ``mha_fwd``, ``mha_bwd``, ``milnce_fwd``,
``milnce_dv`` and ``milnce_dt`` (dtype and S), and the key-split chooser of
``mha_fwd``.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import BF16_TOL as FWD_BF16_TOL, GRAD_TOL, MILNCE_VALUE_TOL, elem_err
from port_fixtures import to_torch
from temporalalignnet_torch.ops import milnce
from temporalalignnet_torch.ops import mha_bwd as bwd
from temporalalignnet_torch.ops import mha_fwd as fwd
from temporalalignnet_torch.ops.attention import NEG_INF, attention_reference
from temporalalignnet_tpu.ops import pallas_attention, pallas_milnce

torch.set_num_threads(2)

F32_TOL = 1e-5  # f32, emulation against the plain version: the order of the sums
JAX_ATTN_TOL = 1e-5  # tests/test_torch_attention.py: f32 on the CPU
JAX_MILNCE_TOL = 5e-4  # tests/test_fused_milnce.py:85 (interpret mode)
BF16_TOL = GRAD_TOL["bfloat16"]  # the chip check's per-element limit (chip_smoke.py)
MV, INV_TEMP = -6.0e4, 1.0 / 0.07


# ------------------------------------------------------- attention forward


def mha_fwd_schedule(q, k, v, mask, splits=1):
    """out as mha_fwd_wgmma_kernel computes it, in its order."""
    dtype = q.dtype
    B, H, S, D = q.shape
    kt = -(-S // 64)  # 64-key tiles
    per = -(-kt // splits)
    splits = -(-kt // per)  # no empty split
    QR, KR = -(-S // 64) * 64, kt * 64
    scale2 = math.log2(math.e) / math.sqrt(D)
    rnd = lambda x: x.to(dtype).float()

    def rows(x, n):  # [B, H, S, D] -> [B, H, n, D], zero past S
        out = torch.zeros(B, H, n, D)
        out[:, :, :S] = x.float()
        return out

    Q, K, V = rows(q, QR), rows(k, KR), rows(v, KR)
    bias = torch.full((B, KR), -math.inf)  # log2 domain: 0, -1e30 log2(e), -inf past S
    bias[:, :S] = 0.0 if mask is None else torch.where(mask, NEG_INF * math.log2(math.e), 0.0)
    parts = []
    for sp in range(splits):
        m = torch.full((B, H, QR, 1), -math.inf)
        l = torch.zeros(B, H, QR, 1)
        o = torch.zeros(B, H, QR, D)
        for it in range(sp * per, min(sp * per + per, kt)):
            ks = slice(64 * it, 64 * it + 64)
            chunks = min(4, -(-(S - 64 * it) // 16))  # 16-key chunks with a key < S
            s = Q @ K[:, :, ks].transpose(-1, -2)
            s[..., 16 * chunks:] = 0.0  # not computed; their keys' bias is -inf
            x = s * scale2 + bias[:, None, None, ks]
            mx = torch.maximum(m, x.amax(-1, keepdim=True))
            corr = torch.exp2(m - mx)  # 0 on the first tile
            p = torch.exp2(x - mx)
            l = l * corr + p.sum(-1, keepdim=True)
            o = o * corr + rnd(p) @ V[:, :, ks]  # P rounded unnormalised
            m = mx
        parts.append((m, l, o))
    if splits == 1:
        out = o / l
    else:  # mha_fwd_merge_kernel
        M = torch.stack([pm for pm, _, _ in parts]).amax(0)
        L, O = torch.zeros_like(l), torch.zeros_like(o)
        for pm, pl_, po in parts:
            w = torch.exp2(pm - M)
            L, O = L + pl_ * w, O + po * w
        out = O / L
    return out[:, :, :S].to(dtype)


def _jax_attn_fwd(q, k, v, mask, dtype=jnp.float32):
    B, S = q.shape[0], q.shape[2]
    bias = np.zeros((B, 1, S), np.float32)
    if mask is not None:
        bias = np.where(mask, NEG_INF, 0.0).astype(np.float32)[:, None, :]
    out = pallas_attention._fused_attention_call(
        *(jnp.asarray(x, dtype) for x in (q, k, v)), jnp.asarray(bias), interpret=True, group=1)
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("S,masked,splits", [(37, True, 1), (64, False, 1), (80, True, 2),
                                             (200, True, 3), (200, False, 4), (176, True, 3)])
def test_mha_fwd_schedule_matches_jax_kernel_and_plain_f32(S, masked, splits):
    """f32: one and two warpgroup tiles, ragged last key tiles, 1-4 key splits
    (S = 200 asked for 3 takes 2: no split is empty), a fully padded row."""
    q, k, v, _, mask = _attn_problem(S + 7, 2, 2, S, masked=masked)
    tm = None if mask is None else to_torch(mask)
    ours = mha_fwd_schedule(*(to_torch(x) for x in (q, k, v)), tm, splits)
    plain = attention_reference(*(to_torch(x) for x in (q, k, v)), tm)
    assert bool(torch.isfinite(ours).all())
    torch.testing.assert_close(ours, plain, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(ours.numpy(), _jax_attn_fwd(q, k, v, mask), atol=JAX_ATTN_TOL,
                               rtol=0)


@pytest.mark.parametrize("S,splits", [(37, 1), (80, 1), (200, 3)])
def test_mha_fwd_schedule_bf16_rounds_within_the_chip_limit(S, splits):
    """bf16 inputs, the unnormalised P rounded to bf16 before P V: against
    attention_reference (P normalised, then rounded) and the JAX kernel in
    bf16 by the chip check's limit."""
    q, k, v, _, mask = _attn_problem(S + 11, 2, 2, S)
    tq, tk, tv = (to_torch(x).bfloat16() for x in (q, k, v))
    ours = mha_fwd_schedule(tq, tk, tv, to_torch(mask), splits)
    plain = attention_reference(tq.float(), tk.float(), tv.float(), to_torch(mask))
    assert ours.dtype == torch.bfloat16
    assert (ours.float() - plain).abs().max().item() <= FWD_BF16_TOL
    jax_ref = _jax_attn_fwd(*(x.float().numpy() for x in (tq, tk, tv)), mask, jnp.bfloat16)
    assert np.abs(ours.float().numpy() - jax_ref).max() <= FWD_BF16_TOL


@pytest.mark.parametrize("dtype,S,expected", [
    (torch.bfloat16, 1, "short"), (torch.bfloat16, 64, "short"), (torch.bfloat16, 80, "short"),
    (torch.bfloat16, 128, "short"), (torch.bfloat16, 129, "long"), (torch.bfloat16, 1088, "long"),
    (torch.float32, 64, "f32"), (torch.float32, 1088, "f32")])
def test_mha_fwd_route_depends_on_dtype_and_length(dtype, S, expected):
    assert fwd.route(dtype, S) == expected


def test_mha_fwd_counts_the_route_it_launches(monkeypatch):
    """The wrapper hands its route to the launch and counts it there; v1 is
    launched uncounted."""
    taken = []
    monkeypatch.setattr(fwd, "_launch", lambda which, *a: taken.append(which))
    before = dict(fwd.mha_fwd.launches_by_route)
    for S in (64, 80, 200, 1088):
        q = torch.zeros(1, 1, S, 64, dtype=torch.bfloat16)
        fwd.mha_fwd(q, q, q)
    fwd.mha_fwd(*[torch.zeros(1, 1, 64, 64)] * 3)
    fwd.mha_fwd_v1(*[torch.zeros(1, 1, 64, 64, dtype=torch.bfloat16)] * 3)
    assert taken == ["short", "short", "long", "long", "f32", "v1"]
    after = fwd.mha_fwd.launches_by_route
    assert {r: after[r] - before[r] for r in after} == {"short": 2, "long": 2, "f32": 1}
    with pytest.raises(ValueError, match="bfloat16"):
        fwd.mha_fwd_v1(*[torch.zeros(1, 1, 64, 64)] * 3)


@pytest.mark.parametrize("blocks,key_tiles,sms,expected", [
    (8 * 9, 17, 132, 3),  # the global method: [1, 8, 1088, 64], 9 query blocks
    (8 * 2, 4, 132, 4),   # [1, 8, 200, 64]: one key tile per split
    (512 * 2, 4, 132, 1),  # [64, 8, 200, 64] fills the card
    (132, 17, 132, 1), (131, 17, 132, 2),
    (72, 17, 16, 1), (8, 5, 132, 5), (8, 17, 20, 5)])  # 17 tiles in 5 parts: 4, 4, 4, 4, 1
def test_key_splits_fill_the_card_without_empty_splits(blocks, key_tiles, sms, expected):
    splits = fwd.key_splits(blocks, key_tiles, sms)
    assert splits == expected
    per = -(-key_tiles // splits)
    assert (splits - 1) * per < key_tiles  # the last split holds a key tile


# ------------------------------------------------------ attention backward


def fused_mha_bwd_schedule(q, k, v, mask, dout):
    """(dq, dk, dv) as mha_bwd_fused_kernel computes them, in its order."""
    dtype = q.dtype
    B, H, S, D = q.shape
    nch = -(-S // 16)
    nwg = 2 if nch > 4 else 1
    QR, KR = 64 * nwg, 16 * nch
    scale = 1.0 / math.sqrt(D)
    rnd = lambda x: x.to(dtype).float()

    def rows(x, n):  # [B, H, S, D] -> [B, H, n, D], zero past S
        out = torch.zeros(B, H, n, D)
        out[:, :, :S] = x.float()
        return out

    Q, dO, K, V = rows(q, QR), rows(dout, QR), rows(k, KR), rows(v, KR)
    bias = torch.full((B, KR), -math.inf)
    bias[:, :S] = 0.0 if mask is None else torch.where(mask, NEG_INF, 0.0)
    p_pan = torch.zeros(B, H, nwg, KR, 64)  # [panel][queries][64 keys]
    ds_pan = torch.zeros(B, H, nwg, KR, 64)
    dq = torch.zeros(B, H, QR, D)
    for w in range(nwg):  # one warpgroup per 64 query rows
        qr = slice(64 * w, 64 * w + 64)
        sc = torch.zeros(B, H, 64, KR)
        dp = torch.zeros(B, H, 64, KR)
        for j in range(nch):  # 16-key chunks
            kc = slice(16 * j, 16 * j + 16)
            sc[..., kc] = Q[:, :, qr] @ K[:, :, kc].transpose(-1, -2)
            dp[..., kc] = dO[:, :, qr] @ V[:, :, kc].transpose(-1, -2)
        x = sc * scale + bias[:, None, None, :]
        p = torch.softmax(x, dim=-1)
        live = (torch.arange(64 * w, 64 * w + 64) < S)[:, None]
        p = torch.where(live, p, torch.zeros(()))
        ds = p * (dp - (p * dp).sum(-1, keepdim=True))
        for j in range(4 * nwg):  # the panels, zero past the last chunk
            n = min(64, KR - 64 * w)  # panel rows this warpgroup writes
            if j < nch and n > 0:
                kc = slice(16 * j, 16 * j + 16)
                pc = slice((j % 4) * 16, (j % 4) * 16 + 16)
                p_pan[:, :, j // 4, 64 * w:64 * w + n, pc] = rnd(p[:, :, :n, kc])
                ds_pan[:, :, j // 4, 64 * w:64 * w + n, pc] = rnd(ds[:, :, :n, kc])
        for kk in range(nch):  # dQ = dS K, dS from registers
            kc = slice(16 * kk, 16 * kk + 16)
            dq[:, :, qr] += rnd(ds[..., kc]) @ K[:, :, kc]
    dk = torch.zeros(B, H, 64 * nwg, D)
    dv = torch.zeros(B, H, 64 * nwg, D)
    for w in range(nwg):  # keys 64 w .. +63
        kr = slice(64 * w, 64 * w + 64)
        for kk in range(nch):  # 16 queries a step
            qc = slice(16 * kk, 16 * kk + 16)
            dv[:, :, kr] += p_pan[:, :, w, qc].transpose(-1, -2) @ dO[:, :, qc]
            dk[:, :, kr] += ds_pan[:, :, w, qc].transpose(-1, -2) @ Q[:, :, qc]
    return ((dq[:, :, :S] * scale).to(dtype), (dk[:, :, :S] * scale).to(dtype),
            dv[:, :, :S].to(dtype))


def _attn_problem(seed, B, H, S, D=64, masked=True):
    rng = np.random.RandomState(seed)
    q, k, v, g = (rng.randn(B, H, S, D).astype(np.float32) for _ in range(4))
    mask = None
    if masked:
        mask = rng.rand(B, S) < 0.3
        mask[:, 0] = False
        mask[-1] = True  # a fully padded row
    return q, k, v, g, mask


def _jax_attn_bwd(q, k, v, mask, g):
    B, S = q.shape[0], q.shape[2]
    bias = np.zeros((B, 1, S), np.float32)
    if mask is not None:
        bias = np.where(mask, NEG_INF, 0.0).astype(np.float32)[:, None, :]
    out = pallas_attention._fused_attention_bwd_call(
        *(jnp.asarray(x) for x in (q, k, v, bias, g)), interpret=True, group=1)
    return [np.asarray(x, np.float32) for x in out]


@pytest.mark.parametrize("S,masked", [(37, True), (64, False), (80, True), (128, True)])
def test_fused_mha_bwd_schedule_matches_jax_kernel_and_plain_f32(S, masked):
    """f32: one warpgroup (S <= 64) and two (S = 80, 128), a fully padded row."""
    q, k, v, g, mask = _attn_problem(S, 2, 2, S, masked=masked)
    tm = None if mask is None else to_torch(mask)
    ours = fused_mha_bwd_schedule(*(to_torch(x) for x in (q, k, v)), tm, to_torch(g))
    plain = bwd.mha_bwd_reference(*(to_torch(x) for x in (q, k, v)), tm, to_torch(g))
    jax_ref = _jax_attn_bwd(q, k, v, mask, g)
    for a, b, c, name in zip(ours, plain, jax_ref, ("dq", "dk", "dv")):
        assert bool(torch.isfinite(a).all()), name
        torch.testing.assert_close(a, b, rtol=F32_TOL, atol=F32_TOL, msg=name)
        np.testing.assert_allclose(a.numpy(), c, atol=JAX_ATTN_TOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("S", [37, 80])
def test_fused_mha_bwd_schedule_bf16_rounds_as_the_plain_version(S):
    """bf16 inputs, P and dS rounded where the kernel rounds them: against
    mha_bwd_reference and the JAX kernel in bf16 by the chip check's limit."""
    q, k, v, g, mask = _attn_problem(S + 1, 2, 2, S)
    tq, tk, tv, tg = (to_torch(x).bfloat16() for x in (q, k, v, g))
    ours = fused_mha_bwd_schedule(tq, tk, tv, to_torch(mask), tg)
    plain = bwd.mha_bwd_reference(tq, tk, tv, to_torch(mask), tg)
    bias = np.where(mask, NEG_INF, 0.0).astype(np.float32)[:, None, :]
    jax_ref = pallas_attention._fused_attention_bwd_call(
        *(jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (tq, tk, tv)),
        jnp.asarray(bias), jnp.asarray(tg.float().numpy(), jnp.bfloat16),
        interpret=True, group=1)
    for a, b, c, name in zip(ours, plain, jax_ref, ("dq", "dk", "dv")):
        assert a.dtype == torch.bfloat16, name
        assert elem_err(a, b) <= BF16_TOL, name
        assert elem_err(a, torch.from_numpy(np.asarray(c, np.float32))) <= BF16_TOL, name


def long_mha_bwd_schedule(q, k, v, mask, dout):
    """(dq, dk, dv) as the long route's two kernels compute them, in their order."""
    dtype = q.dtype
    B, H, S, D = q.shape
    nt = -(-S // 64)
    n = 64 * nt
    scale = 1.0 / math.sqrt(D)
    scale2 = scale * math.log2(math.e)
    rnd = lambda x: x.to(dtype).float()

    def rows(x):  # [B, H, S, D] -> [B, H, n, D], zero past S (TMA's fill)
        out = torch.zeros(B, H, n, D)
        out[:, :, :S] = x.float()
        return out

    Q, dO, K, V = rows(q), rows(dout), rows(k), rows(v)
    bias = torch.full((B, n), -math.inf)  # the key bias, not scaled: 0, -1e30, -inf past S
    bias[:, :S] = 0.0 if mask is None else torch.where(mask, NEG_INF, 0.0)
    stats = torch.zeros(B, H, nt, 3, 64)  # m, 1 / sum, rowsum(dP P) per query tile
    dq = torch.zeros(B, H, n, D)
    for qt in range(nt):  # mha_bwd_long_dq_kernel
        qs = slice(64 * qt, 64 * qt + 64)
        m = torch.full((B, H, 64, 1), -math.inf)
        l, a = torch.zeros(B, H, 64, 1), torch.zeros(B, H, 64, 1)
        for sweep in range(2):
            for kt in range(nt):
                ks = slice(64 * kt, 64 * kt + 64)
                x = Q[:, :, qs] @ K[:, :, ks].transpose(-1, -2) * scale2 + bias[:, None, None, ks]
                dp = dO[:, :, qs] @ V[:, :, ks].transpose(-1, -2)
                if sweep == 0:
                    mx = torch.maximum(m, x.amax(-1, keepdim=True))
                    corr = torch.exp2(m - mx)
                    p = torch.exp2(x - mx)
                    l, a, m = l * corr + p.sum(-1, keepdim=True), a * corr + (p * dp).sum(
                        -1, keepdim=True), mx
                    continue
                p = torch.exp2(x - m) * li
                dq[:, :, qs] += rnd(p * (dp - dl)) @ K[:, :, ks]
            if sweep == 0:
                live = (torch.arange(64 * qt, 64 * qt + 64) < S)[:, None]
                li = torch.where(live, 1.0 / l, torch.zeros(()))
                dl = a * li
                stats[:, :, qt] = torch.cat([m, li, dl], -1).transpose(-1, -2)
    dk, dv = torch.zeros(B, H, n, D), torch.zeros(B, H, n, D)
    for kt in range(nt):  # mha_bwd_long_dkdv_kernel
        ks = slice(64 * kt, 64 * kt + 64)
        for qt in range(nt):
            qs = slice(64 * qt, 64 * qt + 64)
            m, li, dl = (stats[:, :, qt, i][:, :, None, :] for i in range(3))  # per query column
            x = K[:, :, ks] @ Q[:, :, qs].transpose(-1, -2) * scale2 + bias[:, None, ks, None]
            pt = torch.exp2(x - m) * li  # P^T [keys][queries]
            dst = pt * (V[:, :, ks] @ dO[:, :, qs].transpose(-1, -2) - dl)
            dv[:, :, ks] += rnd(pt) @ dO[:, :, qs]
            dk[:, :, ks] += rnd(dst) @ Q[:, :, qs]
    return ((dq[:, :, :S] * scale).to(dtype), (dk[:, :, :S] * scale).to(dtype),
            dv[:, :, :S].to(dtype))


@pytest.mark.parametrize("S,masked", [(129, True), (144, False), (144, True), (200, True)])
def test_long_mha_bwd_schedule_matches_jax_kernel_and_plain_f32(S, masked):
    """f32: past S = 128, ragged last tiles (1, 16 and 8 rows), a fully padded row."""
    q, k, v, g, mask = _attn_problem(S, 2, 2, S, masked=masked)
    tm = None if mask is None else to_torch(mask)
    ours = long_mha_bwd_schedule(*(to_torch(x) for x in (q, k, v)), tm, to_torch(g))
    plain = bwd.mha_bwd_reference(*(to_torch(x) for x in (q, k, v)), tm, to_torch(g))
    jax_ref = _jax_attn_bwd(q, k, v, mask, g)
    for a, b, c, name in zip(ours, plain, jax_ref, ("dq", "dk", "dv")):
        assert bool(torch.isfinite(a).all()), name
        torch.testing.assert_close(a, b, rtol=F32_TOL, atol=F32_TOL, msg=name)
        np.testing.assert_allclose(a.numpy(), c, atol=JAX_ATTN_TOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("S,masked", [(129, True), (144, False), (200, True)])
def test_long_mha_bwd_schedule_bf16_rounds_as_the_plain_version(S, masked):
    """bf16 inputs, P and dS rounded where the kernels round them: against
    mha_bwd_reference by the chip check's limit."""
    q, k, v, g, mask = _attn_problem(S + 1, 2, 2, S, masked=masked)
    tq, tk, tv, tg = (to_torch(x).bfloat16() for x in (q, k, v, g))
    tm = None if mask is None else to_torch(mask)
    ours = long_mha_bwd_schedule(tq, tk, tv, tm, tg)
    plain = bwd.mha_bwd_reference(tq, tk, tv, tm, tg)
    for a, b, name in zip(ours, plain, ("dq", "dk", "dv")):
        assert a.dtype == torch.bfloat16, name
        assert elem_err(a, b) <= BF16_TOL, name


@pytest.mark.parametrize("dtype,S,expected", [
    (torch.bfloat16, 1, "fused"), (torch.bfloat16, 64, "fused"), (torch.bfloat16, 80, "fused"),
    (torch.bfloat16, 128, "fused"), (torch.bfloat16, 129, "long"), (torch.bfloat16, 1088, "long"),
    (torch.float32, 64, "f32"), (torch.float32, 200, "f32")])
def test_mha_bwd_route_depends_on_dtype_and_length(dtype, S, expected):
    assert bwd.route(dtype, S) == expected


def test_mha_bwd_counts_the_route_it_launches(monkeypatch):
    """The wrapper hands its route to the launch and counts it there."""
    taken = []
    monkeypatch.setattr(bwd, "_launch", lambda which, *a: taken.append(which) or (None,) * 3)
    before = dict(bwd.mha_bwd.launches_by_route)
    for S in (64, 80, 200):
        q = torch.zeros(1, 1, S, 64, dtype=torch.bfloat16)
        bwd.mha_bwd(q, q, q, None, q)
    bwd.mha_bwd(torch.zeros(1, 1, 64, 64), *[torch.zeros(1, 1, 64, 64)] * 2, None,
                torch.zeros(1, 1, 64, 64))
    assert taken == ["fused", "fused", "long", "f32"]
    after = bwd.mha_bwd.launches_by_route
    assert {r: after[r] - before[r] for r in after} == {"fused": 2, "long": 1, "f32": 1}


def test_mha_bwd_long_entry_refuses_f32():
    """The long route's kernels take bf16 only: f32 past S = 128 is the f32
    route's, and the long entry refuses it before any launch."""
    q = torch.zeros(1, 1, 200, 64)
    with pytest.raises(ValueError, match="bfloat16"):
        bwd._launch("long", q, q, q, None, q)


# ------------------------------------------------------- MIL-NCE text grad


def dt_schedule(v, t, pm, cv, lse, gv, gt, inv_temp, sms):
    """dt as milnce_dt_wgmma_kernel computes it, block by block."""
    vnum, vden, tnum, tden = (x.float() for x in lse)
    S, R, C = v.shape
    shared = t.dim() == 2
    K = t.shape[-2]
    out_layers = 1 if shared else S
    layers = S // out_layers
    ctiles, rtiles = -(-K // 64), -(-R // 64)
    splits = milnce._wave_splits(ctiles * out_layers, rtiles, sms)
    per = -(-rtiles // splits)
    splits = -(-rtiles // per)
    nb0 = (C // 64 + 1) // 2 * 64  # consumer 0's channels
    part = torch.zeros(splits, out_layers, K, C)
    for kb in range(ctiles):
        cols = slice(64 * kb, min(64 * kb + 64, K))
        for y in range(out_layers):
            for sp in range(splits):
                acc = torch.zeros(cols.stop - cols.start, C)
                for s in range(y * layers, (y + 1) * layers):
                    tc = (t if shared else t[s])[cols].float()
                    for it in range(sp * per, min(sp * per + per, rtiles)):
                        rows = slice(64 * it, min(64 * it + 64, R))
                        vr = v[s, rows].float()
                        # sim^T [k, r]: each consumer's channels, then the swap
                        x = (tc[:, :nb0] @ vr[:, :nb0].T + tc[:, nb0:] @ vr[:, nb0:].T) * inv_temp
                        pos = pm[rows, cols].T
                        keep = cv[cols][:, None]
                        vn, vd, g_v = (z[s, rows][None] for z in (vnum, vden, gv.float()))
                        kn, kd, g_t = (z[s, cols][:, None] for z in (tnum, tden, gt.float()))
                        zero = torch.zeros(())
                        d = (torch.where(keep, g_v * (x - vd).exp() + g_t * (x - kd).exp(), zero)
                             - torch.where(pos, g_v * (x - vn).exp() + g_t * (x - kn).exp(), zero))
                        d = (d * inv_temp).to(v.dtype).float()
                        acc[:, :nb0] += d @ vr[:, :nb0]
                        acc[:, nb0:] += d @ vr[:, nb0:]
                part[sp, y, cols] = acc
    dt = part[0].clone()
    for sp in range(1, splits):  # the reduce kernel's fixed order
        dt += part[sp]
    return (dt[0] if shared else dt).to(t.dtype)


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


def _jax_bwd(v, t, pm, cv, lse, gv, gt, tiled):
    """(dv, dt) of the JAX backward kernel (untiled _bwd_call, or the
    column-tiled _bwd_call_tiled), interpret mode; a shared text is broadcast
    and its gradient summed over the layers, as fused_milnce_elements does."""
    S, R, _ = v.shape
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
    dt = np.asarray(dt, np.float32)
    return np.asarray(dv, np.float32), dt.sum(0) if t.ndim == 2 else dt


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("tiled", [False, True])
def test_dt_schedule_matches_jax_kernels_and_plain_f32(shared, tiled):
    """Ragged R and K (two row tiles, two column blocks), C = 192 (three
    channel chunks: 2 + 1 over the consumers), a split of the row stream."""
    v, t, pm, cv, gv, gt = _milnce_problem(int(shared) + 2 * int(tiled), 3, 96, 70, 192, shared)
    tv, tt, tpm, tcv, tgv, tgt = (to_torch(x) for x in (v, t, pm, cv, gv, gt))
    lse = milnce.milnce_lse_reference(tv, tt, tpm, tcv, MV, INV_TEMP)
    ours = dt_schedule(tv, tt, tpm, tcv, lse, tgv, tgt, INV_TEMP, sms=4)
    plain = milnce.milnce_grad_reference(tv, tt, tpm, tcv, lse, tgv, tgt, INV_TEMP)[1]
    assert ours.shape == tt.shape
    torch.testing.assert_close(ours, plain, rtol=F32_TOL, atol=F32_TOL)
    ref = _jax_bwd(v, t, pm, cv, lse, gv, gt, tiled)[1]
    np.testing.assert_allclose(ours.numpy(), ref, atol=JAX_MILNCE_TOL, rtol=6 * JAX_MILNCE_TOL)


@pytest.mark.parametrize("shared", [False, True])
def test_dt_schedule_bf16_rounds_as_the_plain_version(shared):
    """bf16 features and dsim rounded to bf16: against milnce_grad_reference
    and the JAX kernel in bf16 by the chip check's limit."""
    v, t, pm, cv, gv, gt = _milnce_problem(7 + int(shared), 2, 80, 64, 128, shared)
    tv, tt = to_torch(v).bfloat16(), to_torch(t).bfloat16()
    tpm, tcv, tgv, tgt = (to_torch(x) for x in (pm, cv, gv, gt))
    lse = milnce.milnce_lse_reference(tv, tt, tpm, tcv, MV, INV_TEMP)
    ours = dt_schedule(tv, tt, tpm, tcv, lse, tgv, tgt, INV_TEMP, sms=132)
    plain = milnce.milnce_grad_reference(tv, tt, tpm, tcv, lse, tgv, tgt, INV_TEMP)[1]
    assert ours.dtype == torch.bfloat16 and elem_err(ours, plain) <= BF16_TOL
    S, R, _ = v.shape
    tt_np = np.broadcast_to(tt.float().numpy(), (S,) + tuple(tt.shape)) if shared else tt.float().numpy()
    vnum, vden, tnum, tden = (jnp.asarray(x.numpy()) for x in lse)
    _, ref = pallas_milnce._bwd_call(
        jnp.asarray(tv.float().numpy(), jnp.bfloat16),
        jnp.asarray(np.ascontiguousarray(tt_np), jnp.bfloat16),
        jnp.asarray(pm.astype(np.float32)), jnp.asarray(cv.astype(np.float32))[None],
        vnum, vden, tnum, tden, jnp.asarray(-gv), jnp.asarray(gv), jnp.asarray(-gt),
        jnp.asarray(gt), True, INV_TEMP, MV, 8)
    ref = np.asarray(ref, np.float32)
    ref = ref.sum(0) if shared else ref
    assert elem_err(ours, torch.from_numpy(ref)) <= BF16_TOL


# ------------------------------------------------------ MIL-NCE video grad


def dv_schedule(v, t, pm, cv, lse, gv, gt, inv_temp, sms):
    """dv as milnce_grad_wgmma_kernel<ROWS_OUTER> computes it, block by block."""
    vnum, vden, tnum, tden = (x.float() for x in lse)
    S, R, C = v.shape
    shared = t.dim() == 2
    K = t.shape[-2]
    rtiles, ctiles = -(-R // 64), -(-K // 64)
    splits = milnce._wave_splits(rtiles * S, ctiles, sms)
    per = -(-ctiles // splits)
    splits = -(-ctiles // per)
    nb0 = (C // 64 + 1) // 2 * 64  # consumer 0's channels
    part = torch.zeros(splits, S, R, C)
    for rb in range(rtiles):
        rows = slice(64 * rb, min(64 * rb + 64, R))
        for s in range(S):  # one output layer per block
            vr = v[s, rows].float()
            vn, vd, g_v = (z[s, rows][:, None] for z in (vnum, vden, gv.float()))
            for sp in range(splits):
                acc = torch.zeros(rows.stop - rows.start, C)
                for it in range(sp * per, min(sp * per + per, ctiles)):
                    cols = slice(64 * it, min(64 * it + 64, K))
                    tc = (t if shared else t[s])[cols].float()
                    # sim [r, k]: each consumer's channels, then the swap
                    x = (vr[:, :nb0] @ tc[:, :nb0].T + vr[:, nb0:] @ tc[:, nb0:].T) * inv_temp
                    pos = pm[rows, cols]
                    keep = cv[cols][None]
                    kn, kd, g_t = (z[s, cols][None] for z in (tnum, tden, gt.float()))
                    zero = torch.zeros(())
                    d = (torch.where(keep, g_v * (x - vd).exp() + g_t * (x - kd).exp(), zero)
                         - torch.where(pos, g_v * (x - vn).exp() + g_t * (x - kn).exp(), zero))
                    d = (d * inv_temp).to(v.dtype).float()
                    acc[:, :nb0] += d @ tc[:, :nb0]
                    acc[:, nb0:] += d @ tc[:, nb0:]
                part[sp, s, rows] = acc
    dv = part[0].clone()  # one split: the accumulators straight to the output
    for sp in range(1, splits):  # the reduce kernel's fixed order
        dv += part[sp]
    return dv.to(v.dtype)


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("tiled", [False, True])
def test_dv_schedule_matches_jax_kernels_and_plain_f32(shared, tiled):
    """Ragged R and K (two row blocks, two column tiles), C = 192 (three
    channel chunks: 2 + 1 over the consumers), the column stream in two
    splits."""
    v, t, pm, cv, gv, gt = _milnce_problem(11 + int(shared) + 2 * int(tiled), 3, 96, 70, 192,
                                           shared)
    tv, tt, tpm, tcv, tgv, tgt = (to_torch(x) for x in (v, t, pm, cv, gv, gt))
    lse = milnce.milnce_lse_reference(tv, tt, tpm, tcv, MV, INV_TEMP)
    assert milnce._wave_splits(2 * 3, 2, 4) == 2
    ours = dv_schedule(tv, tt, tpm, tcv, lse, tgv, tgt, INV_TEMP, sms=4)
    plain = milnce.milnce_grad_reference(tv, tt, tpm, tcv, lse, tgv, tgt, INV_TEMP)[0]
    assert ours.shape == tv.shape
    torch.testing.assert_close(ours, plain, rtol=F32_TOL, atol=F32_TOL)
    ref = _jax_bwd(v, t, pm, cv, lse, gv, gt, tiled)[0]
    np.testing.assert_allclose(ours.numpy(), ref, atol=JAX_MILNCE_TOL, rtol=6 * JAX_MILNCE_TOL)


@pytest.mark.parametrize("shared", [False, True])
def test_dv_schedule_bf16_rounds_as_the_plain_version(shared):
    """bf16 features, dsim rounded to bf16, one split (no partials): against
    milnce_grad_reference and the JAX kernel in bf16 by the chip check's
    limit."""
    v, t, pm, cv, gv, gt = _milnce_problem(17 + int(shared), 2, 80, 72, 128, shared)
    tv, tt = to_torch(v).bfloat16(), to_torch(t).bfloat16()
    tpm, tcv, tgv, tgt = (to_torch(x) for x in (pm, cv, gv, gt))
    lse = milnce.milnce_lse_reference(tv, tt, tpm, tcv, MV, INV_TEMP)
    assert milnce._wave_splits(2 * 2, 2, 2) == 1  # 4 blocks on 2 SMs: two waves either way
    ours = dv_schedule(tv, tt, tpm, tcv, lse, tgv, tgt, INV_TEMP, sms=2)
    plain = milnce.milnce_grad_reference(tv, tt, tpm, tcv, lse, tgv, tgt, INV_TEMP)[0]
    assert ours.dtype == torch.bfloat16 and elem_err(ours, plain) <= BF16_TOL
    S, R, _ = v.shape
    tt_np = np.broadcast_to(tt.float().numpy(), (S,) + tuple(tt.shape)) if shared else tt.float().numpy()
    vnum, vden, tnum, tden = (jnp.asarray(x.numpy()) for x in lse)
    ref, _ = pallas_milnce._bwd_call(
        jnp.asarray(tv.float().numpy(), jnp.bfloat16),
        jnp.asarray(np.ascontiguousarray(tt_np), jnp.bfloat16),
        jnp.asarray(pm.astype(np.float32)), jnp.asarray(cv.astype(np.float32))[None],
        vnum, vden, tnum, tden, jnp.asarray(-gv), jnp.asarray(gv), jnp.asarray(-gt),
        jnp.asarray(gt), True, INV_TEMP, MV, 8)
    assert elem_err(ours, torch.from_numpy(np.asarray(ref, np.float32))) <= BF16_TOL


@pytest.mark.parametrize("blocks,inner,sms,expected", [
    (96, 64, 132, 4),  # per-layer text at B = 64: 6 layers x 16 column blocks
    (16, 64, 132, 8),  # shared text at B = 64
    (1, 1, 132, 1), (6, 2, 4, 2)])
def test_wave_splits_balance_the_last_wave(blocks, inner, sms, expected):
    assert milnce._wave_splits(blocks, inner, sms) == expected


@pytest.mark.parametrize("blocks,inner,sms,expected", [
    (64 * 6, 16, 132, 1),  # milnce_dv at B = 64: 64 row blocks x 6 layers, 16 column tiles
    (128 * 6, 32, 132, 1), (64 * 2, 80, 132, 1)])  # B = 128; K = 5120
def test_wave_splits_leave_the_video_gradient_in_one_split(blocks, inner, sms, expected):
    """At the training and tiled-kernel shapes dv streams its columns in one
    split, so it writes no partials."""
    assert milnce._wave_splits(blocks, inner, sms) == expected


@pytest.mark.parametrize("dtype,expected", [(torch.bfloat16, "wgmma"), (torch.float32, "f32")])
def test_milnce_dv_route_depends_on_dtype(dtype, expected, monkeypatch):
    """The route names the kernel _grad launches; the uncounted earlier
    kernel (milnce_dv_v2) takes bf16 only."""
    seen = []
    monkeypatch.setattr(milnce, "_grad", lambda name, *a: seen.append((name, a[-1])))
    before = dict(milnce.milnce_dv.launches_by_route)
    x = torch.zeros(2, 2, dtype=dtype)
    milnce.milnce_dv(x, x, None, None, None, None, None, 1.0)
    if dtype == torch.bfloat16:
        milnce.milnce_dv_v2(x, x, None, None, None, None, None, 1.0)  # uncounted
    else:
        with pytest.raises(ValueError, match="bfloat16"):
            milnce.milnce_dv_v2(x, x, None, None, None, None, None, 1.0)
    assert milnce.dv_route(dtype) == expected
    assert seen == [("milnce_dv", expected)] + ([("milnce_dv", "v2")] if expected == "wgmma"
                                                else [])
    after = milnce.milnce_dv.launches_by_route
    assert {r: after[r] - before[r] for r in after} == {
        r: int(r == expected) for r in milnce.DV_ROUTES}


@pytest.mark.parametrize("dtype,expected", [(torch.bfloat16, "wgmma"), (torch.float32, "f32")])
def test_milnce_dt_route_depends_on_dtype(dtype, expected, monkeypatch):
    seen = []
    monkeypatch.setattr(milnce, "_grad", lambda *a: seen.append(a[-1]))
    before = dict(milnce.milnce_dt.launches_by_route)
    x = torch.zeros(2, 2, dtype=dtype)
    milnce.milnce_dt(x, x, None, None, None, None, None, 1.0)
    assert milnce.dt_route(dtype) == expected and seen == [expected]
    after = milnce.milnce_dt.launches_by_route
    assert {r: after[r] - before[r] for r in after} == {
        r: int(r == expected) for r in milnce.DT_ROUTES}


# ---------------------------------------------------------- MIL-NCE forward


def milnce_fwd_schedule(v, t, pm, cv, mv, inv_temp):
    """(vnum, vden [S, R], tnum, tden [S, K]) as milnce_fwd_wgmma_kernel and
    milnce_colmerge_kernel compute them, block by block."""
    S, R, C = v.shape
    shared = t.dim() == 2
    K = t.shape[-2]
    rtiles, ctiles = -(-R // 64), -(-K // 64)
    nb0 = (C // 64 + 1) // 2 * 64  # consumer 0's channels
    c2, mv2, ln2 = inv_temp * math.log2(math.e), mv * math.log2(math.e), math.log(2.0)
    ninf = torch.tensor(-math.inf)
    ref = lambda m: torch.where(m == -math.inf, torch.zeros(()), m)  # the select of ex2_ref

    def merge(m, s, m2, s2):  # log2-domain (max, sum) pairs
        mx = torch.maximum(m, m2)
        r = ref(mx)
        return mx, s * torch.exp2(m - r) + s2 * torch.exp2(m2 - r)

    def tile(x, n, width):  # rows past n zero-filled, as TMA fills them
        out = torch.zeros((64,) + x.shape[1:], dtype=x.dtype)
        out[:n] = x
        return out if width is None else out[:, :width]

    rows_out = torch.zeros(2, S, R)  # vnum, vden
    part = torch.zeros(4, S, rtiles, K)  # mp, sp, mn, sn per row block
    for s in range(S):
        for rb in range(rtiles):
            rs_ = slice(64 * rb, min(64 * rb + 64, R))
            nr = rs_.stop - rs_.start
            vr = tile(v[s, rs_].float(), nr, None)
            rlive = torch.arange(64) < nr
            rm = torch.full((2, 2, 64), -math.inf)  # [pos / neg, consumer, row]
            rsum = torch.zeros(2, 2, 64)
            for it in range(ctiles):
                cs = slice(64 * it, min(64 * it + 64, K))
                nk = cs.stop - cs.start
                tc = tile((t if shared else t[s])[cs].float(), nk, None)
                x = (vr[:, :nb0] @ tc[:, :nb0].T + vr[:, nb0:] @ tc[:, nb0:].T) * c2
                pmt = tile(tile(pm[rs_, cs], nr, None).T, nk, None).T  # [64 r][64 k]
                cvt = tile(cv[cs], nk, None)
                live = rlive[:, None] & (torch.arange(64) < nk)[None]
                xs = [torch.where(live, torch.where(keep, x, torch.tensor(mv2)), ninf)
                      for keep in (pmt, cvt[None].expand(64, 64))]
                for q, xq in enumerate(xs):
                    for h in range(2):  # each consumer's 32 columns into its row states
                        xh = xq[:, 32 * h:32 * h + 32]
                        tm = xh.amax(1)
                        rm[q, h], rsum[q, h] = merge(rm[q, h], rsum[q, h], tm,
                                                     torch.exp2(xh - ref(tm)[:, None]).sum(1))
                    cm = xq.amax(0)  # the row block's column (max, sum)
                    csum = torch.exp2(xq - ref(cm)[None]).sum(0)
                    part[2 * q, s, rb, cs] = (cm * ln2)[:nk]
                    part[2 * q + 1, s, rb, cs] = csum[:nk]
            for q in range(2):  # the two consumers' row states
                m, ssum = merge(rm[q, 0], rsum[q, 0], rm[q, 1], rsum[q, 1])
                rows_out[q, s, rs_] = ((m + torch.log2(ssum)) * ln2)[:nr]
    return (rows_out[0], rows_out[1]) + colmerge_schedule(part)


def colmerge_schedule(part):
    """(tnum, tden [S, K]) from the column partials [4, S, row blocks, K]
    (natural-log (max, sum) pairs: planes mp, sp, mn, sn) as
    milnce_colmerge_kernel folds them: eight groups of ceil(row blocks / 8),
    each in order, then the groups in order."""
    nrb = part.shape[2]
    per = -(-nrb // 8)

    def fold(m, s, m2, s2):  # lse_merge: an all -inf pair leaves (m, s) as it is
        mx = torch.maximum(m, m2)
        live = mx > -math.inf
        r = torch.where(live, mx, torch.zeros(()))
        return mx, torch.where(live, s * torch.exp(m - r) + s2 * torch.exp(m2 - r), s)

    out = []
    for q in range(2):
        empty = (torch.full(part.shape[1::2], -math.inf), torch.zeros(part.shape[1::2]))
        groups = []
        for w in range(8):
            m, ssum = empty
            for rb in range(w * per, min(nrb, w * per + per)):
                m, ssum = fold(m, ssum, part[2 * q, :, rb], part[2 * q + 1, :, rb])
            groups.append((m, ssum))
        m, ssum = groups[0]
        for m2, s2 in groups[1:]:
            m, ssum = fold(m, ssum, m2, s2)
        out.append(m + torch.log(ssum))
    return tuple(out)


def _jax_fwd(v, t, pm, cv, tiled):
    """(vnum, vden, tnum, tden) of the JAX forward kernel (untiled _fwd_call,
    or the column-tiled _fwd_call_tiled), interpret mode; a shared text is
    broadcast over the layers, as fused_milnce_elements does."""
    S = v.shape[0]
    K = t.shape[-2]
    tt = np.broadcast_to(t, (S,) + t.shape) if t.ndim == 2 else t
    args = (jnp.asarray(v), jnp.asarray(np.ascontiguousarray(tt)),
            jnp.asarray(pm.astype(np.float32)), jnp.asarray(cv.astype(np.float32))[None])
    if tiled:
        out = pallas_milnce._fwd_call_tiled(*args, True, INV_TEMP, MV, 8, K // 2)
    else:
        out = pallas_milnce._fwd_call(*args, True, INV_TEMP, MV, 8)
    vnum, vden, mp, sp, mn, sn = (np.asarray(x, np.float32) for x in out)
    return vnum, vden, mp + np.log(sp), mn + np.log(sn)


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("tiled", [False, True])
def test_milnce_fwd_schedule_matches_jax_kernels_and_plain_f32(shared, tiled):
    """Ragged R and K (two row blocks, two column tiles, the second's upper
    consumer half all past K), C = 192 (three channel chunks: 2 + 1 over the
    consumers), a row without a positive, padded columns."""
    v, t, pm, cv, _, _ = _milnce_problem(21 + int(shared) + 2 * int(tiled), 3, 96, 70, 192,
                                         shared)
    tv, tt, tpm, tcv = (to_torch(x) for x in (v, t, pm, cv))
    ours = milnce_fwd_schedule(tv, tt, tpm, tcv, MV, INV_TEMP)
    plain = milnce.milnce_lse_reference(tv, tt, tpm, tcv, MV, INV_TEMP)
    jax_ref = _jax_fwd(v, t, pm, cv, tiled)
    for a, b, c, name in zip(ours, plain, jax_ref, ("vnum", "vden", "tnum", "tden")):
        assert a.shape == b.shape and bool(torch.isfinite(a).all()), name
        torch.testing.assert_close(a, b, rtol=F32_TOL, atol=F32_TOL, msg=name)
        np.testing.assert_allclose(a.numpy(), c, atol=JAX_MILNCE_TOL, rtol=6 * JAX_MILNCE_TOL,
                                   err_msg=name)


def test_milnce_fwd_schedule_masks_with_mask_value_and_drops_dead_entries():
    """Masked but live entries count as mask_value, never -inf: a row without
    a positive gives vnum = mask_value + ln K, a padded column tnum = tden =
    mask_value + ln R; the zero-filled rows and columns past R and K count
    as nothing."""
    v, t, pm, cv, _, _ = _milnce_problem(25, 2, 100, 70, 64, False)
    tv, tt, tpm, tcv = (to_torch(x) for x in (v, t, pm, cv))
    vnum, _, tnum, tden = milnce_fwd_schedule(tv, tt, tpm, tcv, MV, INV_TEMP)
    torch.testing.assert_close(vnum[:, 3], torch.full((2,), MV + math.log(70)), rtol=0,
                               atol=1e-2)
    pad = ~tcv
    assert int(pad.sum()) > 0
    for x in (tnum, tden):
        torch.testing.assert_close(x[:, pad], torch.full_like(x[:, pad], MV + math.log(100)),
                                   rtol=0, atol=1e-2)


@pytest.mark.parametrize("shared", [False, True])
def test_milnce_fwd_schedule_bf16_is_within_the_chip_limit(shared):
    """bf16 features: against milnce_lse_reference on the same features, per
    element by the chip check's limit."""
    v, t, pm, cv, _, _ = _milnce_problem(27 + int(shared), 2, 80, 72, 128, shared)
    tv, tt = to_torch(v).bfloat16(), to_torch(t).bfloat16()
    tpm, tcv = to_torch(pm), to_torch(cv)
    ours = milnce_fwd_schedule(tv, tt, tpm, tcv, MV, INV_TEMP)
    plain = milnce.milnce_lse_reference(tv, tt, tpm, tcv, MV, INV_TEMP)
    for a, b in zip(ours, plain):
        assert a.dtype == torch.float32 and elem_err(a, b) <= MILNCE_VALUE_TOL


@pytest.mark.parametrize("dtype,expected", [(torch.bfloat16, "wgmma"), (torch.float32, "f32")])
def test_milnce_fwd_route_depends_on_dtype(dtype, expected, monkeypatch):
    seen = []
    monkeypatch.setattr(milnce, "_fwd", lambda *a, wgmma=False: seen.append(wgmma))
    before = dict(milnce.milnce_fwd.launches_by_route)
    launches = milnce.milnce_fwd.launches
    x = torch.zeros(2, 2, dtype=dtype)
    milnce.milnce_fwd(x, x, None, None, MV, 1.0)
    assert milnce.fwd_route(dtype) == expected and seen == [expected == "wgmma"]
    after = milnce.milnce_fwd.launches_by_route
    assert {r: after[r] - before[r] for r in after} == {
        r: int(r == expected) for r in milnce.FWD_ROUTES}
    assert milnce.milnce_fwd.launches == launches + 1


def test_milnce_fwd_v1_launches_the_earlier_kernel_uncounted(monkeypatch):
    seen = []
    monkeypatch.setattr(milnce, "_fwd", lambda *a, wgmma=False: seen.append(wgmma))
    counts = lambda: (milnce.milnce_fwd.launches, dict(milnce.milnce_fwd.launches_by_route))
    before = counts()
    x = torch.zeros(2, 2, dtype=torch.bfloat16)
    milnce.milnce_fwd_v1(x, x, None, None, MV, 1.0)
    assert seen == [False] and counts() == before
    with pytest.raises(ValueError, match="bfloat16"):
        milnce.milnce_fwd_v1(x.float(), x.float(), None, None, MV, 1.0)
