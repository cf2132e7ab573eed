"""The port's kernel wrappers: device dispatch and input checks on the CPU,
and on a card each kernel against its plain PyTorch version.  Imports no JAX, so the
card's tests run on a machine without it:

    python -m pytest tests/test_torch_kernels.py -m cuda
"""

import pytest
import torch

from chip_smoke import (BF16_TOL, GRAD_TOL, MILNCE_LSE_F32_TOL, MILNCE_VALUE_TOL, elem_err,
                        lse_err, mha_bwd_dropped_rowsum, milnce_fwd_faults, milnce_problem)
from temporalalignnet_torch.core.config import ModelConfig
from temporalalignnet_torch.models.net import TANWithText
from temporalalignnet_torch.ops.attention import attention_reference, multihead_attention
from temporalalignnet_torch.ops.mha_fwd import mha_fwd

torch.set_num_threads(2)


def _qkv(shape, dtype=torch.float32, device="cpu", seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g).to(device, dtype) for _ in range(3))
    mask = torch.rand(shape[0], shape[2], generator=g) < 0.3
    mask[:, 0] = False
    mask[-1] = True  # a fully padded row
    return q, k, v, mask.to(device)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_cpu_tensor_routes_to_reference():
    q, k, v, mask = _qkv((2, 4, 24, 64))
    before = mha_fwd.launches
    out = multihead_attention(q, k, v, mask)
    assert mha_fwd.launches == before
    torch.testing.assert_close(out, attention_reference(q, k, v, mask), rtol=0, atol=0)


def test_kernel_wrapper_refuses_cpu_tensors():
    q = torch.zeros(1, 8, 16, 64)
    with pytest.raises(ValueError, match="CUDA"):
        mha_fwd(q, q, q)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", [(4, 8, 64, 64), (3, 8, 72, 64), (2, 8, 200, 64),
                                   (1, 8, 1088, 64), (2, 3, 5, 64),
                                   # the towers': BERT, CLIP ViT, TimeSformer
                                   (16, 12, 32, 64), (4, 12, 50, 64), (24, 12, 8, 64),
                                   (2, 12, 197, 64)])
def test_kernel_matches_reference_on_card(cuda, shape, dtype, tol):
    q, k, v, mask = _qkv(shape, dtype, cuda)
    for m in (None, mask):
        before = mha_fwd.launches
        out = multihead_attention(q, k, v, m)
        torch.cuda.synchronize()
        assert mha_fwd.launches == before + 1 and out.dtype == dtype
        ref = attention_reference(q.float(), k.float(), v.float(), m)
        assert (out.float() - ref).abs().max().item() <= tol


@pytest.mark.cuda
def test_kernel_wrapper_refuses_what_it_does_not_take(cuda):
    q, k, v, mask = _qkv((2, 8, 64, 64), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        mha_fwd(q.transpose(2, 3), k, v)
    with pytest.raises(ValueError, match="head dims"):
        mha_fwd(*(t[..., :32].contiguous() for t in (q, k, v)))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        mha_fwd(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="key_padding_mask"):
        mha_fwd(q, k, v, mask[:, :10].contiguous())


def test_bf16_limit_catches_the_planted_attention_forward_fault():
    """The chip check's bf16 limit for mha_fwd against its planted fault:
    padded keys left unmasked, from the same bf16 inputs."""
    q, k, v, mask = _qkv((4, 2, 64, 64), torch.bfloat16)
    ref = attention_reference(q.float(), k.float(), v.float(), mask)
    fault = attention_reference(q.float(), k.float(), v.float(), None)
    assert (fault - ref).abs().max().item() > BF16_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,B,S,expected", [
    (torch.bfloat16, 2, 37, "short"), (torch.bfloat16, 2, 80, "short"),
    (torch.bfloat16, 2, 200, "long"), (torch.bfloat16, 1, 1088, "long"),
    (torch.float32, 2, 80, "f32")])
def test_mha_fwd_takes_the_route_of_its_dtype_and_length_on_card(cuda, dtype, B, S, expected):
    """One launch on the expected route (at [1, 8, 1088, 64] with key splits);
    in bf16 the earlier kernel (mha_fwd_v1) too, both against the plain
    version."""
    from temporalalignnet_torch.ops.mha_fwd import mha_fwd_v1

    q, k, v, mask = _qkv((B, 8, S, 64), dtype, cuda)
    tol = BF16_TOL if dtype == torch.bfloat16 else 1e-5
    for m in (None, mask):
        before = dict(mha_fwd.launches_by_route)
        out = mha_fwd(q, k, v, m)
        torch.cuda.synchronize()
        after = mha_fwd.launches_by_route
        assert {r: n - before[r] for r, n in after.items() if n != before[r]} == {expected: 1}
        ref = attention_reference(q.float(), k.float(), v.float(), m)
        versions = [out] + ([mha_fwd_v1(q, k, v, m)] if dtype == torch.bfloat16 else [])
        for o in versions:
            assert o.dtype == dtype and (o.float() - ref).abs().max().item() <= tol


@pytest.mark.cuda
def test_model_forward_launches_the_kernel_in_every_block(cuda):
    cfg = ModelConfig(width=128, heads=2, num_encoder_layers=2, num_joint_layers=3,
                      video_embed_dim=32, num_pos_embeds=128, use_alignability_head=True)
    cpu = TANWithText(cfg, vocab_size=51).init_weights(torch.Generator().manual_seed(0)).eval()
    card = TANWithText(cfg, vocab_size=51).to(cuda).eval()
    card.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(1)
    video, text = torch.randn(3, 20, 32, generator=g), torch.randn(3, 5, 512, generator=g)
    vpad = torch.zeros(3, 20, dtype=torch.bool)
    vpad[1, 12:] = True
    before = mha_fwd.launches
    with torch.no_grad():
        ours = card.text_visual_sims(video.to(cuda), text.to(cuda), vpad.to(cuda))
        ref = cpu.text_visual_sims(video, text, vpad)
    assert mha_fwd.launches == before + 5
    for key in ref:
        torch.testing.assert_close(ours[key].cpu(), ref[key], rtol=0, atol=1e-4, msg=key)


# ------------------------------------------------------ attention backward


def test_kernel_attention_function_routes_through_both_kernels(monkeypatch):
    """KernelAttention on CPU tensors with fake kernels: the forward goes to
    mha_fwd, the backward to mha_bwd, and the grads are the reference's."""
    from temporalalignnet_torch.ops import attention, mha_bwd as bwd_mod, mha_fwd as fwd_mod

    calls = []

    def fake_fwd(q, k, v, mask):
        calls.append("fwd")
        assert not torch.is_grad_enabled()  # the Function's forward runs untracked
        return attention_reference(q, k, v, mask)

    def fake_bwd(q, k, v, mask, dout):
        calls.append("bwd")
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            out = attention_reference(*qkv, mask)
            return torch.autograd.grad(out, qkv, dout)

    monkeypatch.setattr(fwd_mod, "mha_fwd", fake_fwd)
    monkeypatch.setattr(bwd_mod, "mha_bwd", fake_bwd)
    q, k, v, mask = _qkv((2, 4, 24, 64))
    ours = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(3))
    attention.KernelAttention.apply(*ours, mask).backward(g)
    attention_reference(*ref, mask).backward(g)
    assert calls == ["fwd", "bwd"]
    for a, b in zip(ours, ref):
        torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=0)


def test_mha_fwd_refuses_a_call_autograd_would_track():
    q = torch.zeros(1, 8, 16, 64, requires_grad=True)
    with pytest.raises(RuntimeError, match="detached"):
        mha_fwd(q, q, q)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        mha_fwd(q, q, q)  # untracked: only the device check is left


def test_mha_bwd_refuses_cpu_tensors():
    from temporalalignnet_torch.ops.mha_bwd import mha_bwd

    q = torch.zeros(1, 8, 16, 64)
    with pytest.raises(ValueError, match="CUDA"):
        mha_bwd(q, q, q, None, q)


def _attn_grads(q, k, v, mask, g, fn):
    qkv = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = fn(*qkv, mask)
    out.backward(g)
    return out.detach(), [t.grad for t in qkv]


def _grad_tol(dtype):
    """The chip check's limit for the gradient kernels (chip_smoke.GRAD_TOL)."""
    return GRAD_TOL[str(dtype).removeprefix("torch.")]


@pytest.mark.parametrize("masked", [False, True])
def test_mha_bwd_reference_is_the_autograd_of_attention_reference_in_f32(masked):
    from temporalalignnet_torch.ops.mha_bwd import mha_bwd_reference

    q, k, v, mask = _qkv((3, 2, 37, 64))
    mask = mask if masked else None
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(5))
    _, ref = _attn_grads(q, k, v, mask, g, attention_reference)
    for a, b in zip(mha_bwd_reference(q, k, v, mask, g), ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_bf16_grad_limit_catches_the_planted_attention_faults():
    """The chip check's bf16 limit against its planted faults: a dropped
    rowsum(dP P) and padded keys left unmasked, each compared with the plain
    version from the same bf16 inputs."""
    from temporalalignnet_torch.ops.mha_bwd import mha_bwd_reference

    q, k, v, mask = _qkv((4, 2, 64, 64), torch.bfloat16)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(5)).bfloat16()
    plain = mha_bwd_reference(q, k, v, mask, g)
    assert all(t.dtype == torch.bfloat16 for t in plain)
    for fault in (mha_bwd_dropped_rowsum(torch, q, k, v, mask, g),
                  mha_bwd_reference(q, k, v, None, g)):
        assert max(elem_err(a, b) for a, b in zip(fault, plain)) > _grad_tol(torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 8, 64, 64), (3, 8, 80, 64), (2, 3, 37, 64),
                                   (1, 2, 150, 64), (2, 2, 5, 64), (16, 12, 32, 64)])
def test_mha_bwd_matches_reference_grads_on_card(cuda, shape, dtype):
    """Grads of the kernel path against mha_bwd_reference (the plain version
    with the kernel's roundings) from the same inputs, per element."""
    from temporalalignnet_torch.ops.mha_bwd import mha_bwd, mha_bwd_reference

    q, k, v, mask = _qkv(shape, dtype, cuda)
    g = torch.randn(shape, generator=torch.Generator().manual_seed(5)).to(cuda, dtype)
    for m in (None, mask):
        before = (mha_fwd.launches, mha_bwd.launches)
        _, ours = _attn_grads(q, k, v, m, g, multihead_attention)
        torch.cuda.synchronize()
        assert (mha_fwd.launches, mha_bwd.launches) == (before[0] + 1, before[1] + 1)
        ref = mha_bwd_reference(q, k, v, m, g)
        for name, a, b in zip("qkv", ours, ref):
            assert a.dtype == dtype and bool(torch.isfinite(a).all()), name
            err = elem_err(a, b)
            assert err <= _grad_tol(dtype), (name, m is not None, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,S,expected", [(torch.bfloat16, 80, "fused"),
                                              (torch.bfloat16, 150, "long"),
                                              (torch.float32, 80, "f32")])
def test_mha_bwd_takes_the_route_of_its_dtype_and_length_on_card(cuda, dtype, S, expected):
    """One launch on the expected route, against the plain version; a second
    call is bit-equal (no route sums in a varying order)."""
    from temporalalignnet_torch.ops.mha_bwd import mha_bwd, mha_bwd_reference

    q, k, v, mask = _qkv((2, 4, S, 64), dtype, cuda)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(5)).to(cuda, dtype)
    before = dict(mha_bwd.launches_by_route)
    ours = mha_bwd(q, k, v, mask, g)
    torch.cuda.synchronize()
    moved = {r: n - before[r] for r, n in mha_bwd.launches_by_route.items() if n != before[r]}
    assert moved == {expected: 1}
    ref = mha_bwd_reference(q, k, v, mask, g)
    for a, b in zip(ours, ref):
        assert elem_err(a, b) <= _grad_tol(dtype)
    assert all(torch.equal(a, b) for a, b in zip(ours, mha_bwd(q, k, v, mask, g)))


@pytest.mark.cuda
def test_mha_bwd_refuses_what_it_does_not_take(cuda):
    from temporalalignnet_torch.ops.mha_bwd import mha_bwd

    q, k, v, mask = _qkv((2, 8, 64, 64), device=cuda)
    with pytest.raises(ValueError, match="dout"):
        mha_bwd(q, k, v, mask, q[:1])
    with pytest.raises(ValueError, match="head dims"):
        mha_bwd(*(t[..., :32].contiguous() for t in (q, k, v)), None, q[..., :32].contiguous())


@pytest.mark.cuda
def test_in_proj_grad_on_card_matches_cpu(cuda):
    """The repaired path: attention's weights get their gradient on the card."""
    cfg = ModelConfig(width=128, heads=2, num_encoder_layers=2, num_joint_layers=2,
                      video_embed_dim=32, num_pos_embeds=128, random_pos_start=False)
    cpu = TANWithText(cfg, vocab_size=51).init_weights(torch.Generator().manual_seed(0))
    card = TANWithText(cfg, vocab_size=51).to(cuda)
    card.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(1)
    video = torch.randn(3, 20, 32, generator=g)
    ids = torch.randint(0, 51, (3, 4, 8), generator=g)
    for model, dev in ((cpu, "cpu"), (card, cuda)):
        out = model(video.to(dev), ids.to(dev), deterministic=True)
        (out["logits_dual"].square().sum() + out["logits_joint"].square().sum()).backward()
    for name, p in cpu.named_parameters():
        if "attn.in_proj" in name:
            theirs = dict(card.named_parameters())[name].grad
            assert theirs is not None, name
            torch.testing.assert_close(theirs.cpu(), p.grad, rtol=1e-3, atol=1e-4, msg=name)


# ---------------------------------------------------------------- MIL-NCE


def _milnce_problem(S, R, K, C, shared, dtype=torch.float32, device="cpu", seed=0):
    g = torch.Generator().manual_seed(seed)
    unit = lambda *s: torch.nn.functional.normalize(torch.randn(*s, generator=g), dim=-1)
    v = unit(S, R, C)
    t = unit(K, C) if shared else unit(S, K, C)
    cv = torch.rand(K, generator=g) < 0.8
    pm = (torch.rand(R, K, generator=g) < 0.2) & cv[None]
    pm[3] = False  # a row with no positive
    gv, gt = torch.randn(S, R, generator=g), torch.randn(S, K, generator=g)
    return [x.to(device, dtype) for x in (v, t)] + [x.to(device) for x in (pm, cv, gv, gt)]


def test_milnce_cpu_tensor_routes_to_reference():
    from temporalalignnet_torch.ops import milnce

    v, t, pm, cv, _, _ = _milnce_problem(2, 16, 12, 64, shared=True)
    before = milnce.milnce_fwd.launches
    ours = milnce.fused_milnce_elements(v, t, pm, cv, -6e4, 1 / 0.07)
    ref = milnce.milnce_reference(v, t, pm, cv, -6e4, 1 / 0.07)
    assert milnce.milnce_fwd.launches == before
    for a, b in zip(ours, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_milnce_wrappers_refuse_cpu_tensors():
    from temporalalignnet_torch.ops import milnce

    v, t, pm, cv, gv, gt = _milnce_problem(2, 16, 12, 64, shared=False)
    with pytest.raises(ValueError, match="CUDA"):
        milnce.milnce_fwd(v, t, pm, cv, -6e4, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        milnce.milnce_dt(v, t, pm, cv, (gv, gv, gt, gt), gv, gt, 1.0)


@pytest.mark.parametrize("shared", [False, True])
def test_milnce_grad_reference_is_the_autograd_of_milnce_reference_in_f32(shared):
    """The plain version of milnce_dv / milnce_dt, from the logsumexps of
    milnce_lse_reference: a row without a positive, padded columns."""
    from temporalalignnet_torch.ops import milnce

    v, t, pm, cv, gv, gt = _milnce_problem(3, 40, 24, 64, shared)
    ref_in = [x.clone().requires_grad_() for x in (v, t)]
    ref = milnce.milnce_reference(*ref_in, pm, cv, -6e4, 1 / 0.07)
    (ref[0] * gv).sum().add((ref[1] * gt).sum()).backward()
    lse = milnce.milnce_lse_reference(v, t, pm, cv, -6e4, 1 / 0.07)
    torch.testing.assert_close(lse[1] - lse[0], ref[0], rtol=0, atol=0)
    ours = milnce.milnce_grad_reference(v, t, pm, cv, lse, gv, gt, 1 / 0.07)
    for a, x in zip(ours, ref_in):
        assert a.shape == x.shape
        torch.testing.assert_close(a, x.grad, rtol=1e-5, atol=1e-6)


def test_bf16_grad_limit_catches_the_planted_milnce_faults():
    """The chip check's bf16 limit against its planted faults: the column
    cotangent's term dropped, and padded columns left unmasked."""
    from temporalalignnet_torch.ops import milnce

    v, t, pm, cv, gv, gt = _milnce_problem(3, 64, 48, 64, False, torch.bfloat16)
    lse = milnce.milnce_lse_reference(v, t, pm, cv, -6e4, 1 / 0.07)
    plain = milnce.milnce_grad_reference(v, t, pm, cv, lse, gv, gt, 1 / 0.07)
    assert all(x.dtype == torch.bfloat16 for x in plain)
    every = torch.ones_like(cv)  # padded columns unmasked, forward and backward
    lse_every = milnce.milnce_lse_reference(v, t, pm, every, -6e4, 1 / 0.07)
    for fault in (milnce.milnce_grad_reference(v, t, pm, cv, lse, gv, 0 * gt, 1 / 0.07),
                  milnce.milnce_grad_reference(v, t, pm, every, lse_every, gv, gt, 1 / 0.07)):
        assert max(elem_err(a, b) for a, b in zip(fault, plain)) > _grad_tol(torch.bfloat16)


@pytest.mark.parametrize("shared", [False, True])
def test_value_limit_catches_the_planted_milnce_fwd_faults(shared):
    """The chip check's per-element limit on the four logsumexps against
    its planted faults (the last row block left out of the column
    logsumexps, padded columns left unmasked), on the loss's own masks at a
    reduced size: eight 64-frame videos, 16 sentences each, some padded."""
    from temporalalignnet_torch.ops import milnce

    gen = torch.Generator().manual_seed(1)
    v, t, pm, cv, _, _ = milnce_problem(torch, 2, 8, 64, 16, 64, shared, gen,
                                        torch.device("cpu"))
    lse = milnce.milnce_lse_reference(v, t, pm, cv, -6e4, 1 / 0.07)
    faults = milnce_fwd_faults(torch, v, t, pm, cv, lse, -6e4, 1 / 0.07)
    assert set(faults) == {"last_row_block_dropped", "padded_columns_unmasked"}
    for name, fault in faults.items():
        assert max(elem_err(a, b) for a, b in zip(fault, lse)) > MILNCE_VALUE_TOL, name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,R,K,C", [(3, 100, 70, 64), (2, 256, 320, 128), (6, 130, 30, 512)])
@pytest.mark.parametrize("shared", [False, True])
def test_milnce_kernels_match_reference_on_card(cuda, S, R, K, C, shared, dtype):
    """Values of the kernel path against milnce_reference and grads against
    milnce_grad_reference (dsim rounded as the kernels round it), from the
    same inputs, per element; ragged R and K, a row without a positive,
    padded columns."""
    from temporalalignnet_torch.ops import milnce

    v, t, pm, cv, gv, gt = _milnce_problem(S, R, K, C, shared, dtype, cuda)
    counts = lambda: (milnce.milnce_fwd.launches, milnce.milnce_dv.launches,
                      milnce.milnce_dt.launches)
    before = counts()
    ours_in = [x.detach().clone().requires_grad_() for x in (v, t)]
    ours = milnce.fused_milnce_elements(*ours_in, pm, cv, -6e4, 1 / 0.07)
    (ours[0] * gv).sum().add((ours[1] * gt).sum()).backward()
    torch.cuda.synchronize()
    assert counts() == tuple(c + 1 for c in before)
    ref = milnce.milnce_reference(v, t, pm, cv, -6e4, 1 / 0.07)
    lse = milnce.milnce_lse_reference(v, t, pm, cv, -6e4, 1 / 0.07)
    ref_grads = milnce.milnce_grad_reference(v, t, pm, cv, lse, gv, gt, 1 / 0.07)
    for a, b in zip(ours, ref):
        assert bool(torch.isfinite(a).all()) and elem_err(a, b) <= MILNCE_VALUE_TOL
    for x, y in zip(ours_in, ref_grads):
        assert x.grad.dtype == dtype and x.grad.shape == x.shape
        assert elem_err(x.grad, y) <= _grad_tol(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,expected", [(torch.bfloat16, "wgmma"), (torch.float32, "f32")])
@pytest.mark.parametrize("S,R,K,C", [(3, 100, 70, 192), (2, 256, 320, 128), (6, 130, 30, 512)])
@pytest.mark.parametrize("shared", [False, True])
def test_milnce_fwd_takes_the_route_of_its_dtype_on_card(cuda, dtype, expected, S, R, K, C,
                                                         shared):
    """One launch on the expected route; its four logsumexps, and in bf16 the
    earlier kernel's (milnce_fwd_v1), against milnce_lse_reference per
    element (in f32 also in logit units, lse_err): ragged R and K (the pm tile by TMA at K = 320, staged at 70 and
    30), a row without a positive, padded columns."""
    from temporalalignnet_torch.ops import milnce

    v, t, pm, cv, _, _ = _milnce_problem(S, R, K, C, shared, dtype, cuda)
    before = dict(milnce.milnce_fwd.launches_by_route)
    ours = milnce.milnce_fwd(v, t, pm, cv, -6e4, 1 / 0.07)
    torch.cuda.synchronize()
    after = milnce.milnce_fwd.launches_by_route
    assert {r: n - before[r] for r, n in after.items() if n != before[r]} == {expected: 1}
    ref = milnce.milnce_lse_reference(v, t, pm, cv, -6e4, 1 / 0.07)
    versions = [ours] + ([milnce.milnce_fwd_v1(v, t, pm, cv, -6e4, 1 / 0.07)]
                         if expected == "wgmma" else [])
    for lse in versions:
        for a, b in zip(lse, ref):
            assert a.shape == b.shape and bool(torch.isfinite(a).all())
            assert elem_err(a, b) <= MILNCE_VALUE_TOL
            if dtype == torch.float32:  # split TF32: f32 accuracy in logit units
                assert lse_err(a, b) <= MILNCE_LSE_F32_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,expected", [(torch.bfloat16, "wgmma"), (torch.float32, "f32")])
def test_milnce_dt_takes_the_route_of_its_dtype_on_card(cuda, dtype, expected):
    """One launch on the expected route; in bf16 the earlier kernel
    (milnce_dt_v2) too, both against the plain version."""
    from temporalalignnet_torch.ops import milnce

    v, t, pm, cv, gv, gt = _milnce_problem(3, 200, 96, 128, False, dtype, cuda)
    lse = milnce.milnce_lse_reference(v, t, pm, cv, -6e4, 1 / 0.07)
    before = dict(milnce.milnce_dt.launches_by_route)
    ours = milnce.milnce_dt(v, t, pm, cv, lse, gv, gt, 1 / 0.07)
    torch.cuda.synchronize()
    after = milnce.milnce_dt.launches_by_route
    assert {r: n - before[r] for r, n in after.items() if n != before[r]} == {expected: 1}
    ref = milnce.milnce_grad_reference(v, t, pm, cv, lse, gv, gt, 1 / 0.07)[1]
    versions = [ours] + ([milnce.milnce_dt_v2(v, t, pm, cv, lse, gv, gt, 1 / 0.07)]
                         if expected == "wgmma" else [])
    for dt in versions:
        assert dt.dtype == dtype and elem_err(dt, ref) <= _grad_tol(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,expected", [(torch.bfloat16, "wgmma"), (torch.float32, "f32")])
@pytest.mark.parametrize("S,R,K,C", [(3, 200, 96, 128), (2, 100, 48, 64)])
@pytest.mark.parametrize("shared", [False, True])
def test_milnce_dv_takes_the_route_of_its_dtype_on_card(cuda, dtype, expected, S, R, K, C,
                                                        shared):
    """One launch on the expected route (split column streams and one split);
    in bf16 the earlier kernel (milnce_dv_v2) too, both against the plain
    version."""
    from temporalalignnet_torch.ops import milnce

    v, t, pm, cv, gv, gt = _milnce_problem(S, R, K, C, shared, dtype, cuda)
    lse = milnce.milnce_lse_reference(v, t, pm, cv, -6e4, 1 / 0.07)
    before = dict(milnce.milnce_dv.launches_by_route)
    ours = milnce.milnce_dv(v, t, pm, cv, lse, gv, gt, 1 / 0.07)
    torch.cuda.synchronize()
    after = milnce.milnce_dv.launches_by_route
    assert {r: n - before[r] for r, n in after.items() if n != before[r]} == {expected: 1}
    ref = milnce.milnce_grad_reference(v, t, pm, cv, lse, gv, gt, 1 / 0.07)[0]
    versions = [ours] + ([milnce.milnce_dv_v2(v, t, pm, cv, lse, gv, gt, 1 / 0.07)]
                         if expected == "wgmma" else [])
    for dv in versions:
        assert dv.dtype == dtype and dv.shape == v.shape
        assert elem_err(dv, ref) <= _grad_tol(dtype)


@pytest.mark.cuda
def test_milnce_kernels_refuse_what_they_do_not_take(cuda):
    from temporalalignnet_torch.ops import milnce

    v, t, pm, cv, _, _ = _milnce_problem(2, 64, 64, 64, shared=False, device=cuda)
    with pytest.raises(ValueError, match="multiple of 64"):
        milnce.milnce_fwd(v[..., :32].contiguous(), t[..., :32].contiguous(), pm, cv, -6e4, 1.0)
    with pytest.raises(ValueError, match="pos_mask"):
        milnce.milnce_fwd(v, t, pm.float(), cv, -6e4, 1.0)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        milnce.milnce_fwd(v.half(), t.half(), pm, cv, -6e4, 1.0)
    with pytest.raises(ValueError, match="does not fit"):
        milnce.milnce_fwd(v, t[:1], pm, cv, -6e4, 1.0)
