"""The port's kernel wrappers: device dispatch and input checks on the CPU,
and on a card each kernel against its plain PyTorch version.  Imports no JAX, so the
card's tests run on a machine without it:

    python -m pytest tests/test_torch_kernels.py -m cuda
"""

import pytest
import torch

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
                                   (1, 8, 1088, 64), (2, 3, 5, 64)])
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
