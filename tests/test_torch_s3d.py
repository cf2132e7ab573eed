"""The port's S3D-G against the JAX package's, f32 on the CPU, on the same
weights (moved through s3d_state_dict_from_jax) and the same numpy inputs:
the TF-SAME pools, space-to-depth, the forward by both conv1 paths, the
weight round trip, the checkpoint reader, frozen BN and the bf16 dtype
chain."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flax.linen as nn
from port_fixtures import jax_s3d_variables, to_torch
from temporalalignnet_torch.checkpoint import (load_milnce_checkpoint, s3d_state_dict,
                                               s3d_state_dict_from_jax)
from temporalalignnet_torch.models.s3d import (S3D, fold_s2d_weight, max_pool_same,
                                               space_to_depth)
from temporalalignnet_tpu.checkpoint.s3d_convert import s3d_torch_to_variables
from temporalalignnet_tpu.models.s3d import S3D as JaxS3D
from temporalalignnet_tpu.models.s3d import space_to_depth as jax_space_to_depth

torch.set_num_threads(2)

ATOL, RTOL = 2e-4, 1e-3  # the S3D bar (tests/test_end2end.py:168-173)
CLIP = (1, 8, 64, 64, 3)
NUM_CLASSES = 512
# bf16 compute against f32 on one clip: ‖a − b‖ / ‖b‖ of the embedding
BF16_REL_NORM = 5e-2


@pytest.fixture(scope="module")
def jax_s3d():
    """The JAX S3D's variables (numpy, from a seed) and one jitted apply per
    conv1 path returning (embedding, logits)."""
    x = jnp.zeros(CLIP, jnp.float32)
    variables = jax.device_get(jax_s3d_variables(JaxS3D(num_classes=NUM_CLASSES), x, seed=3))
    applies = {}
    for fold in (True, False):
        model = JaxS3D(num_classes=NUM_CLASSES, fold_s2d=fold)
        applies[fold] = jax.jit(lambda v, x, m=model: (
            m.apply(v, x, return_embedding=True), m.apply(v, x)))
    return variables, applies


def _port(variables, **kw):
    model = S3D(num_classes=NUM_CLASSES, **kw)
    model.load_state_dict(s3d_state_dict_from_jax(variables), strict=True)
    return model.eval()


def _ncthw(x):
    return to_torch(x).permute(0, 4, 1, 2, 3)


# TF-SAME pools of every S3D shape, at sizes with symmetric and asymmetric
# padding: maxpool_4a at T = 4 (8 input frames) pads 0 before and 1 after
@pytest.mark.parametrize("kernel,stride,size", [
    ((3, 3, 3), (2, 2, 2), (4, 7, 8)), ((2, 2, 2), (2, 2, 2), (3, 5, 4)),
    ((1, 3, 3), (1, 2, 2), (2, 112, 9)), ((3, 3, 3), (1, 1, 1), (3, 6, 5))],
    ids=["maxpool_4a", "maxpool_5a", "maxpool_2a", "branch_3"])
def test_max_pool_same_matches_flax(kernel, stride, size):
    x = np.random.RandomState(0).randn(2, *size, 3).astype(np.float32)
    want = np.asarray(nn.max_pool(jnp.asarray(x), kernel, stride, padding="SAME"))
    got = max_pool_same(_ncthw(x), kernel, stride).permute(0, 2, 3, 4, 1).numpy()
    np.testing.assert_array_equal(got, want)


def test_space_to_depth_and_the_folded_conv1():
    """space_to_depth equals JAX's; the folded weight on the raw pixels is the
    s2d-space conv1 on the shuffled input."""
    rng = np.random.RandomState(1)
    x = rng.rand(2, 4, 16, 16, 3).astype(np.float32)
    s2d = space_to_depth(_ncthw(x))
    np.testing.assert_array_equal(s2d.permute(0, 2, 3, 4, 1).numpy(),
                                  np.asarray(jax_space_to_depth(jnp.asarray(x))))
    w = torch.from_numpy(rng.randn(8, 24, 2, 4, 4).astype(np.float32))
    explicit = torch.nn.functional.conv3d(s2d, w, padding=(1, 2, 2))
    folded = torch.nn.functional.conv3d(_ncthw(x), fold_s2d_weight(w), stride=2,
                                        padding=(2, 4, 4))
    torch.testing.assert_close(folded, explicit, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("fold", [True, False], ids=["folded_conv1", "explicit_s2d"])
def test_forward_matches_jax(jax_s3d, fold):
    variables, applies = jax_s3d
    x = np.random.RandomState(2).rand(*CLIP).astype(np.float32)
    want_emb, want_logits = (np.asarray(a) for a in applies[fold](variables, jnp.asarray(x)))
    model = _port(variables, fold_s2d=fold)
    with torch.no_grad():
        emb = model(_ncthw(x), return_embedding=True)
        logits = model(_ncthw(x))
    assert emb.shape == (1, 1024) and logits.shape == (1, NUM_CLASSES)
    np.testing.assert_allclose(emb.numpy(), want_emb, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(logits.numpy(), want_logits, atol=ATOL, rtol=RTOL)


def test_weight_round_trip_through_the_jax_converter_is_exact(jax_s3d):
    """s3d_state_dict_from_jax is the inverse of JAX's s3d_torch_to_variables,
    text tower included."""
    variables, _ = jax_s3d
    rng = np.random.RandomState(4)
    text = {"word_embd": {"embedding": rng.randn(11, 300).astype(np.float32)},
            "fc1": {"kernel": rng.randn(300, 20).astype(np.float32),
                    "bias": rng.randn(20).astype(np.float32)},
            "fc2": {"kernel": rng.randn(20, NUM_CLASSES).astype(np.float32),
                    "bias": rng.randn(NUM_CLASSES).astype(np.float32)}}
    full = dict(variables, text_params=text)
    back = s3d_torch_to_variables(s3d_state_dict_from_jax(full))
    flat = lambda t: {jax.tree_util.keystr(p): np.asarray(v)
                      for p, v in jax.tree_util.tree_leaves_with_path(t)}
    want, got = flat(full), flat(back)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_milnce_checkpoint_loads_strict_into_s3d(tmp_path, jax_s3d):
    """An s3d_howto100m.pth-format file (``module.`` prefixes,
    ``num_batches_tracked``, FrozenBN's ``.scale``) loads into S3D with
    strict=True through load_milnce_checkpoint and s3d_state_dict."""
    variables, _ = jax_s3d
    sd = s3d_state_dict_from_jax(variables)
    saved = {}
    for k, v in sd.items():
        if k.endswith("bn1.weight") and k.startswith("mixed_4c"):
            k = k[:-len("weight")] + "scale"
        saved[f"module.{k}"] = v
        if k.endswith("running_var"):
            saved[f"module.{k[:-len('running_var')]}num_batches_tracked"] = torch.tensor(5)
    torch.save({"state_dict": saved}, tmp_path / "s3d.pth")
    loaded = load_milnce_checkpoint(str(tmp_path / "s3d.pth"))
    assert loaded["report"] == [] and loaded["text"] is None
    model = S3D(num_classes=NUM_CLASSES)
    model.load_state_dict(s3d_state_dict(loaded, text=False), strict=True)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, sd[k], atol=0, rtol=0, msg=k)


def test_frozen_bn_stays_frozen_in_train_mode(jax_s3d):
    """Frozen BN reads its running statistics and leaves them unchanged in
    .train(); with train_bn_stats the batch statistics move them."""
    variables, _ = jax_s3d
    x = _ncthw(np.random.RandomState(5).rand(2, 4, 32, 32, 3).astype(np.float32))
    frozen = _port(variables)
    with torch.no_grad():
        want = frozen(x)
        got = frozen.train()(x)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    loaded = s3d_state_dict_from_jax(variables)
    for k, v in frozen.state_dict().items():
        torch.testing.assert_close(v, loaded[k], atol=0, rtol=0, msg=k)
    live = _port(variables, train_bn_stats=True).train()
    before = live.conv_2b.bn1.running_mean.clone()
    with torch.no_grad():
        live(x)
    assert not torch.equal(live.conv_2b.bn1.running_mean, before)


def test_bf16_autocast_keeps_every_block_bf16(jax_s3d):
    """Under autocast every block's output, BN's included, stays bf16 (an f32
    BN output would run the BN -> ReLU -> max-pool chain in f32), and the
    bf16 embedding is within BF16_REL_NORM of the f32 one."""
    variables, _ = jax_s3d
    model = _port(variables)
    x = _ncthw(np.random.RandomState(6).rand(*CLIP).astype(np.float32))
    dtypes = {}

    def record(name):
        def hook(module, inputs, output):
            dtypes[name] = output.dtype
        return hook

    hooks = [m.register_forward_hook(record(n)) for n, m in model.named_modules()
             if n and n != "fc"]
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        emb16 = model(x, return_embedding=True)
    for h in hooks:
        h.remove()
    assert {n: d for n, d in dtypes.items() if d != torch.bfloat16} == {}
    # every module ran but the stored s2d-space conv1, whose weight is folded
    assert set(dtypes) == {n for n, _ in model.named_modules() if n and n != "fc"} - {
        "conv1.conv1"}
    with torch.no_grad():
        emb32 = model(x, return_embedding=True)
    rel = (torch.linalg.vector_norm(emb16.float() - emb32) / torch.linalg.vector_norm(emb32))
    assert rel < BF16_REL_NORM, rel
