"""The port's Stage-2 co-training slice against the JAX package's, f32 on the
CPU: get_loss with agreement targets from the EMA outputs (cotrain) or the
online ones (init), whole cotrain steps with the EMA twin, the twin's own
rules, the non-strict --pretrain merge, and the train CLI from a Stage-1
checkpoint to a twin checkpoint that the eval CLI loads."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_fixtures import CLI_SHAPE, TINY, VOCAB, WORDS, to_torch, write_feature_dir
from temporalalignnet_torch.checkpoint import merge_state_dict, state_dict_from_jax
from temporalalignnet_torch.core.config import LossConfig, ModelConfig, TrainConfig
from temporalalignnet_torch.losses.tan_loss import get_loss
from temporalalignnet_torch.models.net import TANWithText
from temporalalignnet_torch.train import EMATwin, Optimizer, make_train_step
from temporalalignnet_tpu.core import config as jcfg
from temporalalignnet_tpu.data.synthetic import synthetic_batch
from temporalalignnet_tpu.losses.tan_loss import get_loss as jax_get_loss
from temporalalignnet_tpu.models.net import TANWithText as JaxTANWithText
from temporalalignnet_tpu.train.train_step import create_train_state
from temporalalignnet_tpu.train.train_step import make_train_step as jax_make_train_step

torch.set_num_threads(2)

TOL = 2e-5  # get_loss (tests/test_torch_train.py)
LOSS_TOL = 2e-4  # whole steps
PARAM_ATOL, PARAM_RTOL = 2e-4, 1e-3
COTRAIN = dict(model="cotrain", learn_agreement=True, use_alignability_head=True)


def _batch(seed=0, B=4, T=32, N=4):
    return synthetic_batch(np.random.RandomState(seed), batch_size=B, seq_len=T,
                           max_sentences=N, feature_dim=TINY["video_embed_dim"],
                           vocab_size=VOCAB, max_words=WORDS)


def _outputs(rng, B=4, S=2, T=32, N=4, C=16):
    """A training forward's outputs (both the feature and the logits form),
    with the alignability logits.  The features are multiples of 1/8, so
    every similarity is exact in f32 whatever the order of its sum: the
    packages then see bit-equal same-video logits, and a tie between two
    windows (common: the time softmax at 1/0.07 is peaked) resolves to the
    first in both.  With unit-normalised features JAX's own fused and plain
    paths round a diagonal apart by 1.4e-6 and break such a tie apart."""
    feat = lambda *s: (np.round(rng.randn(*s) * 2.0) / 8.0).astype(np.float32)
    out = {"dual_feature_video": feat(B, S, T, C), "dual_feature_text": feat(B, N, C),
           "joint_feature_video": feat(B, S, T, C), "joint_feature_text": feat(B, S, N, C),
           "dual_logits_alignability": rng.randn(B, N, 1).astype(np.float32),
           "joint_logits_alignability": rng.randn(B, S, N, 1).astype(np.float32)}
    out["logits_dual"] = np.einsum("astc,bkc->astbk", out["dual_feature_video"],
                                   out["dual_feature_text"])
    out["logits_joint"] = np.einsum("astc,bskc->astbk", out["joint_feature_video"],
                                    out["joint_feature_text"])
    return out


def _loss_pair(outputs, batch, kw):
    ref_loss, ref_m = jax_get_loss({k: jnp.asarray(v) for k, v in outputs.items()},
                                   {k: jnp.asarray(v) for k, v in batch.items()},
                                   jcfg.LossConfig(**kw))
    loss, metrics = get_loss({k: to_torch(v) for k, v in outputs.items()},
                             {k: to_torch(v) for k, v in batch.items()}, LossConfig(**kw))
    return (float(ref_loss), {k: float(v) for k, v in ref_m.items()},
            loss.item(), {k: v.item() for k, v in metrics.items()})


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("model", ["cotrain", "init"])
def test_get_loss_with_agreement_matches_jax(model, fused):
    """cotrain: the targets come from the ``ema-*`` outputs, a second set of
    features unlike the online one, so taking the wrong source shows; init:
    from the online diagonals."""
    rng = np.random.RandomState(0)
    outputs = _outputs(rng)
    if model == "cotrain":
        outputs.update({f"ema-{k}": v for k, v in _outputs(rng).items()})
    batch = _batch()
    kw = dict(COTRAIN, model=model, loss_threshold=0.5, use_fused_milnce=fused)
    ref_loss, ref_m, loss, metrics = _loss_pair(outputs, batch, kw)
    assert set(metrics) == set(ref_m) and {"confidence-ratio", "iou-threshold"} <= set(metrics)
    np.testing.assert_allclose(loss, ref_loss, atol=TOL, rtol=1e-6)
    for k in ref_m:
        np.testing.assert_allclose(metrics[k], ref_m[k], atol=TOL, rtol=1e-6, err_msg=k)
    assert 0.0 <= metrics["confidence-ratio"] <= 1.0
    if model == "cotrain":  # the online outputs as the source give another loss
        swapped = dict(outputs, **{f"ema-{k}": outputs[k] for k in _outputs(rng)})
        assert _loss_pair(swapped, batch, kw)[2] != pytest.approx(loss, abs=1e-4)


# ------------------------------------------------------------ the EMA twin


def _tiny(**kw):
    model = TANWithText(ModelConfig(**TINY, use_alignability_head=True, **kw),
                        vocab_size=VOCAB + 1)
    return model.init_weights(torch.Generator().manual_seed(0))


def test_twin_is_a_fresh_deterministic_copy():
    online = _tiny(random_pos_start=True)
    twin = EMATwin(online, TrainConfig())
    pairs = list(zip(online.state_dict().values(), twin.model.state_dict().values()))
    assert pairs and all(torch.equal(o, t) and o.data_ptr() != t.data_ptr() for o, t in pairs)
    assert not any(p.requires_grad for p in twin.model.parameters())
    assert not twin.model.training
    batch = {k: to_torch(v) for k, v in _batch().items()}
    # deterministic: no random pos start, no draw from any generator (a draw
    # without one raises)
    first, second = twin(batch), twin(batch)
    online.eval()
    with torch.no_grad():
        want = online(batch["video"], batch["input_ids"].long(), batch["video_padding_mask"],
                      batch["text_padding_mask"], deterministic=True)
    for k in want:
        assert torch.equal(first[k], second[k]) and not first[k].requires_grad, k
        torch.testing.assert_close(first[k], want[k], atol=1e-6, rtol=1e-6, msg=k)


def test_twin_update_holds_on_micro_steps_and_moves_on_a_skipped_update():
    """backprop_freq = 2: the first micro-step leaves the target bit-equal
    (m = 1); the emit step moves it by t·m + o·(1 - m) although the
    optimizer skipped its non-finite update, as the JAX step does."""
    online = _tiny()
    cfg = TrainConfig(backprop_freq=2, skip_nonfinite_updates=True, ema_momentum=0.9)
    twin = EMATwin(online, cfg)
    opt = Optimizer(online, cfg)
    with torch.no_grad():
        for p in online.parameters():
            p.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(1)))
    t0 = {k: v.clone() for k, v in twin.model.state_dict().items()}
    o0 = {k: v.clone() for k, v in online.state_dict().items()}
    for micro in range(2):
        for p in opt.grad_params:
            p.grad = torch.full_like(p, float("nan"))
        assert opt.step() is False
        twin.update(online)
        if micro == 0:
            assert all(torch.equal(v, t0[k]) for k, v in twin.model.state_dict().items())
    assert opt.updates == 0
    assert all(torch.equal(v, o0[k]) for k, v in online.state_dict().items())
    m = np.float32(0.9)
    for k, v in twin.model.state_dict().items():
        want = t0[k] * float(m) + o0[k] * float(np.float32(1) - m)
        torch.testing.assert_close(v, want, atol=1e-6, rtol=1e-6)
        assert not torch.equal(v, t0[k]), k


def test_make_train_step_pairs_the_twin_with_cotrain():
    model = _tiny()
    opt = Optimizer(model, TrainConfig())
    with pytest.raises(ValueError, match="EMATwin"):
        make_train_step(model, opt, TrainConfig(), LossConfig(**COTRAIN))
    with pytest.raises(ValueError, match="EMATwin"):
        make_train_step(model, opt, TrainConfig(), LossConfig(),
                        twin=EMATwin(model, TrainConfig()))


# ------------------------------------------------------ whole cotrain steps


COTRAIN_STEP_CASES = {
    "fused": (True, {}, 2),
    "plain": (False, {}, 2),
    "backprop_freq_2": (True, dict(backprop_freq=2), 4),
}


@pytest.mark.parametrize("case", list(COTRAIN_STEP_CASES))
def test_cotrain_steps_match_jax(case):
    """The slice as a whole: cotrain steps of the port (online model, EMA twin,
    agreement targets) against the JAX package's from the same weights on
    the same synthetic batch; the online and the target params after."""
    fused, train_kw, steps = COTRAIN_STEP_CASES[case]
    loss_kw = dict(COTRAIN, use_fused_milnce=fused)
    model_kw = dict(TINY, fused_milnce=fused, random_pos_start=False, use_alignability_head=True)
    train_kw = dict(lr=1e-3, warmup_iterations=2, total_iterations=100, ema_momentum=0.9,
                    **train_kw)
    batch = _batch()

    jm = JaxTANWithText(jcfg.ModelConfig(**model_kw), vocab_size=VOCAB + 1)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jtrain, jloss = jcfg.TrainConfig(**train_kw), jcfg.LossConfig(**loss_kw)
    state, tx = create_train_state(jm, jtrain, jloss, jbatch, seed=0)
    jstep = jax_make_train_step(jm, tx, jtrain, jloss)

    tm = TANWithText(ModelConfig(**model_kw), vocab_size=VOCAB + 1)
    tm.load_state_dict(state_dict_from_jax(jax.device_get(state.params)), strict=True)
    tcfg = TrainConfig(**train_kw)
    twin = EMATwin(tm, tcfg)
    opt = Optimizer(tm, tcfg)
    step = make_train_step(tm, opt, tcfg, LossConfig(**loss_kw), twin=twin)
    tbatch = {k: to_torch(v) for k, v in batch.items()}
    t0 = {k: v.clone() for k, v in twin.model.state_dict().items()}
    for _ in range(steps):
        state, ref_m = jstep(state, jbatch)
        ours_m = step(tbatch)
        assert set(ours_m) == set(ref_m)
        for k in ref_m:
            np.testing.assert_allclose(ours_m[k].item(), float(ref_m[k]), atol=LOSS_TOL,
                                       rtol=1e-3, err_msg=k)
    assert opt.updates == steps // tcfg.backprop_freq
    for name, ref_params, ours in (("online", state.params, tm.state_dict()),
                                   ("target", state.ema_params, twin.model.state_dict())):
        ref = state_dict_from_jax(jax.device_get(ref_params))
        assert set(ref) == set(ours)
        for k in ref:
            np.testing.assert_allclose(ours[k].numpy(), ref[k].numpy(), atol=PARAM_ATOL,
                                       rtol=PARAM_RTOL, err_msg=f"{name} {k}")
    assert any(not torch.equal(v, t0[k]) for k, v in twin.model.state_dict().items())


# ------------------------------------------------- --pretrain and the CLIs


def test_merge_keeps_init_for_missing_keys_and_drops_unexpected():
    model = _tiny()
    base = model.state_dict()
    stage1 = {k: v + 1.0 for k, v in base.items() if not k.startswith("binary_head")}
    stage1["mlp.weight"] = torch.zeros(2, 2)  # dropped: unused in the reference forward
    stage1["extra.weight"] = torch.zeros(3)
    merged, report = merge_state_dict(base, {f"online.{k}": v for k, v in stage1.items()})
    assert set(merged) == set(base)
    for k, v in merged.items():
        assert torch.equal(v, base[k] if k.startswith("binary_head") else base[k] + 1.0), k
    assert "missing in checkpoint (kept init): binary_head.weight" in report
    assert "unexpected in checkpoint (dropped): extra.weight" in report
    with pytest.raises(ValueError, match="shape"):
        merge_state_dict(base, dict(stage1, temporal_pos_embed=torch.zeros(3, 3)))


@pytest.fixture(scope="module")
def feature_dir(tmp_path_factory):
    return write_feature_dir(tmp_path_factory.mktemp("htm"))


def test_cli_cotrain_from_a_stage1_checkpoint(feature_dir, tmp_path, capsys):
    """Stage 1 (no alignability head) for two steps, then --model cotrain
    --pretrain on its checkpoint: the merge keeps a fresh head, the twin
    checkpoint has the reference's online./target. key space (JAX's own
    reader takes it), and the port's eval CLI loads it."""
    from temporalalignnet_torch.eval.cli import main as eval_main
    from temporalalignnet_torch.train.cli import main as train_main
    from temporalalignnet_tpu.checkpoint.torch_convert import (load_reference_checkpoint,
                                                               split_twin_state_dict)

    common = ["--feature_dir", str(feature_dir / "features"),
              "--captions", str(feature_dir / "captions.json"),
              "--vocab", str(feature_dir / "vocab.npy"), "--device", "cpu",
              "--batch_size", "2", "--seq_len", "32", "--max_sentences", "4",
              "--max_steps", "2", "--log_every", "1", "--num_workers", "2",
              "--prefix", str(tmp_path), *CLI_SHAPE]
    stage1 = train_main(common)
    capsys.readouterr()
    out = train_main([*common, "--model", "cotrain", "--pretrain", stage1["checkpoint"],
                      "--momentum_m", "0.9"])
    printed = capsys.readouterr().out.splitlines()
    assert "[pretrain] missing in checkpoint (kept init): binary_head.weight" in printed
    logs = [json.loads(l) for l in printed if l.startswith("{")]
    assert [l["step"] for l in logs[:2]] == [1, 2] and out["final_step"] == 2
    assert out["loss_finite"] and all(0.0 <= l["confidence-ratio"] <= 1.0 for l in logs[:2])
    assert out["checkpoint"] != stage1["checkpoint"]

    sd = torch.load(out["checkpoint"], map_location="cpu", weights_only=True)["state_dict"]
    s1 = torch.load(stage1["checkpoint"], map_location="cpu", weights_only=True)["state_dict"]
    online, target = split_twin_state_dict(sd)
    assert target is not None and set(online) == set(target) == set(s1) | {
        "binary_head.weight", "binary_head.bias"}
    assert {k for k in sd if not k.startswith(("online.", "target."))} == {
        k for k in s1 if k.startswith("bert.")}
    assert any(not torch.equal(online[k], target[k]) for k in online)
    loaded = load_reference_checkpoint(out["checkpoint"], verbose=False)
    assert loaded["ema_params"] is not None and not loaded["report"]

    metrics = eval_main(["--task", "align", "--ckpt", out["checkpoint"],
                         "--features", str(feature_dir / "features"),
                         "--anno", str(_anno(tmp_path)), "--vocab", str(feature_dir / "vocab.npy"),
                         "--seq_len", "32", "--device", "cpu", *CLI_SHAPE])
    assert 0.0 <= metrics["Recall"] <= 1.0 and 0.0 <= metrics["AUC"] <= 1.0


def _anno(root):
    anno = {f"vid{v}": [[1, 3.0, 9.0, "w1 w2"], [0, 12.0, 20.0, "w3"], [1, 30.0, 41.0, "w4 w5"]]
            for v in (0, 2)}
    path = root / "anno.json"
    path.write_text(json.dumps(anno))
    return path


def test_cli_pretrain_refuses_an_orbax_directory(tmp_path):
    from temporalalignnet_torch.train.cli import main as train_main

    with pytest.raises(SystemExit, match="orbax"):
        train_main(["--feature_dir", "f", "--captions", "c", "--vocab", "v",
                    "--model", "cotrain", "--pretrain", str(tmp_path)])
