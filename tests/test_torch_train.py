"""The port's Stage-1 training slice against the JAX package's, f32 on the CPU,
on the same weights (moved through state_dict_from_jax) and the same numpy
inputs: the training forward, get_loss, the masked statistics, the lr
schedule, whole train steps, the data pipeline, and the train CLI."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_fixtures import (CLI_SHAPE, TINY, VOCAB, WORDS, jax_model, port_model, to_torch,
                           write_feature_dir, write_milnce_checkpoint)
from temporalalignnet_torch.checkpoint import state_dict_from_jax
from temporalalignnet_torch.core.config import DataConfig, LossConfig, ModelConfig, TrainConfig
from temporalalignnet_torch.data import HTMFeatureDataset, TrainLoader
from temporalalignnet_torch.losses import masked_mean, masked_quantile, masked_std
from temporalalignnet_torch.losses.tan_loss import get_loss
from temporalalignnet_torch.models.net import TANWithText
from temporalalignnet_torch.train import Optimizer, lr_at, make_train_step
from temporalalignnet_tpu.core import config as jcfg
from temporalalignnet_tpu.data import htm as jax_htm
from temporalalignnet_tpu.data.prefetch import TrainLoader as JaxTrainLoader
from temporalalignnet_tpu.data.synthetic import synthetic_batch
from temporalalignnet_tpu.losses import masked as jax_masked
from temporalalignnet_tpu.losses.tan_loss import get_loss as jax_get_loss
from temporalalignnet_tpu.models.net import TANWithText as JaxTANWithText
from temporalalignnet_tpu.train.optimizer import cosine_warmup_schedule
from temporalalignnet_tpu.train.train_step import create_train_state
from temporalalignnet_tpu.train.train_step import make_train_step as jax_make_train_step

torch.set_num_threads(2)

TOL = 2e-5  # the forward bar (tests/test_checkpoint.py::test_full_forward_parity)
LOSS_TOL = 2e-4  # two train steps (tests/test_fused_milnce.py:146-160)
PARAM_ATOL, PARAM_RTOL = 2e-4, 1e-3


def _batch(seed=0, B=4, T=32, N=4):
    return synthetic_batch(np.random.RandomState(seed), batch_size=B, seq_len=T,
                           max_sentences=N, feature_dim=TINY["video_embed_dim"],
                           vocab_size=VOCAB, max_words=WORDS)


def _torch_batch(batch):
    return {k: to_torch(v) for k, v in batch.items()}


# ------------------------------------------------------------ the forward


@pytest.mark.parametrize("fused,extra", [
    (False, {}), (True, {}), (True, dict(use_text_pos_enc=True)), (False, dict(pos_enc="sine")),
    (True, dict(pos_enc="sine", use_text_pos_enc=True))],
    ids=["False", "True", "text_pos_enc", "sine", "sine_text_pos_enc"])
def test_training_forward_matches_jax(fused, extra):
    kw = dict(use_alignability_head=True, random_pos_start=False, fused_milnce=fused, **extra)
    jm, params = jax_model(**kw)
    tm = port_model(params, **kw)
    batch = _batch()
    batch["video_padding_mask"][1, 25:] = True
    ref = jm.apply({"params": params}, jnp.asarray(batch["video"]),
                   jnp.asarray(batch["input_ids"]), jnp.asarray(batch["video_padding_mask"]),
                   jnp.asarray(batch["text_padding_mask"]), deterministic=False)
    tb = _torch_batch(batch)
    with torch.no_grad():
        ours = tm(tb["video"], tb["input_ids"].long(), tb["video_padding_mask"],
                  tb["text_padding_mask"], deterministic=False)
    assert set(ours) == set(ref)
    for key in ref:
        assert ours[key].shape == ref[key].shape, key
        assert ours[key].dtype == torch.float32, key
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(ref[key]), atol=TOL, rtol=0,
                                   err_msg=key)


def test_random_pos_start_draws_from_the_generator():
    _, params = jax_model()
    tm = port_model(params)
    tb = _torch_batch(_batch())
    T, N = tb["video"].shape[1], tb["input_ids"].shape[1]
    run = lambda seed: tm(tb["video"], tb["input_ids"].long(), deterministic=False,
                          pos_starts=tm.draw_pos_starts(T, N, torch.Generator().manual_seed(seed))
                          )["logits_dual"]
    with torch.no_grad():
        torch.testing.assert_close(run(3), run(3), rtol=0, atol=0)
        assert any(not torch.equal(run(3), run(seed)) for seed in range(4, 8))
        with pytest.raises(ValueError, match="Generator"):
            tm.draw_pos_starts(T, N, None)
        with pytest.raises(ValueError, match="pos_starts"):
            tm(tb["video"], tb["input_ids"].long(), deterministic=False)


# ------------------------------------------------------------------ losses


def test_masked_statistics_match_jax(rng):
    x = rng.randn(37).astype(np.float32)
    mask = rng.rand(37) < 0.6
    tx, tm = to_torch(x), to_torch(mask)
    np.testing.assert_allclose(masked_mean(tx, tm).item(),
                               float(jax_masked.masked_mean(x, mask)), rtol=1e-6)
    np.testing.assert_allclose(masked_std(tx, tm).item(),
                               float(jax_masked.masked_std(x, mask)), rtol=1e-6)
    for q in (0.0, 0.3, 0.5, 1.0):
        ours = masked_quantile(tx, tm, q).item()
        assert ours == pytest.approx(float(jax_masked.masked_quantile(x, mask, q)), rel=1e-6)
        assert ours == pytest.approx(torch.quantile(tx[tm], q).item(), rel=1e-6)


def _loss_outputs(rng, B=4, S=2, T=32, N=4, C=16):
    unit = lambda *s: (lambda a: a / np.linalg.norm(a, axis=-1, keepdims=True))(
        rng.randn(*s).astype(np.float32))
    out = {"dual_feature_video": unit(B, S, T, C), "dual_feature_text": unit(B, N, C),
           "joint_feature_video": unit(B, S, T, C), "joint_feature_text": unit(B, S, N, C),
           "dual_logits_alignability": rng.randn(B, N, 1).astype(np.float32),
           "joint_logits_alignability": rng.randn(B, S, N, 1).astype(np.float32)}
    out["logits_dual"] = np.einsum("astc,bkc->astbk", out["dual_feature_video"],
                                   out["dual_feature_text"])
    out["logits_joint"] = np.einsum("astc,bskc->astbk", out["joint_feature_video"],
                                    out["joint_feature_text"])
    return out


LOSS_CONFIGS = {
    "default": {},
    "head": dict(use_alignability_head=True),
    "threshold": dict(loss_threshold=0.5),
    "head_threshold_bce": dict(use_alignability_head=True, loss_threshold=0.5,
                               optim_policy="bce"),
}


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("cfg_name", list(LOSS_CONFIGS))
def test_get_loss_matches_jax(rng, cfg_name, fused):
    kw = dict(LOSS_CONFIGS[cfg_name], use_fused_milnce=fused)
    outputs = _loss_outputs(rng)
    batch = _batch(T=32)
    batch["abs_text_pos"][0, 0] = [0.0, 0.1]  # a text near the video's start
    ref_loss, ref_m = jax_get_loss({k: jnp.asarray(v) for k, v in outputs.items()},
                                   {k: jnp.asarray(v) for k, v in batch.items()},
                                   jcfg.LossConfig(**kw))
    loss, metrics = get_loss({k: to_torch(v) for k, v in outputs.items()}, _torch_batch(batch),
                             LossConfig(**kw))
    assert set(metrics) == set(ref_m)
    np.testing.assert_allclose(loss.item(), float(ref_loss), atol=TOL, rtol=1e-6)
    for k in ref_m:
        np.testing.assert_allclose(metrics[k].item(), float(ref_m[k]), atol=TOL, rtol=1e-6,
                                   err_msg=k)


# ------------------------------------------------------------- optimizer


def test_lr_schedule_matches_jax():
    cfg = TrainConfig(lr=3e-4, warmup_iterations=10, total_iterations=50)
    ref = cosine_warmup_schedule(jcfg.TrainConfig(lr=3e-4, warmup_iterations=10,
                                                  total_iterations=50))
    for step in (0, 1, 5, 9, 10, 11, 30, 49, 50):
        assert lr_at(cfg, step) == pytest.approx(float(ref(step)), rel=1e-6, abs=1e-12)


def test_param_groups():
    from temporalalignnet_torch.train.optimizer import no_decay, trainable

    model = TANWithText(ModelConfig(**TINY, use_alignability_head=True), vocab_size=VOCAB + 1)
    names = [n for n, _ in model.named_parameters()]
    assert "bert.word_embd.weight" not in [n for n in names if trainable(n, "default")]
    assert [n for n in names if trainable(n, "bce")] == ["binary_head.weight",
                                                        "binary_head.bias"]
    assert no_decay("video_temporal_encoder.resblocks.0.attn.in_proj_bias")
    assert no_decay("ln_video_init.weight")
    assert no_decay("joint_temporal_encoder.resblocks.1.ln_2.weight")
    assert not no_decay("video_temporal_encoder.resblocks.0.attn.in_proj_weight")
    assert not no_decay("temporal_pos_embed")


@pytest.mark.parametrize("capturable", [False, True], ids=["host_form", "device_form"])
@pytest.mark.parametrize("clip_mode,backprop_freq,nan_at,n_updates", [
    ("global", 1, (3, 4), 8), ("per_param", 2, (), 5)])
def test_optimizer_matches_optax_on_a_gradient_sequence(rng, clip_mode, backprop_freq, nan_at,
                                                        n_updates, capturable):
    """Global or per-param clipping, skip_nonfinite_updates and backprop_freq
    against the JAX package's optax chain on the same gradients, in the
    optimizer's host form and its device form (the card's: device counters,
    a static accumulator, the update undone by selection).  NaN gradients
    are skipped (no update; moments and schedule untouched).  They are not
    mixed with accumulation: in optax.MultiSteps a NaN stays in the
    accumulator after the skipped emit ((1 - emit) * NaN), so every later
    update is skipped too; the port resets its accumulator instead."""
    import optax

    from temporalalignnet_tpu.train.optimizer import make_optimizer

    kw = dict(lr=1e-2, wd=0.1, warmup_iterations=2, total_iterations=10,
              backprop_freq=backprop_freq,
              clip_grad_norm=0.5, clip_mode=clip_mode, skip_nonfinite_updates=True)
    init = {"w": rng.randn(5, 3).astype(np.float32), "bias": rng.randn(3).astype(np.float32)}
    tx = make_optimizer(jcfg.TrainConfig(**kw), init)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = tx.init(jparams)

    module = torch.nn.Module()
    for k, v in init.items():
        module.register_parameter(k, torch.nn.Parameter(to_torch(v.copy())))
    opt = Optimizer(module, TrainConfig(**kw), capturable=capturable)
    for i in range(10):
        grads = {k: rng.randn(*v.shape).astype(np.float32) for k, v in init.items()}
        if i in nan_at:
            grads["w"][0, 0] = np.nan
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, jstate,
                                    jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in module.named_parameters():
            p.grad = to_torch(grads[k])
        opt.step()
        for k, p in module.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), atol=1e-6,
                                       rtol=1e-5, err_msg=f"{k} after micro-step {i}")
    assert opt.updates == n_updates


@pytest.mark.parametrize("capturable", [False, True], ids=["host_form", "device_form"])
def test_consecutive_nonfinite_limit_matches_optax(rng, capturable):
    """MAX_CONSECUTIVE_ERRORS non-finite gradients in a row are skipped; the
    next one goes through (optax.apply_if_finite with the same limit, the
    JAX package's chain): per-param clipping keeps the NaN in ``w``, so
    ``w`` turns NaN in both and ``bias`` takes its update; a finite
    gradient then resets the count."""
    import optax

    from temporalalignnet_torch.train.optimizer import MAX_CONSECUTIVE_ERRORS
    from temporalalignnet_tpu.train.optimizer import make_optimizer

    # the device form's lr table is bounded by the steps that end a cycle, skipped or not
    kw = dict(lr=1e-2, wd=0.1, warmup_iterations=2, total_iterations=MAX_CONSECUTIVE_ERRORS + 4,
              clip_grad_norm=0.5, clip_mode="per_param", skip_nonfinite_updates=True)
    init = {"w": rng.randn(5, 3).astype(np.float32), "bias": rng.randn(3).astype(np.float32)}
    tx = make_optimizer(jcfg.TrainConfig(**kw), init)
    update = jax.jit(tx.update)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = tx.init(jparams)
    module = torch.nn.Module()
    for k, v in init.items():
        module.register_parameter(k, torch.nn.Parameter(to_torch(v.copy())))
    opt = Optimizer(module, TrainConfig(**kw), capturable=capturable)
    n = MAX_CONSECUTIVE_ERRORS + 3  # two finite, the run of skips, the one let through
    for i in range(n):
        grads = {k: rng.randn(*v.shape).astype(np.float32) for k, v in init.items()}
        if i >= 2:
            grads["w"][0, 0] = np.nan
        updates, jstate = update({k: jnp.asarray(v) for k, v in grads.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in module.named_parameters():
            p.grad = to_torch(grads[k])
        opt.step()
        if i == n - 2:  # the last skip: as after the two finite updates
            assert opt.updates == 2 and opt.notfinite == MAX_CONSECUTIVE_ERRORS
            assert not np.isnan(module.w.detach().numpy()).any()
    assert opt.updates == 3 and opt.notfinite == MAX_CONSECUTIVE_ERRORS + 1
    assert int(jstate.notfinite_count) == MAX_CONSECUTIVE_ERRORS + 1
    assert np.isnan(module.w.detach().numpy()).all() and np.isnan(np.asarray(jparams["w"])).all()
    np.testing.assert_allclose(module.bias.detach().numpy(), np.asarray(jparams["bias"]),
                               atol=1e-6, rtol=1e-5)
    grads = {k: rng.randn(*v.shape).astype(np.float32) for k, v in init.items()}
    _, jstate = update({k: jnp.asarray(v) for k, v in grads.items()}, jstate, jparams)
    for k, p in module.named_parameters():
        p.grad = to_torch(grads[k])
    opt.step()
    assert opt.notfinite == int(jstate.notfinite_count) == 0 and opt.updates == 4


# ------------------------------------------------------ whole train steps


STEP_CASES = {
    "fused": (dict(fused=True), {}, {}, 2),
    "plain": (dict(fused=False), {}, {}, 2),
    "backprop_freq_2": (dict(fused=True), {}, dict(backprop_freq=2), 4),
    "clip_per_param": (dict(fused=False), {}, dict(clip_grad_norm=0.05), 2),
    "bce_policy": (dict(fused=True),
                   dict(use_alignability_head=True, loss_threshold=0.5, optim_policy="bce"),
                   {}, 2),
    "text_pos_enc": (dict(fused=True, use_text_pos_enc=True), {}, {}, 2),
    # the port's torch.utils.checkpoint blocks against JAX's nn.remat ones
    "remat": (dict(fused=True, remat=True), {}, {}, 2),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_steps_match_jax(case):
    """The slice as a whole: train steps of the port against the JAX package's
    from the same weights on the same synthetic batch."""
    _steps_match_jax(*STEP_CASES[case], _batch())


def test_train_step_at_seq_len_128_matches_jax():
    """A Stage-1 step at T = 128, N = 16: the joint encoder's S = 144 is past
    the 128 that the fused attention backward holds (on the card the long
    route), against JAX's step."""
    _steps_match_jax(dict(fused=True), {}, {}, 2, _batch(T=128, N=16))


def _steps_match_jax(flags, loss_kw, train_kw, steps, batch):
    model_extra = dict(flags)
    fused = model_extra.pop("fused")
    remat = model_extra.pop("remat", False)
    loss_kw = dict(loss_kw, use_fused_milnce=fused)
    model_kw = dict(TINY, fused_milnce=fused, random_pos_start=False,
                    use_alignability_head=loss_kw.get("use_alignability_head", False),
                    **model_extra)
    train_kw = dict(dict(lr=1e-3, warmup_iterations=2, total_iterations=100), **train_kw)

    jm = JaxTANWithText(jcfg.ModelConfig(**model_kw), vocab_size=VOCAB + 1, remat=remat)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jtrain, jloss = jcfg.TrainConfig(**train_kw), jcfg.LossConfig(**loss_kw)
    state, tx = create_train_state(jm, jtrain, jloss, jbatch, seed=0)
    jstep = jax_make_train_step(jm, tx, jtrain, jloss)

    tm = TANWithText(ModelConfig(**model_kw, remat=remat), vocab_size=VOCAB + 1)
    tm.load_state_dict(state_dict_from_jax(jax.device_get(state.params)), strict=True)
    tcfg = TrainConfig(**train_kw)
    opt = Optimizer(tm, tcfg, policy=loss_kw.get("optim_policy", "default"))
    step = make_train_step(tm, opt, tcfg, LossConfig(**loss_kw))
    tbatch = _torch_batch(batch)
    init = {k: v.clone() for k, v in tm.state_dict().items()}
    for _ in range(steps):
        state, ref_m = jstep(state, jbatch)
        ours_m = step(tbatch)
        assert abs(ours_m["loss"].item() - float(ref_m["loss"])) <= LOSS_TOL
        for k in ref_m:
            np.testing.assert_allclose(ours_m[k].item(), float(ref_m[k]), atol=5e-4,
                                       rtol=1e-3, err_msg=k)
    assert opt.updates == steps // tcfg.backprop_freq
    ref = state_dict_from_jax(jax.device_get(state.params))
    ours = tm.state_dict()
    for k in ref:
        np.testing.assert_allclose(ours[k].numpy(), ref[k].numpy(), atol=PARAM_ATOL,
                                   rtol=PARAM_RTOL, err_msg=k)
    assert any(not torch.equal(ours[k], init[k]) for k in ours)


# ------------------------------------------------------------ data pipeline


@pytest.fixture(scope="module")
def feature_dir(tmp_path_factory):
    """Six videos of S3D-like features with sentencified captions, as .json
    and .jsonl, and a vocab; one video held out."""
    return write_feature_dir(tmp_path_factory.mktemp("htm"))


def _datasets(root, captions):
    from temporalalignnet_torch.models.word2vec import Word2VecTokenizer
    from temporalalignnet_tpu.models.word2vec import Word2VecTokenizer as JaxTokenizer

    kw = dict(seq_len=32, max_sentences=4, max_words=WORDS)
    ours = HTMFeatureDataset(str(root / "features"), str(root / captions), DataConfig(**kw),
                             "train", Word2VecTokenizer(str(root / "vocab.npy"), WORDS),
                             holdout=str(root / "holdout.txt"), vlen_table=None)
    ref = jax_htm.HTMFeatureDataset(str(root / "features"), str(root / captions),
                                    jcfg.DataConfig(**kw, feature_dim=TINY["video_embed_dim"]),
                                    "train",
                                    JaxTokenizer(str(root / "vocab.npy"), WORDS),
                                    holdout=str(root / "holdout.txt"))
    return ours, ref


@pytest.mark.parametrize("captions", ["captions.json", "captions.jsonl"])
def test_dataset_samples_bit_equal_jax(feature_dir, captions):
    ours, ref = _datasets(feature_dir, captions)
    assert ours.video_ids == ref.video_ids and "vid5" not in ours.video_ids
    for i in range(len(ours)):
        for seed in range(3):
            a = ours.sample(i, np.random.RandomState(seed))
            b = ref.sample(i, np.random.RandomState(seed))
            assert set(a) == set(b)
            for k in a:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{i} {seed} {k}")


def test_loader_epoch_order_bit_equal_jax(feature_dir):
    ours, ref = _datasets(feature_dir, "captions.json")
    ol, rl = TrainLoader(ours, 2, seed=7, num_workers=2), JaxTrainLoader(ref, 2, seed=7,
                                                                         num_workers=2)
    assert len(ol) == len(rl) == len(ours) // 2
    for epoch, start in ((0, 0), (1, 1)):
        ol.set_epoch(epoch, start)
        rl.set_epoch(epoch, start)
        got, want = list(ol), list(rl)
        assert len(got) == len(want) == len(ol) - start
        for a, b in zip(got, want):
            for k in b:
                assert isinstance(a[k], torch.Tensor)
                np.testing.assert_array_equal(a[k].numpy(), b[k], err_msg=k)


# -------------------------------------------------------------------- CLI


def test_train_cli_writes_a_checkpoint_the_eval_cli_loads(feature_dir, tmp_path, capsys):
    from temporalalignnet_torch.eval.cli import main as eval_main
    from temporalalignnet_torch.train.cli import main as train_main

    shape = CLI_SHAPE
    # an HTM-Align-format corpus over the same features, for both CLIs
    anno = {f"vid{v}": [[1, 3.0, 9.0, "w1 w2"], [0, 12.0, 20.0, "w3"], [1, 30.0, 41.0, "w4 w5"]]
            for v in (0, 2)}
    (tmp_path / "anno.json").write_text(json.dumps(anno))
    out = train_main(["--feature_dir", str(feature_dir / "features"),
                      "--captions", str(feature_dir / "captions.json"),
                      "--vocab", str(feature_dir / "vocab.npy"), "--device", "cpu",
                      "--batch_size", "2", "--seq_len", "32", "--max_sentences", "4",
                      "--max_steps", "2", "--log_every", "1", "--num_workers", "2",
                      "--use_alignability_head", "1", "--prefix", str(tmp_path),
                      "--align_anno", str(tmp_path / "anno.json"), *shape])
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    assert [l["step"] for l in lines[:2]] == [1, 2] and lines[2]["eval_step"] == 2
    assert lines[-1] == out and out["final_step"] == 2 and out["loss_finite"]
    ckpt = torch.load(out["checkpoint"], map_location="cpu", weights_only=True)
    assert set(ckpt) == {"epoch", "state_dict", "best_acc", "optimizer", "iteration"}
    assert ckpt["iteration"] == 2 and ckpt["optimizer"]["updates"] == 2

    metrics = eval_main(["--task", "align", "--ckpt", out["checkpoint"],
                         "--features", str(feature_dir / "features"),
                         "--anno", str(tmp_path / "anno.json"),
                         "--vocab", str(feature_dir / "vocab.npy"), "--seq_len", "32",
                         "--device", "cpu", *shape])
    # the trainer's downstream eval of its final weights is the eval CLI's
    assert metrics == {k: out[k] for k in metrics}
    assert 0.0 <= metrics["Recall"] <= 1.0 and 0.0 <= metrics["AUC"] <= 1.0


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("flag", [["--dp", "2"], ["--tp", "2"], ["--multihost"]])
def test_train_cli_refuses_flags_of_later_slices(flag, feature_dir, tmp_path, capsys):
    """The JAX trainer's multi-GPU flags: ``--dp 2`` and ``--tp 2`` without a
    process group are refused naming the launcher (tensor parallelism itself:
    tests/test_torch_tensor_parallel.py), and ``--multihost`` in a world of
    one (``--dp 1``) trains as the run without it: the same losses, and
    params within f32 rounding (the group's collectives add autograd nodes,
    which may change the order in which a gradient's terms are summed)."""
    from temporalalignnet_torch.train.cli import main as train_main

    argv = ["--feature_dir", str(feature_dir / "features"),
            "--captions", str(feature_dir / "captions.json"),
            "--vocab", str(feature_dir / "vocab.npy"), "--device", "cpu", "--batch_size", "2",
            "--seq_len", "32", "--max_sentences", "4", "--max_steps", "2", "--log_every", "1",
            "--num_workers", "2", "--runtime_save_iter", "0", *CLI_SHAPE]
    if flag[0] in ("--dp", "--tp"):
        with pytest.raises(SystemExit, match="torchrun"):
            train_main(argv + flag)
        return
    single = train_main(argv + ["--prefix", str(tmp_path / "single")])
    capsys.readouterr()
    world1 = train_main(argv + ["--prefix", str(tmp_path / "world1"), "--dp", "1", *flag,
                                "--coordinator", f"127.0.0.1:{_free_port()}",
                                "--num_processes", "1", "--process_id", "0"])
    assert "[multihost] process 0/1 builds batch rows [0, 2)" in capsys.readouterr().out
    assert not torch.distributed.is_initialized()  # the CLI left its group
    assert world1["loss"] == single["loss"] and world1["final_step"] == 2
    a = torch.load(single["checkpoint"], weights_only=True)["state_dict"]
    b = torch.load(world1["checkpoint"], weights_only=True)["state_dict"]
    for k in a:
        torch.testing.assert_close(b[k], a[k], rtol=0, atol=1e-6)


# ------------------------------------------------------------------ remat


def _remat_run(remat, cotrain, compute=torch.float32, steps=2):
    """``steps`` train steps of the tiny model (random pos starts on) from
    one init; returns (losses, params, target params or None, the
    pos-start generator's state)."""
    from temporalalignnet_torch.train import EMATwin

    head = dict(use_alignability_head=True) if cotrain else {}
    model = TANWithText(ModelConfig(**TINY, remat=remat, **head), vocab_size=VOCAB + 1)
    model.init_weights(torch.Generator().manual_seed(0))
    tcfg = TrainConfig(lr=1e-3, warmup_iterations=0, total_iterations=100)
    twin = EMATwin(model, tcfg) if cotrain else None
    loss_kw = dict(model="cotrain", learn_agreement=True, **head) if cotrain else {}
    step = make_train_step(model, Optimizer(model, tcfg), tcfg, LossConfig(**loss_kw),
                           compute_dtype=compute, twin=twin)
    losses = [step(_torch_batch(_batch(seed=i)))["loss"].item() for i in range(steps)]
    grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    target = None if twin is None else {k: v.clone() for k, v in twin.model.state_dict().items()}
    return losses, model.state_dict(), grads, target, step.generator.get_state()


@pytest.mark.parametrize("cotrain", [False, True], ids=["init", "cotrain"])
def test_remat_steps_bit_equal_plain(cotrain):
    """torch.utils.checkpoint per block changes memory only: the same losses,
    gradients, params and twin to the bit, and the pos-start generator drew
    the same numbers (no block draws from it, so the recompute cannot)."""
    plain, remat = _remat_run(False, cotrain), _remat_run(True, cotrain)
    assert plain[0] == remat[0]
    for a, b in zip(plain[1:4], remat[1:4]):
        if a is not None:
            assert a.keys() == b.keys()
            for k in a:
                assert torch.equal(a[k], b[k]), k
    assert torch.equal(plain[4], remat[4])


def test_remat_recomputes_under_the_forward_autocast(monkeypatch):
    """Under autocast (bf16 on the CPU here, as on the card) the backward's
    recompute of each block runs under the forward's autocast state: every
    attention call, the 4 of the forward and the 4 recomputed, sees bf16 q
    with autocast on, and the step equals the plain bf16 step to the bit."""
    from temporalalignnet_torch.models import transformer

    seen = []
    inner = transformer.multihead_attention

    def recorded(q, k, v, mask=None):
        seen.append((q.dtype, torch.is_autocast_enabled("cpu"), torch.is_grad_enabled()))
        return inner(q, k, v, mask)

    monkeypatch.setattr(transformer, "multihead_attention", recorded)
    plain = _remat_run(False, False, compute=torch.bfloat16, steps=1)
    n_plain, seen[:] = len(seen), []
    remat = _remat_run(True, False, compute=torch.bfloat16, steps=1)
    blocks = TINY["num_encoder_layers"] + TINY["num_joint_layers"]
    assert n_plain == blocks and len(seen) == 2 * blocks
    assert all(s == (torch.bfloat16, True, True) for s in seen), seen
    assert plain[0] == remat[0]
    for k in plain[2]:
        assert torch.equal(plain[2][k], remat[2][k]), k


# --------------------------------------------------------- train CLI flags


@pytest.mark.parametrize("model", ["init", "cotrain"])
def test_train_cli_milnce_ckpt_merges_the_text_tower(feature_dir, tmp_path, capsys, monkeypatch,
                                                     model):
    """--milnce_ckpt: the language model holds the file's tensors when the
    train step is built (after the merge, before any step), and so does the
    EMA twin's copy; a tensor the file lacks keeps its init and is reported."""
    from temporalalignnet_torch.train import train_step
    from temporalalignnet_torch.train.cli import main as train_main

    drop = ("fc2.bias",) if model == "init" else ()
    path = str(tmp_path / "s3d_howto100m.pth")
    text = write_milnce_checkpoint(path, VOCAB + 1, TINY["video_embed_dim"], drop=drop)
    built = {}
    inner = train_step.make_train_step

    def capture(model_, optimizer, *a, twin=None, **kw):
        built["online"] = {k: v.clone() for k, v in model_.bert.state_dict().items()}
        built["target"] = None if twin is None else {
            k: v.clone() for k, v in twin.model.bert.state_dict().items()}
        return inner(model_, optimizer, *a, twin=twin, **kw)

    monkeypatch.setattr(train_step, "make_train_step", capture)
    out = train_main(["--feature_dir", str(feature_dir / "features"),
                      "--captions", str(feature_dir / "captions.json"),
                      "--vocab", str(feature_dir / "vocab.npy"), "--device", "cpu",
                      "--batch_size", "2", "--seq_len", "32", "--max_sentences", "4",
                      "--max_steps", "3", "--log_every", "1", "--num_workers", "2",
                      "--model", model, "--milnce_ckpt", path, "--prefix", str(tmp_path),
                      *CLI_SHAPE])
    printed = capsys.readouterr().out.splitlines()
    assert out["final_step"] == 3 and out["loss_finite"]
    assert [l for l in printed if l.startswith("[milnce]")] == (
        ["[milnce] missing in checkpoint (kept init): bert.fc2.bias"] if drop else [])
    assert sum(l.startswith("[s3d_convert]") for l in printed) == 3
    halves = [built["online"]] + ([built["target"]] if model == "cotrain" else [])
    for sd in halves:
        assert set(text) == set(sd) - set(drop)
        for k in text:
            assert torch.equal(sd[k], text[k]), k


def test_cached_loader_bit_equal_uncached_and_jax(feature_dir):
    """--cache_videos 3 (an LRU smaller than the six videos, so entries are
    evicted and refilled, and read by two loader threads) against 0 and
    against the JAX package's uncached dataset, over two epochs."""
    from temporalalignnet_torch.models.word2vec import Word2VecTokenizer
    from temporalalignnet_tpu.models.word2vec import Word2VecTokenizer as JaxTokenizer

    kw = dict(seq_len=32, max_sentences=4, max_words=WORDS)
    root = feature_dir
    ours = {n: HTMFeatureDataset(str(root / "features"), str(root / "captions.json"),
                                 DataConfig(**kw), "train",
                                 Word2VecTokenizer(str(root / "vocab.npy"), WORDS),
                                 holdout=str(root / "holdout.txt"), cache_videos=n)
            for n in (3, 0)}
    ref = jax_htm.HTMFeatureDataset(str(root / "features"), str(root / "captions.json"),
                                    jcfg.DataConfig(**kw, feature_dim=TINY["video_embed_dim"]),
                                    "train", JaxTokenizer(str(root / "vocab.npy"), WORDS),
                                    holdout=str(root / "holdout.txt"), cache_videos=0)
    loaders = [TrainLoader(ours[3], 2, seed=3, num_workers=2),
               TrainLoader(ours[0], 2, seed=3, num_workers=2)]
    jl = JaxTrainLoader(ref, 2, seed=3, num_workers=2)
    for epoch in range(2):
        for ld in loaders + [jl]:
            ld.set_epoch(epoch)
        got = [list(ld) for ld in loaders]
        want = list(jl)
        assert len(got[0]) == len(got[1]) == len(want) == len(ours[3]) // 2
        for a, b, c in zip(*got, want):
            for k in c:
                np.testing.assert_array_equal(a[k].numpy(), c[k], err_msg=k)
                np.testing.assert_array_equal(b[k].numpy(), c[k], err_msg=k)
    assert len(ours[3]._cache._d) == 3 and ours[0]._cache.get("vid0") is None


@pytest.fixture(scope="module")
def profiled_cli_run(feature_dir, tmp_path_factory):
    """One train CLI run on the CPU with --profile_dir, 2 steps logged each,
    an HTM-Align eval at the end; returns (its experiment dir, the profile
    dir)."""
    from temporalalignnet_torch.train.cli import experiment_name, build_parser
    from temporalalignnet_torch.train.cli import main as train_main

    tmp = tmp_path_factory.mktemp("profiled")
    anno = {f"vid{v}": [[1, 3.0, 9.0, "w1 w2"], [0, 12.0, 20.0, "w3"], [1, 30.0, 41.0, "w4"]]
            for v in (0, 2)}
    (tmp / "anno.json").write_text(json.dumps(anno))
    argv = ["--feature_dir", str(feature_dir / "features"),
            "--captions", str(feature_dir / "captions.json"),
            "--vocab", str(feature_dir / "vocab.npy"), "--device", "cpu",
            "--batch_size", "2", "--seq_len", "32", "--max_sentences", "4",
            "--max_steps", "2", "--log_every", "1", "--num_workers", "2",
            "--use_alignability_head", "1", "--prefix", str(tmp / "exp"),
            "--align_anno", str(tmp / "anno.json"), "--cache_videos", "3",
            "--profile_dir", str(tmp / "profile"), *CLI_SHAPE]
    train_main(argv)
    return tmp / "exp" / experiment_name(build_parser().parse_args(argv)), tmp / "profile"


def test_train_cli_profile_dir_writes_a_trace(profiled_cli_run):
    _, profile = profiled_cli_run
    traces = list(profile.glob("trace_*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)  # the steps' ops were recorded


def test_metrics_writer_lines_carry_jax_keys(profiled_cli_run, rng):
    """train.metrics.jsonl: per logged step the keys JAX's trainer writes
    (train/cli.py:605-614: the step's metrics, device/sps, the loop's
    breakdown shares and the device memory), per eval JAX's eval keys."""
    from temporalalignnet_tpu.utils.logging import device_memory_stats as jax_memory_stats
    from temporalalignnet_tpu.utils.profiling import StepBreakdown as JaxStepBreakdown

    exp, _ = profiled_cli_run
    lines = [json.loads(l) for l in (exp / "train.metrics.jsonl").read_text().splitlines()]
    _, ref_m = jax_get_loss({k: jnp.asarray(v) for k, v in _loss_outputs(rng).items()},
                            {k: jnp.asarray(v) for k, v in _batch(T=32).items()},
                            jcfg.LossConfig(use_alignability_head=True))
    device = ["sps", *JaxStepBreakdown().snapshot(), *jax_memory_stats()]
    train_keys = {"step", "time", *(f"train/{k}" for k in [*ref_m, "grad_norm"]),
                  *(f"train/device/{k}" for k in device)}
    assert [l["step"] for l in lines] == [1, 2, 2]
    assert set(lines[0]) == set(lines[1]) == train_keys
    assert set(lines[2]) == {"step", "time", "eval/Recall", "eval/AUC"}
    assert all(np.isfinite(v) for l in lines for v in l.values())
