"""The port's end-to-end S3D fine-tune against the JAX package's on the CPU:
nce_loss, whole train steps from the same weights (moved through
s3d_state_dict_from_jax) on the same numpy clips, the HTM-AA clip dataset and
its loader, the checkpoint ranking by loss, and the e2e CLI's final JSON."""

import csv
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from port_fixtures import jax_s3d_variables
from temporalalignnet_torch.checkpoint import (Checkpointer, load_milnce_checkpoint,
                                               s3d_state_dict, s3d_state_dict_from_jax)
from temporalalignnet_torch.core.config import TrainConfig
from temporalalignnet_torch.data import TrainLoader
from temporalalignnet_torch.data.clips import HTMClipDataset, synthetic_decode
from temporalalignnet_torch.models.word2vec import Word2VecTokenizer
from temporalalignnet_torch.train.end2end import (S3DWithText, make_e2e_optimizer,
                                                  make_e2e_train_step, nce_loss)
from temporalalignnet_torch.train.optimizer import lr_at, no_decay
from temporalalignnet_tpu.checkpoint.s3d_convert import s3d_torch_to_variables
from temporalalignnet_tpu.core.config import TrainConfig as JaxTrainConfig
from temporalalignnet_tpu.data.clips import HTMClipDataset as JaxHTMClipDataset
from temporalalignnet_tpu.data.prefetch import TrainLoader as JaxTrainLoader
from temporalalignnet_tpu.models.word2vec import Word2VecTokenizer as JaxTokenizer
from temporalalignnet_tpu.train import end2end as jax_e2e

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = 2e-4
PARAM_ATOL, PARAM_RTOL = 2e-4, 1e-3
STAT_TOL = 1e-5  # BN running statistics
# A micro-step's gradient, leaf by leaf, against jax.grad at the same params:
# ‖Δg‖ ≤ GRAD_RTOL · ‖g‖ + GRAD_ATOL.  f32 summation order alone parts the
# stem's gradients by a few 1e-3 here; GRAD_ATOL covers a leaf whose gradient
# nearly cancels (text fc2's bias, ‖g‖ ≈ 3e-7).
GRAD_RTOL, GRAD_ATOL = 1e-2, 1e-6
# optax fed the port's gradients: the update with the decay taken out,
# (Δw + lr·wd·w)/lr (about ±1 where Adam moves an element), within
# UPDATE_ATOL · (1 + |w|), about four f32 ulps of w over lr; the moments within
# MOMENT_RTOL in relative norm.
UPDATE_ATOL, MOMENT_RTOL = 2e-2, 1e-5
VOCAB = [f"w{i}" for i in range(50)]
C = 16  # joint dim of the tiny runs
# lr · wd = 1e-3 per step, so a missing or misplaced decay shows; lr small
# enough that Adam's ±lr step on an element whose gradient is at the f32
# noise level (both packages are right there, to their summation order)
# stays inside PARAM_ATOL.  (At lr 1e-2 one step takes the random S3D's loss
# from 1.6 to 2e5 and the runs part; at 1e-3 conv_2c's near-zero gradients
# flip sign between the two and its weights part by 4e-3.)
LR, WD = 2.5e-5, 40.0


def test_nce_loss_matches_jax():
    rng = np.random.RandomState(0)
    v, t = (0.3 * rng.randn(2, 8, C)).astype(np.float32)
    v[3] = t[3]  # one matching pair
    loss, metrics = nce_loss(torch.from_numpy(v), torch.from_numpy(t))
    ref_loss, ref = jax_e2e.nce_loss(jnp.asarray(v), jnp.asarray(t))
    np.testing.assert_allclose(loss.item(), float(ref_loss), atol=1e-6, rtol=1e-6)
    assert set(metrics) == set(ref)
    for k in ref:
        np.testing.assert_allclose(metrics[k].item(), float(ref[k]), atol=1e-6, err_msg=k)


# name -> (model flags, backprop_freq, f64, clip T and side).  train_bn_stats
# runs in f64 at 8 x 64²: normalising by the batch statistics of 4 clips at
# 4 x 32² (1 x 1 x 1 in mixed_5) is ill-conditioned, and flax's f32 batch
# statistics there are 1.9e-4 from an f64 computation at conv_2b alone
# (the port's 3.9e-6), so an f32 comparison measures JAX's rounding.
STEP_CASES = {
    "plain": ({}, 1, False, (4, 32)),
    "freeze_early": ({"freeze_early": True}, 1, False, (4, 32)),
    "backprop_freq2": ({}, 2, False, (4, 32)),
    "train_bn_stats": ({"train_bn_stats": True}, 1, True, (8, 64)),
}


def _step_batches(T, S, B=2, n=2, W=6, steps=3):
    rng = np.random.RandomState(0)
    colors = rng.rand(steps, B, n, 1, 1, 1, 3)  # a mean colour per clip: a signal to fit
    return [{"clips": (0.5 * colors[i] + 0.1 * rng.rand(B, n, T, S, S, 3)).astype(np.float32),
             "input_ids": rng.randint(0, len(VOCAB) + 1, (B, n, W)).astype(np.int32)}
            for i in range(steps)]


def _to_port(variables):
    return s3d_state_dict_from_jax({"params": variables["params"]["video"],
                                    "batch_stats": variables["batch_stats"],
                                    "text_params": variables["params"]["text"]})


def _jax_grad_fn(jm):
    """jax.grad of the loss that JAX's e2e step differentiates (the same
    flattening, BN mode and f32 InfoNCE), at the given params and stats."""
    train_stats = not jm.video.use_running_average

    @jax.jit
    def grads(params, batch_stats, batch):
        clips, ids = batch["clips"], batch["input_ids"]
        clips = clips.reshape((-1,) + clips.shape[2:])
        ids = ids.reshape(-1, ids.shape[-1])

        def loss_fn(p):
            variables = {"params": p, "batch_stats": batch_stats}
            v = (jm.video_embed(variables, clips, update_stats=True)[0] if train_stats
                 else jm.video_embed(variables, clips))
            t = jm.text_embed(variables, ids, (ids != 0).astype(jnp.int32))
            return jax_e2e.nce_loss(v.astype(jnp.float32), t.astype(jnp.float32))[0]

        return jax.grad(loss_fn)(params)

    return grads


def _to_jax(model_state):
    """The port's params and statistics in JAX's S3DWithText layout."""
    variables = s3d_torch_to_variables({k: v.detach() for k, v in model_state.items()}, [])
    return ({"video": variables["params"], "text": variables["text_params"]},
            variables["batch_stats"])


def _nest(flat):
    """{'a.b.c': x} -> {'a': {'b': {'c': x}}}, so optax's masks see the names."""
    out = {}
    for key, v in flat.items():
        *path, leaf = key.split(".")
        d = out
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = v
    return out


def _flat(tree, prefix=""):
    out = {}
    for key, v in tree.items():
        out.update(_flat(v, f"{prefix}{key}.") if isinstance(v, dict)
                   else {prefix + key: torch.from_numpy(np.array(v))})
    return out


def _rel(a, b):
    """‖a − b‖ / ‖b‖ in f64, or ‖a‖ when b is 0."""
    a, b = a.double(), b.double()
    nb = torch.linalg.vector_norm(b).item()
    diff = torch.linalg.vector_norm(a - b).item()
    return diff / nb if nb else diff


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_e2e_steps_match_jax(case):
    """Three steps (warm-up 0, lr · wd = 1e-3) from the same weights on the
    same clips: losses and metrics per step, then every param (the word
    embedding, which only the decay moves, included) and BN statistic.  As
    lr is small, the params check the decay and the cadence; the backward
    pass and the Adam update are held apart: each micro-step's gradient,
    leaf by leaf, against jax.grad of the same loss at the port's params of
    that step; and JAX's optax optimizer (its e2e mask, MultiSteps) fed the
    port's gradients: each update with the decay taken out, (Δw + lr·wd·w)/lr,
    and the Adam moments (and a part-done accumulator) at the end."""
    flags, k, f64, (T, S) = STEP_CASES[case]
    batches = _step_batches(T, S)
    cfg = dict(lr=LR, wd=WD, warmup_iterations=0, total_iterations=10, backprop_freq=k)
    dtype = np.float64 if f64 else np.float32
    batches = [{key: v.astype(dtype) if key == "clips" else v for key, v in b.items()}
               for b in batches]
    with jax.enable_x64(f64):
        jm = jax_e2e.S3DWithText(num_classes=C, vocab_size=len(VOCAB) + 1,
                                 dtype=jnp.float64 if f64 else jnp.float32, **flags)
        b0 = batches[0]
        variables = jax_s3d_variables(jm, jnp.asarray(b0["clips"][:, 0]),
                                      jnp.asarray(b0["input_ids"][:, 0]), seed=1)
        variables = jax.tree_util.tree_map(lambda a: np.asarray(a, dtype), variables)
        tx = jax_e2e.make_e2e_optimizer(JaxTrainConfig(**cfg), variables["params"])
        state = jax_e2e.E2ETrainState(step=jnp.zeros((), jnp.int32),
                                      params=variables["params"],
                                      batch_stats=variables["batch_stats"],
                                      opt_state=tx.init(variables["params"]))
        jax_step = jax_e2e.make_e2e_train_step(jm, tx)
        ref_metrics = []
        for b in batches:
            state, m = jax_step(state, {key: jnp.asarray(v) for key, v in b.items()})
            ref_metrics.append({key: float(v) for key, v in m.items()})
        ref = _to_port(jax.device_get({"params": state.params,
                                       "batch_stats": state.batch_stats}))

    model = S3DWithText(num_classes=C, vocab_size=len(VOCAB) + 1, **flags)
    if f64:
        model = model.double()
    init = {key: v.to(model.fc.weight.dtype) for key, v in _to_port(variables).items()}
    model.load_state_dict(init, strict=True)
    opt = make_e2e_optimizer(model, TrainConfig(**cfg))
    named = dict(model.named_parameters())
    grads, states = [], []
    apply = opt.step

    def spy():  # the micro-step's own gradient, before the accumulator sees it
        grads.append({n: (p.grad if p.grad is not None else torch.zeros_like(p)).clone()
                      for n, p in named.items()})
        return apply()

    opt.step = spy
    step = make_e2e_train_step(model, opt)
    for i, (b, want) in enumerate(zip(batches, ref_metrics)):
        states.append({key: v.clone() for key, v in model.state_dict().items()})
        got = step({key: torch.from_numpy(v) for key, v in b.items()})
        np.testing.assert_allclose(got["loss"].item(), want["loss"], atol=LOSS_TOL, rtol=0,
                                   err_msg=f"step {i}")
        np.testing.assert_allclose(got["grad_norm"].item(), want["grad_norm"], rtol=1e-3,
                                   err_msg=f"step {i}")
        for key in ("top1/v2t", "top1/t2v"):
            assert got[key].item() == want[key], (i, key)
    states.append(model.state_dict())

    ours = model.state_dict()
    assert set(ours) == set(ref)
    for key, v in ours.items():
        if "running" in key:
            np.testing.assert_allclose(v.numpy(), ref[key].numpy(), atol=STAT_TOL, rtol=0,
                                       err_msg=key)
        else:
            np.testing.assert_allclose(v.numpy(), ref[key].numpy(), atol=PARAM_ATOL,
                                       rtol=PARAM_RTOL, err_msg=key)
    embd = "text_module.word_embd.weight"
    assert not torch.equal(ours[embd], init[embd])  # the decay reached the frozen table
    moved_stats = [key for key in ours if "running" in key and not torch.equal(ours[key],
                                                                                 init[key])]
    assert bool(moved_stats) == bool(flags.get("train_bn_stats"))
    if flags.get("freeze_early"):  # only the decay moves the frozen stages
        w = "mixed_3c.conv_b0.conv1.weight"
        shrink = np.prod([1 - lr_at(TrainConfig(**cfg), t) * WD for t in range(3)])
        torch.testing.assert_close(ours[w], init[w] * float(shrink), atol=1e-7, rtol=1e-6)

    with jax.enable_x64(f64):
        jax_grad = _jax_grad_fn(jm)
        for i, b in enumerate(batches):
            params, stats = _to_jax(states[i])
            want = _to_port(jax.device_get({"params": jax_grad(params, stats, b),
                                            "batch_stats": {}}))
            assert set(want) == set(grads[i])
            for n, g in grads[i].items():
                bar = GRAD_RTOL * torch.linalg.vector_norm(want[n].double()).item() + GRAD_ATOL
                err = torch.linalg.vector_norm(g.double() - want[n].double()).item()
                assert err <= bar, (i, n, err, bar)

        tree = _nest({n: states[0][n].numpy() for n in named})
        tx = jax_e2e.make_e2e_optimizer(JaxTrainConfig(**cfg), tree)
        opt_state = tx.init(tree)

        @jax.jit
        def optax_step(g, opt_state, params):
            updates, opt_state = tx.update(g, opt_state, params)
            return optax.apply_updates(params, updates), opt_state

        for i, g in enumerate(grads):
            after, opt_state = optax_step(_nest({n: v.numpy() for n, v in g.items()}),
                                          opt_state, _nest({n: states[i][n].numpy()
                                                            for n in named}))
            after = _flat(jax.device_get(after))
            if (i + 1) % k:  # a micro-step of backprop_freq: nothing moves
                for n in named:
                    assert torch.equal(states[i + 1][n], states[i][n]), (i, n)
                    assert torch.equal(after[n], states[i][n]), (i, n)
                continue
            lr = lr_at(TrainConfig(**cfg), (i + 1) // k - 1)
            visible = 0.0
            for n in named:
                wd = 0.0 if no_decay(n, "e2e") else WD
                w0 = states[i][n].double()
                u_ours = (states[i + 1][n].double() - w0 * (1 - lr * wd)) / lr
                u_optax = (after[n].double() - w0 * (1 - lr * wd)) / lr
                bar = UPDATE_ATOL * (1 + w0.abs())
                assert ((u_ours - u_optax).abs() <= bar).all(), (
                    i, n, (u_ours - u_optax).abs().max().item())
                visible = max(visible, u_optax.abs().max().item())
            assert visible > 0.5, (i, visible)  # Adam's ~±1 step, not the decay alone
        for name, slot in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            want = _flat(jax.device_get(optax.tree_utils.tree_get(opt_state, name)))
            for n, p in named.items():
                assert _rel(opt.adamw.state[p][slot], want[n]) <= MOMENT_RTOL, (name, n)
        if k > 1:  # the third micro-step waits in the accumulator
            want = _flat(jax.device_get(optax.tree_utils.tree_get(opt_state, "acc_grads")))
            for n, a in zip(named, opt._acc):
                assert _rel(a, want[n]) <= MOMENT_RTOL, n


# ------------------------------------------------------------------ data


def _write_csv(path, rows):
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["vid", "text", "timestamp"])
        w.writeheader()
        for r in rows:
            w.writerow(r)


def _htm_aa_rows(rng, videos=6):
    rows = []
    for v in range(videos):
        for j in range(1 + v % 3):  # one, two or three pairs per video
            rows.append({"vid": f"vid{v}", "text": " ".join(rng.choice(VOCAB, 4)),
                         "timestamp": round(5.0 + 9.5 * j + v, 3)})
    return rows


def _cropping_decoder(path, ts, T, fps, S, rng=None, center_crop_only=False):
    """Frames that depend on the rng's crop draws; one timestamp fails."""
    if ts == 15.5:
        raise RuntimeError("decode failed")
    frames = synthetic_decode(path, ts, T, fps, S + 4)
    y, x = rng.randint(0, 5), rng.randint(0, 5)
    return frames[:, y:y + S, x:x + S]


@pytest.mark.parametrize("decoder", [synthetic_decode, _cropping_decoder],
                         ids=["synthetic", "cropping_and_failing"])
def test_clip_dataset_and_loader_equal_jax(tmp_path, decoder):
    """The same csv, tokenizer words and seed give bit-equal samples (the grey
    fill of a failed decode included) and bit-equal loader batches."""
    _write_csv(tmp_path / "htm_aa.csv", _htm_aa_rows(np.random.RandomState(3)))
    kw = dict(num_frames=4, fps=5, num_sample_per_video=2, crop_size=16, max_words=6,
              decoder=decoder, check_existence=False)
    ours = HTMClipDataset(str(tmp_path / "htm_aa.csv"), str(tmp_path),
                          tokenizer=Word2VecTokenizer(VOCAB, max_words=6), **kw)
    ref = JaxHTMClipDataset(str(tmp_path / "htm_aa.csv"), str(tmp_path),
                            tokenizer=JaxTokenizer(VOCAB, max_words=6), **kw)
    assert ours.vid_list == ref.vid_list and len(ours) == 6
    greys = 0
    for i in range(len(ours)):
        a = ours.sample(i, np.random.RandomState(i))
        b = ref.sample(i, np.random.RandomState(i))
        for key in ("clips", "input_ids"):
            assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key]), (i, key)
        greys += int((a["clips"] == 0.5).all(axis=(1, 2, 3, 4)).sum())
    assert (greys > 0) == (decoder is _cropping_decoder)
    loader = TrainLoader(ours, 2, seed=7, num_workers=2)
    ref_loader = JaxTrainLoader(ref, 2, seed=7, num_workers=2)
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        ref_loader.set_epoch(epoch)
        got, want = list(loader), list(ref_loader)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            for key in w:
                assert np.array_equal(g[key].numpy(), np.asarray(w[key])), (epoch, key)


# ------------------------------------------------------------ checkpoints


def test_checkpointer_ranks_by_loss_as_orbax(tmp_path):
    """best_metric='loss' with {'loss': -mean} keeps the same 5 epochs as the
    JAX package's orbax Checkpointer(best_metric='loss') (its BestN)."""
    from temporalalignnet_tpu.checkpoint.orbax_io import Checkpointer as JaxCheckpointer

    ours = Checkpointer(str(tmp_path / "ours"), best_metric="loss")
    ref = JaxCheckpointer(str(tmp_path / "ref"), best_metric="loss")
    try:
        for epoch, mean in enumerate([3.1, 2.5, 2.9, 2.2, 2.6, 2.4, 3.5, 2.1, 2.45]):
            metrics = {"loss": -mean}
            ours.save_epoch({"iteration": epoch, "w": torch.zeros(2)}, epoch, metrics)
            ref.save_epoch({"w": np.zeros(2, np.float32)}, epoch, metrics)
            ref.wait()
            assert ours.epochs() == sorted(ref._epoch.all_steps()), epoch
            assert ours.best_epoch() == ref.best_epoch(), epoch
    finally:
        ref.close()
    assert ours.best_epoch() == 7
    assert Checkpointer(str(tmp_path / "ours")).best_metric == "Recall"  # the default


# ------------------------------------------------------------------- CLI


def _cli_files(root):
    """A csv of 4 videos, the vocab, and a complete s3d_howto100m.pth-format
    file of random weights (BN statistics randomised) that both CLIs start
    from."""
    rng = np.random.RandomState(5)
    _write_csv(root / "htm_aa.csv", _htm_aa_rows(rng, videos=4))
    np.save(root / "vocab.npy", np.array(VOCAB))
    model = S3DWithText(num_classes=C, vocab_size=len(VOCAB) + 1)
    model.init_weights(torch.Generator().manual_seed(11))
    g = torch.Generator().manual_seed(12)
    sd = model.state_dict()
    for key, v in sd.items():
        if key.endswith("running_mean"):
            v.copy_(torch.rand(v.shape, generator=g) * 0.4 - 0.2)
        elif key.endswith("running_var"):
            v.copy_(torch.rand(v.shape, generator=g) + 0.5)
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               root / "s3d_howto100m.pth")
    return root


def _cli_args(root, prefix, pretrain):
    return ["--htm_aa_csv", str(root / "htm_aa.csv"), "--video_root", str(root),
            "--vocab", str(root / "vocab.npy"), "--pretrain", str(pretrain),
            "--decoder", "synthetic", "--check_existence", "0", "--num_frames", "4",
            "--crop_size", "32", "--num_classes", str(C), "--max_words", "6",
            "--batch_size", "2", "--epochs", "2", "--lr", str(LR), "--wd", str(WD),
            "--warmup_iterations", "1", "--num_workers", "2", "--log_every", "1",
            "--runtime_save_iter", "3", "--seed", "0", "--debug_batch_hash", "1",
            "--prefix", str(root / prefix)]


def _hashes(text):
    return [l.split("[batchhash] ")[1] for l in text.splitlines() if "[batchhash]" in l]


def test_e2e_cli_matches_jax(tmp_path, capsys):
    """Both CLIs from one pretrain file, synthetic clips, f32 on the CPU:
    the same batches (crc32), the same final JSON within the step bars; the
    port's runtime and epoch checkpoints, and its params_latest.pth in the
    s3d_howto100m.pth key space, which JAX's converter reads whole and the
    port's --pretrain loads with no missing key."""
    from temporalalignnet_torch.train.end2end_cli import main

    root = _cli_files(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS="--xla_force_host_platform_device_count=1")
    ref_proc = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "mp_e2e_worker.py"),
         *_cli_args(root, "jax", root / "s3d_howto100m.pth")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        ours = main(_cli_args(root, "port", root / "s3d_howto100m.pth") + ["--device", "cpu"])
        out = capsys.readouterr().out
        ref_out, _ = ref_proc.communicate(timeout=600)
    finally:
        if ref_proc.poll() is None:
            ref_proc.kill()
    assert ref_proc.returncode == 0, ref_out[-4000:]
    assert "[pretrain]" not in out and "[pretrain]" not in ref_out  # every key in the file
    final = json.loads(out.strip().splitlines()[-1])
    ref = json.loads([l for l in ref_out.splitlines() if l.startswith("{")][-1])
    assert _hashes(out) == _hashes(ref_out) and len(_hashes(out)) == 8  # 4 steps x 2 tensors
    assert final["final_step"] == ref["final_step"] == 4
    assert set(final) == set(ref)
    np.testing.assert_allclose(final["loss"], ref["loss"], atol=LOSS_TOL, rtol=0)
    np.testing.assert_allclose(final["grad_norm"], ref["grad_norm"], rtol=1e-3)
    for key in ("top1/v2t", "top1/t2v"):
        assert final[key] == ref[key], key
    assert ours == {k: v for k, v in final.items() if k != "final_step"}

    exp = root / "port" / f"e2e_bs2_lr{LR}_f4"
    assert os.listdir(exp / "runtime") == ["step_000000003.pth.tar"]
    assert sorted(os.listdir(exp / "epoch")) == ["epoch_00000.pth.tar", "epoch_00001.pth.tar"]
    assert Checkpointer(str(exp), best_metric="loss").latest_step() == 4
    assert (exp / "e2e.metrics.jsonl").exists()
    export = torch.load(exp / "params_latest.pth", weights_only=True)
    S3DWithText(num_classes=C, vocab_size=len(VOCAB) + 1).load_state_dict(export, strict=True)
    report = []
    converted = s3d_torch_to_variables(export, report)
    assert report == [] and converted["text_params"] is not None
    loaded = s3d_state_dict(load_milnce_checkpoint(str(exp / "params_latest.pth")))
    assert set(loaded) == set(export)

    again = main(_cli_args(root, "again", exp / "params_latest.pth")
                 + ["--device", "cpu", "--max_steps", "2"])
    assert "[pretrain]" not in capsys.readouterr().out
    assert np.isfinite(again["loss"])


@pytest.mark.parametrize("flag", [["--multihost"], ["--coordinator", "h:1"],
                                  ["--num_processes", "2"], ["--process_id", "0"]])
def test_e2e_cli_refuses_the_multi_host_flags(flag, tmp_path, capsys):
    """The JAX CLI's multi-host flags: ``--multihost`` in a world of one
    trains (its ``[multihost]`` line, the export written by process 0);
    the coordinates without ``--multihost`` are refused, and so is
    ``--process_id`` without ``--num_processes``, as jax.distributed takes
    them together."""
    import socket

    from temporalalignnet_torch.train.end2end_cli import main

    root = _cli_files(tmp_path)
    argv = _cli_args(root, "mh", root / "s3d_howto100m.pth") + ["--device", "cpu",
                                                               "--max_steps", "1"]
    if flag == ["--multihost"]:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        out = main(argv + flag + ["--coordinator", f"127.0.0.1:{port}", "--num_processes", "1",
                                  "--process_id", "0"])
        assert "[multihost] process 0/1 builds batch rows [0, 2)" in capsys.readouterr().out
        assert np.isfinite(out["loss"]) and not torch.distributed.is_initialized()
        assert list((root / "mh").glob("*/params_latest.pth"))
        return
    if flag == ["--process_id", "0"]:
        with pytest.raises(SystemExit, match="--num_processes"):
            main(argv + ["--multihost"] + flag)
        return
    with pytest.raises(SystemExit, match="goes with --multihost"):
        main(argv + flag)


def test_e2e_cli_defaults_to_the_card(tmp_path):
    from temporalalignnet_torch.train.end2end_cli import main

    root = _cli_files(tmp_path)
    with pytest.raises(SystemExit, match="no CUDA device"):
        main(["--htm_aa_csv", str(root / "htm_aa.csv"), "--video_root", str(root),
              "--vocab", str(root / "vocab.npy")])
