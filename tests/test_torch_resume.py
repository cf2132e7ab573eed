"""Checkpoint rotation and exact resume of the port's trainer, on the CPU with
a tiny model: the optimizer's state round trip mid-accumulation, a stopped
and resumed run against an uninterrupted one (Stage 1 mid-epoch; cotrain
with backprop_freq 2 stopped mid-accumulation), the epoch rotation against
the JAX package's orbax Checkpointer, a SIGKILL during a save, the refusal
of a reference checkpoint, and the downstream evals at a runtime save."""

import copy
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from port_fixtures import CLI_SHAPE, TINY, write_feature_dir
from temporalalignnet_torch.checkpoint import Checkpointer
from temporalalignnet_torch.core.config import ModelConfig, TrainConfig
from temporalalignnet_torch.models.net import TANWithText
from temporalalignnet_torch.train import Optimizer
from temporalalignnet_torch.train.cli import main as train_main

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The tiny HowTo100M-format directory (6 training videos: 3 steps per
    epoch at batch 2), with a YC2 annotation and an HTM-Align one over the
    same features."""
    root = write_feature_dir(tmp_path_factory.mktemp("resume"))
    db = {}
    for v in (0, 1, 2, 3):
        suffix = ".mp4.npy" if v % 2 else ".webm.npy"
        vlen = np.load(root / "features" / f"vid{v}{suffix}").shape[0]
        db[f"vid{v}"] = {"subset": "validation", "duration": float(vlen), "annotations": [
            {"segment": [s, s + d], "sentence": f"w{v} w{s % 7} w{d}"}
            for s, d in ((2.0, 9.0), (20.0, 40.0), (45.0, 20.0))]}
    (root / "yc2.json").write_text(json.dumps({"database": db}))
    anno = {f"vid{v}": [[1, 3.0, 9.0, "w1 w2"], [0, 12.0, 20.0, "w3"], [1, 30.0, 41.0, "w4 w5"]]
            for v in (0, 2)}
    (root / "align.json").write_text(json.dumps(anno))
    return root


def _args(data, prefix, *extra):
    return ["--feature_dir", str(data / "features"), "--captions", str(data / "captions.json"),
            "--vocab", str(data / "vocab.npy"), "--device", "cpu", "--batch_size", "2",
            "--seq_len", "32", "--max_sentences", "4", "--log_every", "1",
            "--num_workers", "2", "--epochs", "3", "--warmup_iterations", "2",
            "--prefix", str(prefix), *CLI_SHAPE, *extra]


def _logged(text):
    """The per-step log lines, without their host-clock rate."""
    return [{k: v for k, v in json.loads(l).items() if k != "steps_per_s"}
            for l in text.splitlines() if l.startswith('{"step"')]


def _final_state(out):
    """The last epoch checkpoint of a run: weights (both halves of a twin),
    optimizer state with its accumulator, and the resume state."""
    ckpt = Checkpointer(os.path.dirname(out["checkpoint"]))
    return torch.load(ckpt.epoch_path(ckpt.epochs()[-1]), map_location="cpu", weights_only=True)


def _assert_equal(a, b, path=""):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype, path
        assert torch.equal(a, b), path
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


# ---------------------------------------------------------------- optimizer


@pytest.mark.parametrize("capturable", [False, True], ids=["host_form", "device_form"])
def test_optimizer_state_round_trip_mid_accumulation(tmp_path, capturable):
    """backprop_freq 3, saved after 4 micro-steps (one update, one gradient
    in the accumulator) and loaded into a fresh optimizer of a copy of the
    model: both continue bit-equal, in either form of the optimizer (the
    device form's static accumulator and device counters round-trip the
    same file format)."""
    model = TANWithText(ModelConfig(**TINY), vocab_size=51)
    model.init_weights(torch.Generator().manual_seed(0))
    cfg = TrainConfig(lr=1e-3, warmup_iterations=1, total_iterations=10, backprop_freq=3,
                      clip_grad_norm=1.0)
    gen = torch.Generator().manual_seed(1)
    grads = [[torch.randn(p.shape, generator=gen) for p in model.parameters()]
             for _ in range(9)]

    def run(opt, mdl, seq):
        for gs in seq:
            for p, g in zip(mdl.parameters(), gs):
                p.grad = g.clone()
            opt.step()

    opt = Optimizer(model, cfg, capturable=capturable)
    run(opt, model, grads[:4])
    assert opt.updates == 1 and opt.micro == 1
    torch.save(opt.state_dict(), tmp_path / "opt.pt")
    twin = copy.deepcopy(model)
    opt2 = Optimizer(twin, cfg, capturable=capturable)
    opt2.load_state_dict(torch.load(tmp_path / "opt.pt", weights_only=True))
    run(opt, model, grads[4:])
    run(opt2, twin, grads[4:])
    assert opt.updates == opt2.updates == 3 and opt.micro == opt2.micro == 0
    for a, b in zip(model.parameters(), twin.parameters()):
        assert torch.equal(a, b)
    _assert_equal(opt.state_dict(), opt2.state_dict())


# ------------------------------------------------------------ exact resume


@pytest.mark.parametrize("case,stop_at", [
    ("stage1", 4),                # epoch 1, batch 1
    ("cotrain_bf2", 5),           # epoch 1, batch 2; one micro-step accumulated
], ids=["stage1_mid_epoch", "cotrain_backprop_freq2_mid_accumulation"])
def test_resumed_run_equals_uninterrupted(data, tmp_path, capsys, case, stop_at):
    extra = ["--model", "cotrain", "--backprop_freq", "2", "--momentum_m", "0.9"] \
        if case == "cotrain_bf2" else []
    whole = train_main(_args(data, tmp_path / "a", *extra))
    logged_whole = _logged(capsys.readouterr().out)
    first = train_main(_args(data, tmp_path / "b", *extra, "--max_steps", str(stop_at),
                             "--runtime_save_iter", str(stop_at)))
    logged_first = _logged(capsys.readouterr().out)
    saved = _final_state(first)
    if case == "cotrain_bf2":
        assert saved["optimizer"]["micro"] == 1 and saved["optimizer"]["acc"] is not None
        assert saved["resume"]["twin"] == {"micro_steps": stop_at}
    resumed = train_main(_args(data, tmp_path / "b", *extra, "--resume", "auto"))
    printed = capsys.readouterr().out
    assert f"[resume] at step {stop_at} (epoch 1, batch {stop_at - 3})" in printed
    assert resumed["final_step"] == whole["final_step"] == 9
    assert len(logged_whole) == 9 and logged_first + _logged(printed) == logged_whole
    a, b = _final_state(whole), _final_state(resumed)
    for key in ("state_dict", "optimizer", "resume", "iteration", "epoch"):
        _assert_equal(a[key], b[key], key)
    if case == "cotrain_bf2":
        assert any(k.startswith("target.") for k in a["state_dict"])


def test_resume_refuses_a_reference_checkpoint(data, tmp_path):
    """A checkpoint in the reference layout (a bare AdamW state_dict, no step
    or generator state) cannot continue a run exactly; JAX's trainer cannot
    resume from one either."""
    model = TANWithText(ModelConfig(**{**TINY, "num_pos_embeds": 1024}), vocab_size=51)
    adamw = torch.optim.AdamW(model.parameters())
    path = str(tmp_path / "reference.pth.tar")
    torch.save({"epoch": 3, "state_dict": model.state_dict(), "best_acc": 0.4,
                "optimizer": adamw.state_dict(), "iteration": 12}, path)
    with pytest.raises(SystemExit, match="no resume state"):
        train_main(_args(data, tmp_path, "--resume", path))
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(SystemExit, match="no checkpoint"):
        train_main(_args(data, tmp_path, "--resume", str(empty)))


# ----------------------------------------------------------------- rotation


@pytest.mark.parametrize("recalls", [
    [0.1, 0.5, 0.3, 0.2, 0.6, 0.05, 0.4, 0.5, 0.7],   # the new epoch can drop at once
    [0.2, 0.2, None, 0.2, 0.1, 0.2, None, 0.3],        # ties; epochs without an eval (0.0)
    [0.9, 0.8, 0.7, 0.6, 0.5, 0.4, 0.3],               # falling
], ids=["mixed", "ties_and_missing", "falling"])
def test_rotation_matches_jax_checkpointer(tmp_path, recalls):
    """The same epoch metrics leave the same epochs as the JAX package's
    Checkpointer (orbax best_fn, max 5), also across a reopen of the
    directory, and the runtime manager keeps the newest step only."""
    from temporalalignnet_tpu.checkpoint.orbax_io import Checkpointer as JaxCheckpointer

    ours_dir, ref_dir = tmp_path / "ours", tmp_path / "ref"
    ours, ref = Checkpointer(str(ours_dir)), JaxCheckpointer(str(ref_dir))
    for epoch, r in enumerate(recalls):
        metrics = {} if r is None else {"Recall": r, "AUC": 0.5}
        if epoch == 4:  # a new process opens the directories
            ref.close()
            ours, ref = Checkpointer(str(ours_dir)), JaxCheckpointer(str(ref_dir))
        ours.save_epoch({"iteration": 10 * epoch, "w": torch.zeros(2)}, epoch, metrics)
        ref.save_epoch({"w": np.zeros(2, np.float32)}, epoch, metrics)
        ref.wait()
        assert ours.epochs() == sorted(ref._epoch.all_steps()), epoch
        assert ours.best_epoch() == ref.best_epoch(), epoch
    assert sorted(os.listdir(ours_dir / "epoch")) == [
        f"epoch_{e:05d}.pth.tar" for e in sorted(ref._epoch.all_steps())]
    for step in (97, 104, 121):
        ours.save_runtime({"iteration": step}, step)
        ref.save_runtime({"w": np.zeros(2, np.float32)}, step)
    ref.wait()
    assert os.listdir(ours_dir / "runtime") == ["step_000000121.pth.tar"]
    assert ref._runtime.all_steps() == [121]
    ref.close()
    newest = Checkpointer(str(ours_dir))
    assert newest.latest_step() == 121 and newest.restore() == {"iteration": 121}


def test_newest_checkpoint_is_the_latest_step_of_either_kind(tmp_path):
    ck = Checkpointer(str(tmp_path))
    assert ck.latest() is None and ck.latest_step() is None
    ck.save_runtime({"iteration": 6}, 6)
    ck.save_epoch({"iteration": 9, "x": 1}, 2, {"Recall": 0.1})
    assert ck.latest_step() == 9 and ck.restore()["x"] == 1
    ck.save_runtime({"iteration": 9, "x": 2}, 9)  # a tie goes to the runtime file
    assert ck.restore()["x"] == 2


def test_latest_looks_up_a_directory_without_changing_it(tmp_path):
    """``--resume <dir>`` reads another experiment's newest checkpoint: the
    same file the directory's Checkpointer would restore, found without
    creating its subdirectories or clearing its temporary files."""
    from temporalalignnet_torch.checkpoint import latest

    ck = Checkpointer(str(tmp_path / "exp"))
    ck.save_epoch({"iteration": 12}, 1, {"Recall": 0.3})
    ck.save_runtime({"iteration": 8}, 8)
    stray = tmp_path / "exp" / "runtime" / "step_000000016.pth.tar.tmp123"
    stray.write_bytes(b"partial")
    assert latest(str(tmp_path / "exp")) == ck.latest() == (12, ck.epoch_path(1))
    assert stray.exists()
    assert latest(str(tmp_path / "none")) is None and not (tmp_path / "none").exists()


# ------------------------------------------------------------------- SIGKILL


@pytest.mark.parametrize("landing", ["mid_write", "before_rotation"])
def test_sigkill_during_a_save_leaves_a_restorable_checkpoint(data, tmp_path, landing):
    """The trainer saves at steps 2 and 4 (and epoch 0 at step 3); a SIGKILL
    lands inside the step-4 save (its temporary file half written; or the new
    file renamed into place with the step-2 file not yet deleted).  The
    newest finished checkpoint restores, the temporary file is cleared, and
    ``--resume auto`` finishes the run bit-equal to an uninterrupted one."""
    whole = train_main(_args(data, tmp_path / "a"))
    marker = tmp_path / "marker"
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(REPO), str(REPO / "tests")]),
           "TAN_KILL_MARKER": str(marker), "TAN_KILL_AT_STEP": "4",
           "TAN_KILL_LANDING": landing}
    child = subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "torch_kill_worker.py"),
         *_args(data, tmp_path / "b", "--runtime_save_iter", "2")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 120
        while not marker.exists():
            assert child.poll() is None, child.communicate()[0][-3000:]
            assert time.monotonic() < deadline, "the worker never reached the step-4 save"
            time.sleep(0.01)
        child.send_signal(signal.SIGKILL)
    finally:
        child.kill()
        child.wait(timeout=60)

    exp = Path(whole["checkpoint"].replace(str(tmp_path / "a"), str(tmp_path / "b"))).parent
    runtime = sorted(os.listdir(exp / "runtime"))
    if landing == "mid_write":
        assert len(runtime) == 2 and runtime[1].startswith("step_000000004.pth.tar.tmp")
    else:
        assert runtime == ["step_000000002.pth.tar", "step_000000004.pth.tar"]
    ck = Checkpointer(str(exp))
    newest = 3 if landing == "mid_write" else 4  # epoch 0 ended at step 3
    assert ck.latest_step() == newest and ck.restore()["resume"]["step"] == newest
    assert not [f for f in os.listdir(exp / "runtime") if ".tmp" in f]

    resumed = train_main(_args(data, tmp_path / "b", "--runtime_save_iter", "2",
                               "--resume", "auto"))
    assert resumed["final_step"] == 9
    _assert_equal(_final_state(whole)["state_dict"], _final_state(resumed)["state_dict"])
    assert os.listdir(exp / "runtime") == ["step_000000008.pth.tar"]


# ------------------------------------------------------- downstream evals


@pytest.mark.parametrize("policy", ["default", "bce"])
def test_runtime_save_runs_the_downstream_evals(data, tmp_path, capsys, policy):
    """At each runtime save: HTM-Align and YC2 retrieval; --optim_policy bce
    skips YC2 (train/main.py:196-197).  ``--test`` runs the same evals on a
    checkpoint and exits."""
    evals = ["--align_anno", str(data / "align.json"), "--yc2_anno", str(data / "yc2.json"),
             "--use_alignability_head", "1", "--optim_policy", policy]
    out = train_main(_args(data, tmp_path, *evals, "--max_steps", "2",
                           "--runtime_save_iter", "1"))
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()
             if l.startswith('{"eval_step"')]
    assert [l["eval_step"] for l in lines] == [1, 2, 2]
    retrieval = {f"{p}{m}" for p in ("", "C-", "S-") for m in ("R1", "R5", "R10", "MR")}
    for line in lines:
        assert {"Recall", "AUC"} <= set(line)
        assert (retrieval <= set(line)) == (policy == "default")
    tested = train_main(_args(data, tmp_path / "t", *evals, "--test", out["checkpoint"]))
    assert tested == {k: v for k, v in lines[-1].items() if k != "eval_step"}
