"""The port's data-parallel entry points on 2 gloo processes on the CPU
(``tests/torch_mp_worker.py``, started once for the module) against one
process on the same data: each rank's loader rows, the sharded align and
retrieval CLIs (``--multihost --shard_eval``), the train CLI and the e2e CLI
(``--multihost``), and the e2e step with frozen and with trained BN
statistics (counterparts of JAX's tests/test_multiprocess.py:213, 236, 304,
412)."""

import json

import numpy as np
import pytest
import torch

from port_fixtures import CLI_SHAPE, TINY, Ranks, write_feature_dir
from temporalalignnet_torch.checkpoint import save_reference_checkpoint
from temporalalignnet_torch.core.config import DataConfig, ModelConfig, TrainConfig
from temporalalignnet_torch.data import HTMFeatureDataset, TrainLoader
from temporalalignnet_torch.models.net import TANWithText
from temporalalignnet_torch.models.word2vec import Word2VecTokenizer
from temporalalignnet_torch.parallel.mesh import local_batch_rows
from temporalalignnet_torch.train.end2end import (S3DWithText, make_e2e_optimizer,
                                                  make_e2e_train_step)

torch.set_num_threads(2)

LOSS_TOL = 2e-4  # whole steps (tests/test_torch_train.py)
# per gradient tensor: |a - b| <= E2E_GRAD_TOL · (|b| + |whole gradient|), f32-level: f64 clips,
# but the InfoNCE runs in f32, whose rounding reaches a tensor whose gradient
# cancels to near 0 (the text tower's last bias)
E2E_GRAD_TOL = 1e-5
E2E = dict(num_classes=16, vocab_size=51)
E2E_TRAIN = dict(lr=1e-4, warmup_iterations=0, total_iterations=10)
DATA = dict(seq_len=32, max_sentences=4, max_words=8)


def _write_data(root):
    """The tiny HowTo100M-format directory with a YC2 and an HTM-Align
    annotation over its features (tests/test_torch_resume.py::data), and a
    tiny TAN checkpoint for the eval CLI."""
    write_feature_dir(root)
    db = {}
    for v in (0, 1, 2, 3):
        suffix = ".mp4.npy" if v % 2 else ".webm.npy"
        vlen = np.load(root / "features" / f"vid{v}{suffix}").shape[0]
        db[f"vid{v}"] = {"subset": "validation", "duration": float(vlen), "annotations": [
            {"segment": [s, s + d], "sentence": f"w{v} w{s % 7} w{d}"}
            for s, d in ((2.0, 9.0), (20.0, 40.0), (45.0, 20.0))]}
    (root / "yc2.json").write_text(json.dumps({"database": db}))
    anno = {f"vid{v}": [[1, 3.0, 9.0, "w1 w2"], [0, 12.0, 20.0, "w3"], [1, 30.0, 41.0, "w4 w5"],
                        [1, 50.0, 58.0, "w6"]] for v in (0, 2, 3)}
    (root / "align.json").write_text(json.dumps(anno))
    model = TANWithText(ModelConfig(**{**TINY, "num_pos_embeds": 1024},
                                    use_alignability_head=True), vocab_size=51)
    model.init_weights(torch.Generator().manual_seed(3))
    save_reference_checkpoint(str(root / "tan.pth.tar"), model)
    return root


def _eval_args(root, task):
    common = ["--ckpt", str(root / "tan.pth.tar"), "--features", str(root / "features"),
              "--vocab", str(root / "vocab.npy"), "--seq_len", "32", "--device", "cpu",
              *CLI_SHAPE]
    if task == "retrieval":
        return ["--task", "retrieval", "--anno", str(root / "yc2.json"), "--num_clips", "4",
                "--batch_windows", "12", *common]
    return ["--task", "align", "--anno", str(root / "align.json"), "--batch_windows", "3",
            "--method", task, *common]


def _train_args(root, prefix):
    return ["--feature_dir", str(root / "features"), "--captions", str(root / "captions.json"),
            "--vocab", str(root / "vocab.npy"), "--device", "cpu", "--batch_size", "4",
            "--seq_len", "32", "--max_sentences", "4", "--log_every", "1", "--num_workers", "2",
            "--epochs", "3", "--warmup_iterations", "1", "--runtime_save_iter", "2",
            "--use_alignability_head", "1", "--loss_threshold", "0.5",
            "--align_anno", str(root / "align.json"), "--yc2_anno", str(root / "yc2.json"),
            "--prefix", str(root / prefix), *CLI_SHAPE]


def _e2e_files(root):
    vocab = [f"w{i}" for i in range(50)]
    np.save(root / "e2e_vocab.npy", np.array(vocab))
    rng = np.random.RandomState(1)
    rows = ["vid,text,timestamp"]
    for v in range(4):
        for j in range(2):
            rows.append(f"e2e{v},{' '.join(rng.choice(vocab, 3))},{10.0 + 7.0 * j}")
    (root / "htm_aa.csv").write_text("\n".join(rows) + "\n")


def _e2e_cli_args(root, prefix):
    return ["--htm_aa_csv", str(root / "htm_aa.csv"), "--video_root", str(root),
            "--vocab", str(root / "e2e_vocab.npy"), "--decoder", "synthetic",
            "--check_existence", "0", "--num_frames", "4", "--crop_size", "32",
            "--num_classes", "16", "--max_words", "6", "--batch_size", "2", "--epochs", "1",
            "--warmup_iterations", "1", "--num_workers", "2", "--log_every", "1",
            "--runtime_save_iter", "0", "--seed", "0", "--device", "cpu",
            "--prefix", str(root / prefix)]


def _e2e_case(train_bn_stats):
    """A model of random weights (BN statistics randomised) and a global
    batch of 4 videos x 2 clips of 4 x 32², in f64."""
    model = S3DWithText(**E2E, train_bn_stats=train_bn_stats).double()
    model.init_weights(torch.Generator().manual_seed(11))
    g = torch.Generator().manual_seed(12)
    for key, v in model.state_dict().items():
        if key.endswith("running_mean"):
            v.copy_(torch.rand(v.shape, generator=g, dtype=v.dtype) * 0.4 - 0.2)
        elif key.endswith("running_var"):
            v.copy_(torch.rand(v.shape, generator=g, dtype=v.dtype) + 0.5)
    rng = np.random.RandomState(2)
    batch = {"clips": rng.rand(4, 2, 4, 32, 32, 3),
             "input_ids": rng.randint(1, 51, size=(4, 2, 6)).astype(np.int64)}
    return model, batch


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = _write_data(tmp_path_factory.mktemp("mp"))
    _e2e_files(root)
    jobs = [dict(name="loader", kind="loader", vocab=str(root / "vocab.npy"), words=8,
                 features=str(root / "features"), captions=str(root / "captions.json"),
                 data_kw=DATA, batch_size=4, seed=0, epoch=1)]
    for flags in (False, True):
        model, batch = _e2e_case(flags)
        jobs.append(dict(name=f"e2e_{int(flags)}", kind="e2e", state_dict=model.state_dict(),
                         model_kw=dict(E2E, train_bn_stats=flags), train_kw=E2E_TRAIN,
                         batch=batch))
    for task in ("overlap-seq", "global", "retrieval"):
        jobs.append(dict(name=f"eval_{task}", kind="cli", module="temporalalignnet_torch.eval.cli",
                         argv=_eval_args(root, task) + ["--shard_eval"]))
    jobs.append(dict(name="train_cli", kind="cli", module="temporalalignnet_torch.train.cli",
                     argv=_train_args(root, "dp2")))
    jobs.append(dict(name="e2e_cli", kind="cli",
                     module="temporalalignnet_torch.train.end2end_cli",
                     argv=_e2e_cli_args(root, "e2e_dp2")))
    r = Ranks(tmp_path_factory.mktemp("jobs"), jobs)
    r.root = root
    yield r
    r.stop()


def test_loader_rows_are_the_global_batch_slice(ranks):
    """Each rank builds rows [lo, hi) of every global batch, bit-equal to
    those rows of the 1-process loader's (each sample from the generator of
    its index in the epoch)."""
    root = ranks.root
    tok = Word2VecTokenizer(str(root / "vocab.npy"), max_words=8)
    ds = HTMFeatureDataset(str(root / "features"), str(root / "captions.json"),
                           DataConfig(**DATA), "train", tok, cache_videos=0)
    full = TrainLoader(ds, 4, seed=0, num_workers=2)
    full.set_epoch(1)
    full = list(full)
    for r, out in enumerate(ranks.result("loader")):
        lo, hi = out["rows"]
        assert (lo, hi) == (2 * r, 2 * r + 2)
        assert len(out["batches"]) == len(full) > 0
        for ours, ref in zip(out["batches"], full):
            assert set(ours) == set(ref)
            for k in ref:
                assert torch.equal(ours[k], ref[k][lo:hi]), (r, k)


def test_loader_local_rows_contract():
    """The contract alone (JAX tests/test_multiprocess.py:412): rows [2, 4)
    of each batch of 4; no rows outside the batch; a world that does not
    divide the batch is refused."""
    class _DS:
        def __len__(self):
            return 8

        def sample(self, i, rng):
            return {"x": np.full((2,), i, np.float32), "r": rng.rand(1)}

    full = list(TrainLoader(_DS(), 4, num_workers=1))
    half = list(TrainLoader(_DS(), 4, num_workers=1, local_rows=(2, 4)))
    assert len(full) == len(half) == 2
    for fb, hb in zip(full, half):
        for k in fb:
            assert torch.equal(hb[k], fb[k][2:4])
    with pytest.raises(ValueError, match="local_rows"):
        TrainLoader(_DS(), 4, local_rows=(2, 6))
    assert local_batch_rows(4) == (0, 4)


@pytest.mark.parametrize("task", ["overlap-seq", "global", "retrieval"])
def test_sharded_eval_cli_equals_one_process(ranks, task):
    """``--multihost --shard_eval`` on 2 processes: each prints the metrics
    of the 1-process CLI (forward calls split 2 + 1 where they hold 3)."""
    from temporalalignnet_torch.eval.cli import main

    single = main(_eval_args(ranks.root, task))
    outs = [o["out"] for o in ranks.result(f"eval_{task}")]
    assert outs[0] == outs[1] == single


def test_dp_train_cli_matches_one_process(ranks, capsys):
    """The train CLI on 2 processes (global batch 4, 2 rows each, the evals
    at the runtime save and the epoch ends sharded) against one process:
    the losses, the evals, the final weights; process 0 alone wrote the
    checkpoints and the metrics log."""
    from temporalalignnet_torch.train.cli import main

    single = main(_train_args(ranks.root, "one"))
    capsys.readouterr()
    outs = [o["out"] for o in ranks.result("train_cli")]
    assert outs[0] == outs[1]
    out = outs[0]
    assert out["final_step"] == single["final_step"] == 3
    assert abs(out["loss"] - single["loss"]) <= LOSS_TOL
    for k in ("Recall", "AUC", "R1", "MR"):
        assert out[k] == pytest.approx(single[k], abs=1e-6), k
    a = torch.load(single["checkpoint"], weights_only=True)["state_dict"]
    b = torch.load(out["checkpoint"], weights_only=True)["state_dict"]
    for k in a:
        np.testing.assert_allclose(b[k].numpy(), a[k].numpy(), atol=2e-4, rtol=1e-3, err_msg=k)
    exp = ranks.root / "dp2"
    log = [json.loads(l) for l in next(exp.glob("*/train.metrics.jsonl")).read_text().splitlines()]
    assert [l["step"] for l in log if "train/loss" in l] == [1, 2, 3]  # one writer
    assert len(list(exp.glob("*/runtime/*.pth.tar"))) == 1
    assert len(list(exp.glob("*/epoch/*.pth.tar"))) == 3


def test_dp_e2e_cli_matches_one_process(ranks):
    """The e2e CLI on 2 processes (one video of the 2 each) against one
    process: the last step's loss and the export process 0 wrote."""
    from temporalalignnet_torch.train.end2end_cli import main

    single = main(_e2e_cli_args(ranks.root, "e2e_one"))
    outs = [o["out"] for o in ranks.result("e2e_cli")]
    assert outs[0] == outs[1]
    assert abs(outs[0]["loss"] - single["loss"]) <= LOSS_TOL
    a = torch.load(next((ranks.root / "e2e_one").glob("*/params_latest.pth")),
                   weights_only=True)
    b = torch.load(next((ranks.root / "e2e_dp2").glob("*/params_latest.pth")),
                   weights_only=True)
    for k in a:
        np.testing.assert_allclose(b[k].numpy(), a[k].numpy(), atol=2e-4, rtol=1e-3, err_msg=k)


@pytest.mark.parametrize("train_bn_stats", [False, True], ids=["frozen_bn", "train_bn_stats"])
def test_dp_e2e_step_matches_one_process(ranks, train_bn_stats):
    """One e2e step on 2 ranks (2 videos x 2 clips each; with
    ``train_bn_stats`` the BN statistics of all 8 clips) against the
    1-process step on the global batch: loss and top-1, every averaged
    gradient, the BN statistics and the params after."""
    model, batch = _e2e_case(train_bn_stats)
    opt = make_e2e_optimizer(model, TrainConfig(**E2E_TRAIN))
    grads, apply = {}, opt.step

    def spy():  # the gradients the update sees, as the worker records them
        grads.update({n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None})
        return apply()

    opt.step = spy
    metrics = make_e2e_train_step(model, opt)({k: torch.from_numpy(v) for k, v in batch.items()})
    state = model.state_dict()
    for r, out in enumerate(ranks.result(f"e2e_{int(train_bn_stats)}")):
        assert abs(out["metrics"]["loss"] - metrics["loss"].item()) <= 1e-6
        for k in ("top1/v2t", "top1/t2v"):
            assert out["metrics"][k] == metrics[k].item(), (r, k)
        np.testing.assert_allclose(out["metrics"]["grad_norm"], metrics["grad_norm"].item(),
                                   rtol=1e-6)
        assert set(out["grads"]) == set(grads)
        scale = torch.sqrt(sum(g.double().square().sum() for g in grads.values())).item()
        for n, g in grads.items():
            diff = torch.linalg.vector_norm((out["grads"][n] - g).double()).item()
            assert diff <= E2E_GRAD_TOL * (torch.linalg.vector_norm(g.double()).item() + scale), \
                (r, n, diff)
        for k, v in state.items():
            # Adam moves a weight of near-0 gradient by up to lr whatever its last bits
            atol = 1e-12 if "running" in k else 2 * E2E_TRAIN["lr"]
            np.testing.assert_allclose(out["state"][k].numpy(), v.numpy(), atol=atol,
                                       rtol=1e-7, err_msg=f"rank {r} {k}")
    init = _e2e_case(train_bn_stats)[0].state_dict()
    moved = [k for k in state if "running" in k and not torch.equal(state[k], init[k])]
    assert bool(moved) == train_bn_stats


@pytest.mark.parametrize("train_bn_stats", [False, True], ids=["frozen_bn", "train_bn_stats"])
def test_dp_e2e_gradients_match_jax_dp_mesh(ranks, train_bn_stats):
    """The 2 ranks' averaged e2e gradients against jax.grad of JAX's e2e
    loss on the same global batch sharded over a dp2 mesh (BN statistics
    global under GSPMD), f64, per leaf with tests/test_torch_end2end.py's
    bar."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from test_torch_end2end import GRAD_ATOL, GRAD_RTOL, _jax_grad_fn, _to_jax, _to_port
    from temporalalignnet_tpu.parallel.mesh import make_mesh
    from temporalalignnet_tpu.train import end2end as jax_e2e

    model, batch = _e2e_case(train_bn_stats)
    mesh = make_mesh(2, 1)
    with jax.enable_x64(True):
        jm = jax_e2e.S3DWithText(**E2E, dtype=jnp.float64, train_bn_stats=train_bn_stats)
        params, stats = jax.device_put(_to_jax(model.state_dict()), NamedSharding(mesh, P()))
        jbatch = jax.device_put({k: jnp.asarray(v) for k, v in batch.items()},
                               NamedSharding(mesh, P("data")))
        grads = _jax_grad_fn(jm)(params, stats, jbatch)
        ref = _to_port(jax.device_get({"params": grads, "batch_stats": stats}))
    for r, out in enumerate(ranks.result(f"e2e_{int(train_bn_stats)}")):
        for name, g in out["grads"].items():
            want = ref[name].double()
            diff = torch.linalg.vector_norm(g.double() - want).item()
            assert diff <= GRAD_RTOL * torch.linalg.vector_norm(want).item() + GRAD_ATOL, \
                (r, name, diff)
