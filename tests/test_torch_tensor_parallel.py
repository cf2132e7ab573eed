"""The port's tensor parallelism against the JAX package, f32 on the CPU:
Stage-1 and cotrain steps on tp = 2 (two gloo processes) and on dp 2 x tp 2
(four) against JAX's single-device step (``tests/test_train.py::tiny_setup``'s
settings; JAX's own bar in ``test_dp_tp_mesh_runs``: loss rtol 1e-4, the
whole param tree atol 1e-4) and against the port's one-process step (loss,
metrics and per-tensor gradients within 1e-5); the set of sharded params
against the JAX paths ``param_sharding_rules`` shards; the shard / gather
round trips; a planted fault (the row-parallel bias added on every rank);
the train CLI with ``--tp 2`` against one process, its checkpoint read at
tp = 1 and a tp = 1 checkpoint resumed at tp = 2.  The processes
(``tests/torch_mp_worker.py``) start once for the module."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_fixtures import CLI_SHAPE, TINY, VOCAB, WORDS, Ranks
from test_torch_multiprocess import _write_data
from temporalalignnet_torch.checkpoint import state_dict_from_jax
from temporalalignnet_torch.core.config import LossConfig, ModelConfig, TrainConfig
from temporalalignnet_torch.models.net import TANWithText
from temporalalignnet_torch.parallel import mesh as tmesh
from temporalalignnet_torch.parallel import tensor as tp_ops
from temporalalignnet_torch.train import EMATwin, Optimizer, make_train_step
from temporalalignnet_tpu.core import config as jcfg
from temporalalignnet_tpu.data.synthetic import synthetic_batch
from temporalalignnet_tpu.models.net import TANWithText as JaxTANWithText
from temporalalignnet_tpu.parallel.mesh import _path_str, param_sharding_rules
from temporalalignnet_tpu.train.train_step import create_train_state
from temporalalignnet_tpu.train.train_step import make_train_step as jax_make_train_step

torch.set_num_threads(2)

JAX_LOSS_RTOL = 1e-4  # tests/test_train.py::test_dp_tp_mesh_runs
# the whole param tree against JAX: the port's step-test bar (tests/test_torch_train.py,
# tests/test_torch_parallel.py).  JAX's own 1e-4 (test_dp_tp_mesh_runs, JAX against
# JAX) is missed by the port's one-process step too (1.1e-4 on one element of
# stage1_fused): Adam moves a weight whose gradient is rounding noise by up to
# about lr, whichever way the noise's last bits point
JAX_PARAM_ATOL, JAX_PARAM_RTOL = 2e-4, 1e-3
ONE_TOL = 1e-5  # against the port's one-process step: loss, metrics, norm-relative gradients
# params against the one-process step: the same bar, for the same reason (tp sums
# each gradient in another order)
ONE_PARAM_ATOL, ONE_PARAM_RTOL = JAX_PARAM_ATOL, JAX_PARAM_RTOL
STEPS = 2
COTRAIN = dict(model="cotrain", learn_agreement=True, use_alignability_head=True)
CASES = {  # (loss flags, fused MIL-NCE, train flags beyond tiny_setup's)
    "stage1": ({}, False, {}),
    "stage1_fused": ({}, True, {}),
    "cotrain": (COTRAIN, False, {}),
    "clip_global": ({}, False, dict(clip_grad_norm=0.05, clip_mode="global")),
    "clip_per_param": ({}, False, dict(clip_grad_norm=0.05, clip_mode="per_param")),
}
LAYOUTS = {"tp2": (1, 2), "dp2_tp2": (2, 2)}  # (dp, tp)
RUNS = [(c, "tp2") for c in CASES] + [(c, "dp2_tp2") for c in ("stage1", "stage1_fused",
                                                                 "cotrain")]


@functools.lru_cache(maxsize=None)
def _case(case):
    """tiny_setup's batch (B = 4, T = 32, N = 4, seed 0) and settings, the
    JAX model and its train state (seed 0), whose params both ports start
    from."""
    loss_kw, fused, train_kw = CASES[case]
    loss_kw = dict(loss_kw, use_fused_milnce=fused)
    model_kw = dict(TINY, fused_milnce=fused, random_pos_start=False,
                    use_alignability_head=loss_kw.get("use_alignability_head", False))
    train_kw = dict(lr=1e-3, warmup_iterations=2, total_iterations=100, ema_momentum=0.9,
                    **train_kw)
    batch = synthetic_batch(np.random.RandomState(0), batch_size=4, seq_len=32,
                            max_sentences=4, feature_dim=TINY["video_embed_dim"],
                            vocab_size=VOCAB, max_words=WORDS)
    jm = JaxTANWithText(jcfg.ModelConfig(**model_kw), vocab_size=VOCAB + 1)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.device_get(create_train_state(
        jm, jcfg.TrainConfig(**train_kw), jcfg.LossConfig(**loss_kw), jbatch, seed=0)[0].params)
    # the row-parallel biases start at 0: random ones, so that a bias counted
    # once per rank shows from the first forward
    rng = np.random.RandomState(1)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: (rng.randn(*x.shape).astype(np.float32) * 0.1
                         if _path_str(path).endswith(("out_proj/bias", "c_proj/bias")) else x),
        params)
    return loss_kw, model_kw, train_kw, batch, jm, params


def _jax_state(jm, loss_kw, train_kw, batch, params):
    """A fresh JAX train state (its step donates it) from ``params`` (the
    EMA twin's too) and its optimizer."""
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    state, tx = create_train_state(jm, jcfg.TrainConfig(**train_kw),
                                   jcfg.LossConfig(**loss_kw), jbatch, seed=0)
    fields = dict(params=jax.tree_util.tree_map(jnp.asarray, params))
    if getattr(state, "ema_params", None) is not None:
        fields["ema_params"] = jax.tree_util.tree_map(jnp.asarray, params)
    return state.replace(**fields), tx


def _train_args(root, prefix, steps=2):
    """The tiny TAN's train CLI; the downstream evals (HTM-Align, YC2) at the
    runtime save and at the stop."""
    return ["--feature_dir", str(root / "features"), "--captions", str(root / "captions.json"),
            "--vocab", str(root / "vocab.npy"), "--device", "cpu", "--batch_size", "4",
            "--seq_len", "32", "--max_sentences", "4", "--log_every", "1", "--num_workers", "2",
            "--epochs", "6", "--warmup_iterations", "1", "--runtime_save_iter", "2",
            "--max_steps", str(steps), "--use_alignability_head", "1",
            "--align_anno", str(root / "align.json"), "--yc2_anno", str(root / "yc2.json"),
            "--prefix", str(root / prefix), *CLI_SHAPE]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The feature directory and a 2-step one-process CLI run (its runtime
    checkpoint is resumed at tp = 2 by the workers)."""
    from temporalalignnet_torch.train.cli import main as train_main

    root = _write_data(tmp_path_factory.mktemp("tp_data"))
    out = train_main(_train_args(root, "one"))
    return root, out


def _jobs(world, data):
    jobs = []
    for case, layout in RUNS:
        dp, tp = LAYOUTS[layout]
        if dp * tp != world:
            continue
        loss_kw, model_kw, train_kw, batch, _, params = _case(case)
        job = dict(kind="tp_step", model_kw=model_kw, loss_kw=loss_kw, train_kw=train_kw,
                   batch=batch, steps=STEPS, vocab_size=VOCAB + 1, dp=dp, tp=tp,
                   state_dict=state_dict_from_jax(params))
        jobs.append(dict(job, name=f"{case}_{layout}"))
        if (case, layout) == ("stage1", "tp2"):
            jobs.append(dict(job, name="planted", steps=1, planted=True))
            one = TANWithText(ModelConfig(**model_kw), vocab_size=VOCAB + 1)
            one.load_state_dict(job["state_dict"])
            opt = Optimizer(one, TrainConfig(**train_kw))
            make_train_step(one, opt, TrainConfig(**train_kw), LossConfig(**loss_kw))(
                {k: torch.from_numpy(v) for k, v in batch.items()})
            jobs.append(dict(kind="tp_shards", name=f"shards_{layout}", dp=dp, tp=tp,
                             model_kw=model_kw, train_kw=train_kw, vocab_size=VOCAB + 1,
                             batch=batch, state_dict=job["state_dict"],
                             optimizer=opt.state_dict()))
    if world == 4:
        dp, tp = LAYOUTS["dp2_tp2"]
        loss_kw, model_kw, train_kw, batch, _, params = _case("stage1")
        jobs.append(dict(kind="tp_shards", name="shards_dp2_tp2", dp=dp, tp=tp,
                         model_kw=model_kw, train_kw=train_kw, vocab_size=VOCAB + 1,
                         batch=batch, state_dict=state_dict_from_jax(params),
                         optimizer=None))
    if world == 2:
        root, one = data
        resume = ["--resume", os.path.dirname(one["checkpoint"]), "--max_steps", "4"]
        jobs += [dict(kind="cli", name="cli_tp2", module="temporalalignnet_torch.train.cli",
                      argv=_train_args(root, "tp2") + ["--tp", "2"]),
                 dict(kind="cli", name="cli_tp2_resumed", module="temporalalignnet_torch.train.cli",
                      argv=_train_args(root, "tp2_resumed") + resume + ["--tp", "2"])]
    return jobs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, data):
    """tp = 2 on two processes and dp 2 x tp 2 on four, started at once."""
    runs = {w: Ranks(tmp_path_factory.mktemp(f"tp_world{w}"), _jobs(w, data), world=w)
            for w in (2, 4)}
    yield runs
    for r in runs.values():
        r.stop()


def _rel(a, b):
    a, b = a.double(), b.double()
    nb = torch.linalg.vector_norm(b).item()
    return torch.linalg.vector_norm(a - b).item() / (nb or 1.0)


def _one_process(case):
    """The port's 1-process steps on the global batch: metrics per step, the
    gradients of the last, the model and the twin."""
    loss_kw, model_kw, train_kw, batch, _, params = _case(case)
    tm = TANWithText(ModelConfig(**model_kw), vocab_size=VOCAB + 1)
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    tcfg = TrainConfig(**train_kw)
    twin = EMATwin(tm, tcfg) if loss_kw.get("model") == "cotrain" else None
    step = make_train_step(tm, Optimizer(tm, tcfg), tcfg, LossConfig(**loss_kw), twin=twin)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    metrics = [{k: v.item() for k, v in step(tbatch).items()} for _ in range(STEPS)]
    grads = {n: p.grad for n, p in tm.named_parameters() if p.grad is not None}
    return metrics, grads, tm, twin


@pytest.mark.parametrize("case,layout", RUNS, ids=[f"{c}-{l}" for c, l in RUNS])
def test_tp_steps_match_jax_and_one_process(ranks, case, layout):
    """Each rank's losses and metrics, gathered gradients, params and twin
    after two steps against JAX's single-device steps and the port's
    one-process steps; the replicated params bit-equal on every rank, the
    gathered ones too."""
    loss_kw, model_kw, train_kw, batch, jm, params = _case(case)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    state, tx = _jax_state(jm, loss_kw, train_kw, batch, params)
    jstep = jax_make_train_step(jm, tx, jcfg.TrainConfig(**train_kw), jcfg.LossConfig(**loss_kw))
    ref_m = []
    for _ in range(STEPS):
        state, m = jstep(state, jbatch)
        ref_m.append({k: float(v) for k, v in m.items()})
    jax_params = state_dict_from_jax(jax.device_get(state.params))
    one_m, one_grads, tm, twin = _one_process(case)
    halves = [("online", "params", jax_params, tm.state_dict())]
    if twin is not None:
        halves.append(("target", "target", state_dict_from_jax(jax.device_get(
            state.ema_params)), twin.model.state_dict()))

    dp, tp = LAYOUTS[layout]
    outs = ranks[dp * tp].result(f"{case}_{layout}")
    for r, out in enumerate(outs):
        for i in range(STEPS):
            assert set(out["metrics"][i]) == set(one_m[i])
            np.testing.assert_allclose(out["metrics"][i]["loss"], ref_m[i]["loss"],
                                       rtol=JAX_LOSS_RTOL, err_msg=f"rank {r} step {i}")
            for k in one_m[i]:
                np.testing.assert_allclose(out["metrics"][i][k], one_m[i][k], atol=ONE_TOL,
                                           rtol=ONE_TOL, err_msg=f"rank {r} step {i} {k}")
        assert set(out["grads"]) == set(one_grads)
        worst = max((_rel(out["grads"][n], g), n) for n, g in one_grads.items())
        assert worst[0] <= ONE_TOL, (r, worst)
        for name, key, ref, single in halves:
            assert set(out[key]) == set(ref)
            for k in ref:  # the whole tree, full shapes
                np.testing.assert_allclose(out[key][k].numpy(), ref[k].numpy(),
                                           atol=JAX_PARAM_ATOL, rtol=JAX_PARAM_RTOL,
                                           err_msg=f"rank {r} {name} {k}")
                np.testing.assert_allclose(out[key][k].numpy(), single[k].numpy(),
                                           atol=ONE_PARAM_ATOL, rtol=ONE_PARAM_RTOL,
                                           err_msg=f"rank {r} {name} {k}")
        for k, v in out["replicated"].items():  # equal on every rank, to the bit
            assert torch.equal(v, outs[0]["replicated"][k]), (r, k)
        for k, v in out["params"].items():
            assert torch.equal(v, outs[0]["params"][k]), (r, k)
        assert out["optimizer"]["updates"] == STEPS


def _jax_sharded_keys(params):
    """The port keys of the JAX leaves that param_sharding_rules shards."""
    names = {"q_proj": "in_proj_weight", "k_proj": "in_proj_weight", "v_proj": "in_proj_weight"}
    keys = set()
    for path, _ in jax.tree_util.tree_leaves_with_path(params):
        p = _path_str(path)
        if param_sharding_rules(p) == jax.sharding.PartitionSpec():
            continue
        parts = p.split("/")[1:]  # drop "aligner"
        enc, block, mod, proj, leaf = parts
        block = block.split("_")[1]
        if proj in names:
            name = f"attn.{names[proj]}" if leaf == "kernel" else "attn.in_proj_bias"
        else:
            name = f"{mod}.{proj}.{'weight' if leaf == 'kernel' else 'bias'}"
        keys.add(f"{enc}.resblocks.{block}.{name}")
    return keys


def test_sharded_params_are_those_jax_shards(ranks):
    """The keys ``tp_dim`` shards, the params a sharded model marks, and the
    JAX paths ``param_sharding_rules`` shards (q, k, v by heads, out_proj
    and c_proj rows, c_fc columns) are one set; a BERT TAN shards nothing
    of its BERT tower; each rank holds its shard's shapes."""
    _, model_kw, _, _, _, params = _case("stage1")
    ours = {k for k in TANWithText(ModelConfig(**model_kw), vocab_size=VOCAB + 1).state_dict()
            if tp_ops.tp_dim(k) is not None}
    assert ours == _jax_sharded_keys(params)
    assert not {k for k in ours if k.endswith(("out_proj.bias", "c_proj.bias"))}
    for out in ranks[2].result("stage1_tp2"):
        assert set(out["sharded"]) == ours
        D = TINY["width"]
        assert out["shapes"]["video_temporal_encoder.resblocks.0.attn.in_proj_weight"] == \
            (3 * D // 2, D)
        assert out["shapes"]["joint_temporal_encoder.resblocks.1.mlp.c_proj.weight"] == \
            (D, 2 * D)
    from temporalalignnet_torch.models.bert import BertConfig

    bert = TANWithText(ModelConfig(**dict(TINY, language_model="bert")),
                       bert_config=BertConfig(vocab_size=30, hidden_size=32, num_hidden_layers=1,
                                              num_attention_heads=2, intermediate_size=64))
    sharded = {k for k in bert.state_dict() if tp_ops.tp_dim(k) is not None}
    assert sharded == ours and not any(k.startswith("bert.") for k in sharded)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_shard_and_gather_round_trip_to_the_bit(ranks, layout):
    """A full state_dict and a full optimizer state (AdamW's moments after
    a step) through each rank's shard and back, bit-equal; each rank builds
    the rows of its dp index."""
    dp, tp = LAYOUTS[layout]
    _, model_kw, _, _, _, params = _case("stage1")
    full = state_dict_from_jax(params)
    outs = ranks[dp * tp].result(f"shards_{layout}")
    for r, out in enumerate(outs):
        assert (out["dp_rank"], out["tp_rank"]) == (r // tp, r % tp)
        assert out["rows"] == 4 // dp
        assert set(out["state_dict"]) == set(full)
        for k, v in full.items():
            assert torch.equal(out["state_dict"][k], v), k
    if layout == "tp2":
        jobs = {j["name"]: j for j in torch.load(os.path.join(ranks[2].job_dir, "jobs.pt"),
                                                 weights_only=False)}
        want = jobs["shards_tp2"]["optimizer"]
        for out in outs:
            got = out["optimizer"]
            assert got["updates"] == want["updates"] == 1
            for i, s in want["adamw"]["state"].items():
                for k, v in s.items():
                    assert torch.equal(got["adamw"]["state"][i][k], v), (i, k)


def test_planted_row_parallel_bias_fault_is_caught(ranks):
    """The row-parallel biases added on both ranks, before the reduce: the
    loss and the gradients leave the one-process step's bar."""
    one_m, one_grads, _, _ = _one_process("stage1")
    for out in ranks[2].result("planted"):
        loss_err = abs(out["metrics"][0]["loss"] - one_m[0]["loss"])
        worst = max((_rel(out["grads"][n], g), n) for n, g in one_grads.items())
        assert loss_err > 100 * ONE_TOL or worst[0] > 100 * ONE_TOL, (loss_err, worst)


def test_tp_train_cli_matches_one_process_and_its_checkpoint_runs_at_tp1(ranks, data, tmp_path,
                                                                          capsys):
    """``--tp 2`` over two processes: the one-process run's losses and eval
    metrics (the evals run on the sharded model); its checkpoints hold the tp = 1 key space and shapes (gathered), load
    strict into a one-process model, and resume at tp = 1; a tp = 1
    checkpoint resumes at tp = 2 (the workers' second run), equal to the
    one-process run resumed alike."""
    from temporalalignnet_torch.checkpoint import load_reference_checkpoint
    from temporalalignnet_torch.train.cli import main as train_main

    root, one = data
    outs = ranks[2].result("cli_tp2")
    text = capsys.readouterr().out
    tp_out = outs[0]["out"]
    assert tp_out["final_step"] == one["final_step"] == 2
    np.testing.assert_allclose(tp_out["loss"], one["loss"], rtol=ONE_TOL, atol=ONE_TOL)
    metrics = [k for k in one if k not in ("final_step", "loss", "loss_finite", "checkpoint")]
    assert {"Recall", "AUC", "R1"} <= set(metrics)  # the evals at the stop, on the sharded model
    for k in metrics:
        np.testing.assert_allclose(tp_out[k], one[k], atol=1e-4, err_msg=k)
    a = torch.load(one["checkpoint"], weights_only=True)
    b = torch.load(tp_out["checkpoint"], weights_only=True)
    assert set(a["state_dict"]) == set(b["state_dict"])
    for k, v in a["state_dict"].items():
        assert b["state_dict"][k].shape == v.shape, k
        torch.testing.assert_close(b["state_dict"][k], v, rtol=0, atol=JAX_PARAM_ATOL)
    cli_shape = {k: v for k, v in TINY.items() if k != "num_pos_embeds"}  # the CLI's 1024
    model = TANWithText(ModelConfig(**cli_shape, use_alignability_head=True),
                        vocab_size=VOCAB + 1)
    load_reference_checkpoint(tp_out["checkpoint"], model, verbose=False)  # strict
    resumed = train_main(_train_args(root, "tp2", steps=4) + ["--resume", "auto"])
    assert resumed["final_step"] == 4 and np.isfinite(resumed["loss"])
    # the tp = 1 checkpoint resumed at tp = 2 and at tp = 1
    tp_resumed = ranks[2].result("cli_tp2_resumed")[0]["out"]
    one_resumed = train_main(_train_args(root, "one_resumed", steps=4)
                             + ["--resume", os.path.dirname(one["checkpoint"])])
    assert tp_resumed["final_step"] == one_resumed["final_step"] == 4
    np.testing.assert_allclose(tp_resumed["loss"], one_resumed["loss"], rtol=ONE_TOL,
                               atol=ONE_TOL)
    assert "tp index" not in text  # the workers' lines are theirs


@pytest.mark.parametrize("width,heads,tp,match", [
    (64, 4, 3, "divide the heads"), (64, 6, 3, "divide the width"), (66, 6, 4, "divide the heads"),
])
def test_tp_refuses_uneven_shards(width, heads, tp, match):
    """GSPMD would pad an uneven shard; the port refuses it, naming the numbers."""
    with pytest.raises(ValueError, match=match):
        tp_ops.check_tp(width, heads, tp)


def test_mesh_refuses_tp_without_enough_processes():
    with pytest.raises(ValueError, match="torchrun"):
        tmesh.make_mesh(-1, 2)
    with pytest.raises(ValueError, match="at least 1"):
        tmesh.make_mesh(-1, 0)
    assert tmesh.make_mesh(-1, 1) == tmesh.Mesh(1, None, 1, None)
