"""The port's data parallelism against the JAX package's dp mesh, f32 on the
CPU: the sharded fused MIL-NCE (``_sharded_milnce``, in interpret mode) and
whole Stage-1 and cotrain steps, fused and dense, of 2 gloo processes
(``tests/torch_mp_worker.py``, started once for the module) against JAX on
``make_mesh(2, 1)`` and against the port's 1-process step on the same
global batch; and the process-group helpers on their own."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_fixtures import TINY, VOCAB, WORDS, Ranks
from temporalalignnet_torch.checkpoint import state_dict_from_jax
from temporalalignnet_torch.core.config import LossConfig, ModelConfig, TrainConfig
from temporalalignnet_torch.models.net import TANWithText
from temporalalignnet_torch.parallel import distributed, mesh as tmesh
from temporalalignnet_torch.train import EMATwin, Optimizer, make_train_step
from temporalalignnet_tpu.core import config as jcfg
from temporalalignnet_tpu.data.synthetic import synthetic_batch
from temporalalignnet_tpu.models.net import TANWithText as JaxTANWithText
from temporalalignnet_tpu.ops.pallas_milnce import fused_milnce_elements as jax_milnce
from temporalalignnet_tpu.parallel.mesh import make_mesh
from temporalalignnet_tpu.train.train_step import create_train_state, shard_batch
from temporalalignnet_tpu.train.train_step import make_train_step as jax_make_train_step

torch.set_num_threads(2)

MILNCE_TOL = 2e-5  # per element, f32 (tests/test_fused_milnce.py)
LOSS_TOL = 2e-4  # whole steps (tests/test_torch_train.py)
PARAM_ATOL, PARAM_RTOL = 2e-4, 1e-3
GRAD_TOL = 1e-4  # norm-relative, against the 1-process step (chip_smoke's f32 GRAD_TOL)
MV, INV_TEMP = -6.0e4, 1.0 / 0.07
COTRAIN = dict(model="cotrain", learn_agreement=True, use_alignability_head=True)
STEP_CASES = {  # (loss flags, fused)
    "stage1_fused": (dict(use_alignability_head=True, loss_threshold=0.5), True),
    "stage1_dense": (dict(use_alignability_head=True, loss_threshold=0.5), False),
    "cotrain_fused": (COTRAIN, True),
    "cotrain_dense": (COTRAIN, False),
}
STEPS = 2


def _milnce_problem(shared):
    rng = np.random.RandomState(3 + shared)
    S, B, T, N, C = 2, 4, 8, 4, 32
    unit = lambda *s: (lambda a: a / np.linalg.norm(a, axis=-1, keepdims=True))(
        rng.randn(*s).astype(np.float32))
    pm = np.zeros((B, T, B, N), bool)
    for b in range(B):
        pm[b, :, b] = rng.rand(T, N) < 0.4
    cv = rng.rand(B * N) < 0.85
    pm = pm.reshape(B * T, B * N) & cv[None]
    pm[5] = False  # a row without a positive
    return dict(video=unit(S, B * T, C), text=unit(B * N, C) if shared else unit(S, B * N, C),
                pos_mask=pm, col_valid=cv, g_v=rng.randn(S, B * T).astype(np.float32),
                g_t=rng.randn(S, B * N).astype(np.float32))


def _step_case(case):
    loss_kw, fused = STEP_CASES[case]
    loss_kw = dict(loss_kw, use_fused_milnce=fused)
    model_kw = dict(TINY, fused_milnce=fused, random_pos_start=False,
                    use_alignability_head=loss_kw.get("use_alignability_head", False))
    train_kw = dict(lr=1e-3, warmup_iterations=2, total_iterations=100, ema_momentum=0.9)
    batch = synthetic_batch(np.random.RandomState(0), batch_size=4, seq_len=32,
                            max_sentences=4, feature_dim=TINY["video_embed_dim"],
                            vocab_size=VOCAB, max_words=WORDS)
    jm = JaxTANWithText(jcfg.ModelConfig(**model_kw), vocab_size=VOCAB + 1)
    return loss_kw, model_kw, train_kw, batch, jm


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every job of this module on 2 processes, started before any JAX work."""
    jobs = []
    for shared in (False, True):
        p = _milnce_problem(shared)
        jobs.append(dict(name=f"milnce_{'dual' if shared else 'joint'}", kind="milnce",
                         mask_value=MV, inv_temp=INV_TEMP,
                         **{k: torch.from_numpy(v) for k, v in p.items()}))
    for case in STEP_CASES:
        loss_kw, model_kw, train_kw, batch, jm = _step_case(case)
        params = jm.init({"params": jax.random.PRNGKey(0), "pos": jax.random.PRNGKey(0)},
                         jnp.asarray(batch["video"][:1]), jnp.asarray(batch["input_ids"][:1]),
                         deterministic=True)["params"]
        jobs.append(dict(name=case, kind="step", model_kw=model_kw, loss_kw=loss_kw,
                         train_kw=train_kw, batch=batch, steps=STEPS, vocab_size=VOCAB + 1,
                         state_dict=state_dict_from_jax(jax.device_get(params))))
    r = Ranks(tmp_path_factory.mktemp("parallel"), jobs)
    yield r
    r.stop()


def _rel(a, b):
    a, b = a.double(), b.double()
    nb = torch.linalg.vector_norm(b).item()
    return torch.linalg.vector_norm(a - b).item() / (nb or 1.0)


@pytest.mark.parametrize("shared", [False, True], ids=["joint", "dual"])
def test_sharded_milnce_matches_jax_dp_mesh(ranks, shared):
    """Per element: each rank's v_el rows, the replicated t_el, dv of its rows
    and dt of its columns against JAX's fused_milnce_elements(mesh=dp2)."""
    p = _milnce_problem(shared)
    mesh = make_mesh(2, 1)
    args = [jnp.asarray(p[k]) for k in ("video", "text", "pos_mask", "col_valid")]

    def objective(v, t):
        v_el, t_el = jax_milnce(v, t, args[2], args[3], MV, INV_TEMP, mesh=mesh)
        return (v_el * p["g_v"]).sum() + (t_el * p["g_t"]).sum(), (v_el, t_el)

    (_, (v_el, t_el)), (dv, dt) = jax.value_and_grad(objective, (0, 1), has_aux=True)(
        args[0], args[1])
    R, K = p["video"].shape[1] // 2, p["text"].shape[-2] // 2
    for r, out in enumerate(ranks.result(f"milnce_{'dual' if shared else 'joint'}")):
        rows, cols = slice(r * R, (r + 1) * R), slice(r * K, (r + 1) * K)
        for name, ours, ref in (("v_el", out["v_el"], np.asarray(v_el)[:, rows]),
                                ("t_el", out["t_el"], np.asarray(t_el)),
                                ("dv", out["dv"], np.asarray(dv)[:, rows]),
                                ("dt", out["dt"], np.asarray(dt)[..., cols, :])):
            assert tuple(ours.shape) == ref.shape, name
            np.testing.assert_allclose(ours.numpy(), ref, atol=MILNCE_TOL, rtol=1e-5,
                                       err_msg=f"rank {r} {name}")


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_dp_steps_match_jax_and_one_process(ranks, case):
    """Two steps on 2 ranks (2 of the 4 videos each): the losses and metrics
    against JAX's step on the dp2 mesh and the port's 1-process step; the
    averaged gradients against the 1-process ones; the params (and the
    twin's) against both, and equal on the two ranks.  The params keep the
    step tests' bar against both: Adam moves a weight whose gradient is
    near 0 by up to lr whatever the gradient's last bits, and those differ
    with the order of the sums (JAX's own dp2 mesh and 1-device steps
    differ by up to 1e-4 here)."""
    loss_kw, model_kw, train_kw, batch, jm = _step_case(case)
    mesh = make_mesh(2, 1)
    jbatch = shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh)
    jtrain, jloss = jcfg.TrainConfig(**train_kw), jcfg.LossConfig(**loss_kw)
    state, tx = create_train_state(jm, jtrain, jloss, jbatch, seed=0, mesh=mesh)
    jstep = jax_make_train_step(jm, tx, jtrain, jloss, mesh=mesh)

    tm = TANWithText(ModelConfig(**model_kw), vocab_size=VOCAB + 1)
    tm.load_state_dict(state_dict_from_jax(jax.device_get(state.params)), strict=True)
    tcfg = TrainConfig(**train_kw)
    twin = EMATwin(tm, tcfg) if loss_kw.get("model") == "cotrain" else None
    one = make_train_step(tm, Optimizer(tm, tcfg), tcfg, LossConfig(**loss_kw), twin=twin)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    ref_m, one_m = [], []
    for _ in range(STEPS):
        state, m = jstep(state, jbatch)
        ref_m.append({k: float(v) for k, v in m.items()})
        one_m.append({k: v.item() for k, v in one(tbatch).items()})
    one_grads = {n: p.grad for n, p in tm.named_parameters() if p.grad is not None}
    jax_params = state_dict_from_jax(jax.device_get(state.params))
    jax_target = (state_dict_from_jax(jax.device_get(state.ema_params)) if twin is not None
                  else None)

    outs = ranks.result(case)
    for r, out in enumerate(outs):
        for i in range(STEPS):
            assert set(out["metrics"][i]) == set(ref_m[i])
            assert abs(out["metrics"][i]["loss"] - ref_m[i]["loss"]) <= LOSS_TOL
            for k in ref_m[i]:
                np.testing.assert_allclose(out["metrics"][i][k], ref_m[i][k], atol=5e-4,
                                           rtol=1e-3, err_msg=f"rank {r} step {i} {k}")
                np.testing.assert_allclose(out["metrics"][i][k], one_m[i][k], atol=1e-5,
                                           rtol=1e-5, err_msg=f"rank {r} step {i} {k}")
        assert set(out["grads"]) == set(one_grads)
        worst = max((_rel(out["grads"][n], g), n) for n, g in one_grads.items())
        assert worst[0] <= GRAD_TOL, (r, worst)
        halves = [("online", out["params"], jax_params, tm.state_dict())]
        if twin is not None:
            halves.append(("target", out["target"], jax_target, twin.model.state_dict()))
        for name, ours, ref, single in halves:
            for k in ref:
                np.testing.assert_allclose(ours[k].numpy(), ref[k].numpy(), atol=PARAM_ATOL,
                                           rtol=PARAM_RTOL, err_msg=f"rank {r} {name} {k}")
                np.testing.assert_allclose(ours[k].numpy(), single[k].numpy(), atol=PARAM_ATOL,
                                           rtol=PARAM_RTOL, err_msg=f"rank {r} {name} {k}")
    # one all-reduce hands both ranks the same gradients: the same updates
    for k, v in outs[0]["params"].items():
        assert torch.equal(v, outs[1]["params"][k]), k


# ------------------------------------------------------ the helpers alone


def test_mesh_and_rows_without_a_group():
    assert tmesh.make_mesh(-1, 1) == tmesh.Mesh(1, None)
    assert tmesh.make_mesh(1, 1).dp == 1
    with pytest.raises(ValueError, match="torchrun"):
        tmesh.make_mesh(2, 1)
    with pytest.raises(ValueError, match="torchrun"):  # tp 2 needs two processes
        tmesh.make_mesh(-1, 2)
    assert tmesh.local_batch_rows(8) == (0, 8)
    assert tmesh.row_split(5) == (0, 5, 5)
    t = torch.arange(3.0)
    assert tmesh.fetch_global(t, 3) is t
    assert tmesh.sharded_rows(4, lambda lo, hi: (torch.arange(lo, hi),))[0].tolist() == \
        [0, 1, 2, 3]
    assert distributed.all_gather(t) is t and distributed.all_reduce_sum(t) is t
    assert distributed.rank() == 0 and distributed.world_size() == 1 and distributed.is_master()
    distributed.barrier()  # nothing to wait for


@pytest.mark.parametrize("env,args,expect", [
    ({}, {}, False),  # nothing asks for a group: one process
    ({}, dict(process_id=0), "needs --num_processes"),
    ({}, dict(num_processes=2), "coordinator"),
    ({"SLURM_NTASKS": "2", "SLURM_PROCID": "1"}, {}, "coordinator"),
    ({"WORLD_SIZE": "2", "RANK": "3", "MASTER_ADDR": "127.0.0.1"}, {}, r"outside \[0, 2\)"),
    ({}, dict(coordinator_address="127.0.0.1:1", backend="nccl", device="cpu"),
     "backend follows the device"),
], ids=["none", "process_id_alone", "no_coordinator", "slurm", "torchrun", "backend"])
def test_initialize_multihost_reads_its_sources(monkeypatch, env, args, expect):
    """The arguments, then SLURM, then torchrun's variables; refusals before
    any process group is set up."""
    for k in ("SLURM_NTASKS", "SLURM_PROCID", "WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if expect is False:
        assert distributed.initialize_multihost(device="cpu") is False
    else:
        with pytest.raises(ValueError, match=expect):
            distributed.initialize_multihost(**{"device": "cpu", **args})
    assert not torch.distributed.is_initialized()


def test_a_world_of_one_runs_every_collective():
    """gloo in a world of one: the collectives run and return their input,
    and their gradients pass through."""
    from temporalalignnet_torch.parallel.mesh import fetch_global, sharded_rows
    from port_fixtures import free_port

    assert distributed.initialize_multihost(f"127.0.0.1:{free_port()}", 1, 0, device="cpu")
    try:
        g = distributed.default_group()
        x = torch.randn(3, 4, requires_grad=True)
        y = distributed.all_gather(x, 1, g)
        z = distributed.all_reduce_sum(y, g)
        (z * torch.arange(4.0)).sum().backward()
        assert torch.equal(z, x) and torch.equal(x.grad, torch.arange(4.0).expand(3, 4))
        assert torch.equal(distributed.all_reduce_max(x, g), x.detach())
        assert torch.equal(distributed.reduce_scatter(x.detach(), 0, g), x.detach())
        avg = x.detach().clone()
        assert distributed.average_(avg, g) is avg and torch.equal(avg, x.detach())
        assert torch.equal(fetch_global(x.detach(), 3, g), x.detach())
        assert sharded_rows(2, lambda lo, hi: (torch.arange(lo, hi),), g)[0].tolist() == [0, 1]
        assert tmesh.make_mesh(1, 1).dp_group is g and tmesh.local_batch_rows(6) == (0, 6)
    finally:
        distributed.destroy()
