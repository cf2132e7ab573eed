"""The port's serving export (tools/export_eval.py) against JAX's, the custom
op ``temporalalignnet::mha_fwd``, and the port's export_torch and vis tools
against JAX's: on the CPU with the tiny model of tests/test_export.py (f32);
on a card (``cuda``) the exported program's kernel nodes and launches and
``torch.library.opcheck`` of the op.  JAX is imported only inside the tests
that compare with it, so the card's tests collect without it:

    python -m pytest tests/test_torch_serving.py --noconftest -m cuda
"""

import json

import numpy as np
import pytest
import torch

from temporalalignnet_torch.core.config import ModelConfig
from temporalalignnet_torch.models.net import TANWithText
from temporalalignnet_torch.tools import export_eval as ee

torch.set_num_threads(2)

TINY = dict(width=64, heads=4, num_encoder_layers=2, num_joint_layers=2,
            video_embed_dim=48, num_pos_embeds=128)
T, N, W = 32, 4, 8
VOCAB = 51
JAX_TOL = 2e-5  # f32, the order of the sums of two frameworks' matmuls


def _model(dtype=torch.float32, device="cpu", **cfg):
    model = TANWithText(ModelConfig(use_alignability_head=True, random_pos_start=False,
                                    **{**TINY, **cfg}), vocab_size=VOCAB)
    model.init_weights(torch.Generator().manual_seed(0))
    return model.to(device=device, dtype=dtype).eval()


@pytest.fixture(scope="module")
def tiny():
    model = _model()
    return model, ee.eval_params(model)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_fixed_batch_round_trip_is_exact(tiny):
    model, params = tiny
    exported = ee.export_eval_forward(model, params, 4, T, TINY["video_embed_dim"], N, W)
    blob = ee.serialize(exported)
    assert len(blob) > 0 and ee.mha_fwd_nodes(exported) == 0  # the CPU traces the plain path
    # the artifact holds no weights: they are the call's first argument
    assert len(blob) < sum(v.numel() * v.element_size() for v in params.values())
    diffs = ee.roundtrip_check(blob, model, params, 4, T, TINY["video_embed_dim"], N, W)
    assert set(diffs) == {f"max_abs_diff/{k}" for k in
                          ("sim", "dual-sim", "alignability-dual", "alignability-joint")}
    assert all(v == 0.0 for v in diffs.values()), diffs


def test_poly_batch_serves_two_sizes(tiny):
    model, params = tiny
    blob = ee.serialize(ee.export_eval_forward(model, params, 0, T, TINY["video_embed_dim"],
                                               N, W, poly_batch=True))
    for b in (2, 5):
        diffs = ee.roundtrip_check(blob, model, params, b, T, TINY["video_embed_dim"], N, W)
        assert all(v == 0.0 for v in diffs.values()), (b, diffs)


def test_loaded_program_matches_jax_export():
    """The loaded torch.export program against JAX's export_eval_forward ->
    serialize -> deserialize -> call on the same weights and inputs."""
    import jax

    from port_fixtures import model_pair
    from temporalalignnet_tpu.tools.export_eval import export_eval_forward

    jm, jparams, pm = model_pair(use_alignability_head=True, random_pos_start=False)
    C = pm.cfg.video_embed_dim
    blob = jax.export.deserialize(bytearray(export_eval_forward(
        jm, jparams, batch=3, seq_len=T, feature_dim=C, sentences=N, words=W).serialize()))
    program = ee.deserialize(ee.serialize(
        ee.export_eval_forward(pm, ee.eval_params(pm), 3, T, C, N, W))).module()
    video, ids = ee.seeded_inputs(3, T, C, N, W, "cpu")
    want = blob.call(jparams, video.numpy(), ids.numpy().astype(np.int32))
    with torch.no_grad():
        got = program(ee.eval_params(pm), video, ids)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=JAX_TOL, rtol=0,
                                   err_msg=k)


def test_export_cli_writes_the_checked_artifact(tmp_path, capsys):
    out = tmp_path / "tan_eval.pt2"
    res = ee.main(["--out", str(out), "--batch", "3", "--device", "cpu", "--width", "64",
                   "--heads", "4", "--layers", "2", "--vocab_size", str(VOCAB),
                   "--video_embed_dim", "48", "--seq_len", str(T), "--sentences", str(N),
                   "--words", str(W), "--poly_batch", "--verify_batch", "4"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == res and out.stat().st_size == res["bytes"]
    assert {"path", "bytes", "poly_batch", "device"} <= set(res) and res["poly_batch"]
    assert res["device"] == "cpu" and res["dtype"] == "float32"
    assert [k for k in res if k.startswith("max_abs_diff/")] and all(
        res[k] == 0.0 for k in res if k.startswith("max_abs_diff/"))
    program = ee.deserialize(out.read_bytes()).module()
    model = _model(num_pos_embeds=1024)  # the CLI's table
    video, ids = ee.seeded_inputs(6, T, 48, N, W, "cpu")
    with torch.no_grad():
        got, want = program(ee.eval_params(model), video, ids), ee.EvalForward(model)(
            ee.eval_params(model), video, ids)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_export_cli_refuses_platforms(tmp_path):
    with pytest.raises(SystemExit, match="one device"):
        ee.main(["--out", str(tmp_path / "x.pt2"), "--platforms", "tpu,cpu", "--device", "cpu"])
    assert not (tmp_path / "x.pt2").exists()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mha_fwd_fake_gives_the_kernel_shape(dtype):
    from torch._subclasses.fake_tensor import FakeTensorMode

    import temporalalignnet_torch.ops  # noqa: F401

    with FakeTensorMode():
        q, k, v = (torch.empty(3, 8, 72, 64, dtype=dtype, device="cuda") for _ in range(3))
        mask = torch.zeros(3, 72, dtype=torch.bool, device="cuda")
        out = torch.ops.temporalalignnet.mha_fwd(q, k, v, mask)
        assert (out.shape, out.dtype, out.device.type) == (q.shape, dtype, "cuda")
        short = torch.zeros(3, 10, dtype=torch.bool, device="cuda")
        with pytest.raises(ValueError, match="key_padding_mask"):
            torch.ops.temporalalignnet.mha_fwd(q, k, v, short)


def test_mha_fwd_op_has_no_cpu_implementation():
    import temporalalignnet_torch.ops  # noqa: F401

    q = torch.zeros(1, 8, 16, 64)
    with pytest.raises(NotImplementedError):
        torch.ops.temporalalignnet.mha_fwd(q, q, q, None)


def test_export_torch_file_loads_in_jax(tmp_path, capsys):
    """A trainer checkpoint (runtime file with resume state) exported bare:
    the file JAX's load_reference_checkpoint reads, with an equal forward;
    and a twin one keeps its online / target halves."""
    import jax.numpy as jnp

    from port_fixtures import TINY as PT, VOCAB as PV, jax_model, port_model
    from temporalalignnet_torch.checkpoint import Checkpointer, reference_checkpoint
    from temporalalignnet_torch.tools import export_torch
    from temporalalignnet_tpu.checkpoint import load_reference_checkpoint
    from temporalalignnet_tpu.models.net import TANWithText as JaxTAN

    jm, _ = jax_model(use_alignability_head=True, random_pos_start=False)
    model = TANWithText(ModelConfig(**PT, use_alignability_head=True, random_pos_start=False),
                        vocab_size=PV + 1)
    model.init_weights(torch.Generator().manual_seed(3)).eval()
    state = reference_checkpoint(model, epoch=1, iteration=3)
    state["resume"] = {"step": 3}
    exp = tmp_path / "exp"
    Checkpointer(str(exp)).save_runtime(state, 3)
    out = tmp_path / "bare.pth.tar"
    export_torch.main(["--params", str(exp), "--out", str(out), "--epoch", "2",
                       "--iteration", "3", "--best_acc", "0.5"])
    assert "plain" in capsys.readouterr().out
    ckpt = torch.load(out, weights_only=True)
    assert set(ckpt) == {"epoch", "state_dict", "best_acc", "optimizer", "iteration"}
    assert (ckpt["epoch"], ckpt["iteration"], ckpt["best_acc"], ckpt["optimizer"]) == (
        2, 3, 0.5, {})
    loaded = load_reference_checkpoint(str(out), verbose=False)
    assert loaded["ema_params"] is None and loaded["epoch"] == 2

    rng = np.random.RandomState(0)
    video = rng.randn(2, 16, PT["video_embed_dim"]).astype(np.float32)
    ids = rng.randint(1, PV + 1, (2, 3, 8)).astype(np.int32)
    text = jm.apply({"params": loaded["params"]}, jnp.asarray(ids), jnp.asarray(ids != 0, jnp.int32),
                    method=JaxTAN.encode_text)
    want = jm.apply({"params": loaded["params"]}, jnp.asarray(video), text,
                    method=JaxTAN.text_visual_sims)
    ours = port_model(loaded["params"], use_alignability_head=True, random_pos_start=False)
    with torch.no_grad():
        got = ee.EvalForward(model)(ee.eval_params(model), torch.from_numpy(video),
                                    torch.from_numpy(ids).long())
        also = ee.EvalForward(ours)(ee.eval_params(ours), torch.from_numpy(video),
                                    torch.from_numpy(ids).long())
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=JAX_TOL, rtol=0,
                                   err_msg=k)
        assert torch.equal(got[k], also[k]), k  # the file's weights are the model's

    twin = tmp_path / "twin.pth.tar"
    torch.save(reference_checkpoint(model, target=model), tmp_path / "trained.pth.tar")
    export_torch.main(["--params", str(tmp_path / "trained.pth.tar"), "--out", str(twin)])
    assert "twin" in capsys.readouterr().out
    assert load_reference_checkpoint(str(twin), verbose=False)["ema_params"] is not None


def test_vis_helpers_match_jax(tmp_path):
    from temporalalignnet_torch.utils import vis
    from temporalalignnet_tpu.utils import vis as jvis

    for secs in (0, 59.9, 61, 3599, 3725.5, 86399):
        assert vis.second_to_time(secs) == jvis.second_to_time(secs)
    for start in (None, 0, 12.7):
        assert vis.get_youtube_link("abc123", start) == jvis.get_youtube_link("abc123", start)
    sim = np.random.RandomState(0).rand(3, 20)
    kw = dict(gt_spans=[(1, 4), (5, 9), (12, 18)], texts=["a", "b", "c"], title="t")
    ours = vis.save_similarity_heatmap(sim, str(tmp_path / "p" / "h.png"), **kw)
    theirs = jvis.save_similarity_heatmap(sim, str(tmp_path / "j" / "h.png"), **kw)
    assert ours == str(tmp_path / "p" / "h.png") and theirs is not None
    assert (tmp_path / "p" / "h.png").stat().st_size > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "short"), (torch.float32, "f32")])
def test_exported_program_calls_the_kernel_on_card(cuda, dtype, route):
    """The E6D6 eval forward exported on the card: 12 temporalalignnet.mha_fwd
    nodes (6 dual, 6 joint), 12 launches on the route per call of the loaded
    program, outputs equal to the live model's."""
    from temporalalignnet_torch.ops.mha_fwd import mha_fwd

    model = TANWithText(ModelConfig(use_alignability_head=True, random_pos_start=False),
                        vocab_size=66251)
    model.init_weights(torch.Generator().manual_seed(0)).to(cuda, dtype).eval()
    params = ee.eval_params(model)
    traced_from = mha_fwd.launches
    blob = ee.serialize(ee.export_eval_forward(model, params, 4, poly_batch=True))
    assert mha_fwd.launches == traced_from  # tracing runs the fake: no launch
    loaded = ee.deserialize(blob)
    assert ee.mha_fwd_nodes(loaded) == 12
    video, ids = ee.seeded_inputs(5, 64, 1024, 8, 32, cuda)
    before, by_route = mha_fwd.launches, dict(mha_fwd.launches_by_route)
    with torch.no_grad():
        got = loaded.module()(params, video, ids)
    torch.cuda.synchronize()
    assert mha_fwd.launches == before + 12
    assert mha_fwd.launches_by_route[route] == by_route[route] + 12
    with torch.no_grad():
        want = ee.EvalForward(model)(params, video, ids)
    assert all(torch.equal(got[k], want[k]) for k in want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [64, 200])
def test_mha_fwd_opcheck(cuda, dtype, S):
    import temporalalignnet_torch.ops  # noqa: F401

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 8, S, 64, generator=g).to(cuda, dtype) for _ in range(3))
    mask = (torch.rand(2, S, generator=g) < 0.3).to(cuda)
    for m in (None, mask):
        torch.library.opcheck(torch.ops.temporalalignnet.mha_fwd.default, (q, k, v, m))
