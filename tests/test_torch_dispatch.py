"""``--steps_per_dispatch`` in the port's trainer (counterpart of JAX
tests/test_resume.py:192-260) and what a CUDA graph of the train step needs
of the model and the optimizer: on the CPU, a grouped run against the
per-step run, bit-equal, with an epoch's tail group and a mid-epoch resume;
the overshoot line; --backprop_freq 3 with --skip_nonfinite grouped and
resumed mid-cycle; the random pos starts as a device index; the device lr
table and its end; what a graph refuses (a gloo group, a tensor-parallel
model).  On a card (``cuda``): a group of eager warm-up steps and replays
against as many eager steps, Stage 1 and cotrain, at --backprop_freq 1, 2
and 3 and with --skip_nonfinite and a non-finite batch, also under a
world-of-one NCCL group (the collectives captured).  The CPU tests'
JAX-free fixtures are imported inside them, so the card's tests collect
without JAX:

    python -m pytest tests/test_torch_dispatch.py --noconftest -m cuda
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from temporalalignnet_torch.core.config import LossConfig, ModelConfig, TrainConfig
from temporalalignnet_torch.models.net import TANWithText
from temporalalignnet_torch.train import EMATwin, Optimizer, make_multi_train_step, make_train_step
from temporalalignnet_torch.train.cli import main as train_main
from temporalalignnet_torch.train.optimizer import lr_at, lr_table

torch.set_num_threads(2)

MODEL = dict(width=64, heads=1, num_encoder_layers=2, num_joint_layers=2, video_embed_dim=32,
             num_pos_embeds=256)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Ten videos: 5 steps an epoch at batch 2, so groups of 2, 2, 1."""
    from port_fixtures import write_feature_dir

    return write_feature_dir(tmp_path_factory.mktemp("dispatch"), videos=10)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _run(data, prefix, *extra, capsys=None):
    from port_fixtures import CLI_SHAPE

    out = train_main(["--feature_dir", str(data / "features"),
                      "--captions", str(data / "captions.json"),
                      "--vocab", str(data / "vocab.npy"), "--device", "cpu",
                      "--batch_size", "2", "--seq_len", "32", "--max_sentences", "4",
                      "--log_every", "1", "--num_workers", "2", "--epochs", "2",
                      "--warmup_iterations", "2", "--runtime_save_iter", "0",
                      "--prefix", str(prefix), *CLI_SHAPE, *extra])
    text = capsys.readouterr().out if capsys else ""
    return out, text


def _losses(text):
    return [json.loads(l)["loss"] for l in text.splitlines() if l.startswith('{"step"')]


def _final(out):
    """The weights and optimizer state of the run's last checkpoint."""
    ckpt = torch.load(out["checkpoint"], map_location="cpu", weights_only=True)
    return ckpt["state_dict"], ckpt["optimizer"]


def _assert_equal(a, b, path=""):
    if isinstance(a, torch.Tensor):
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


def test_grouped_run_equals_the_per_step_run(data, tmp_path, capsys):
    """--steps_per_dispatch 2 over 2 epochs of 5 steps (groups 2, 2, 1 each):
    the same per-step losses, weights and optimizer state, to the bit."""
    one, one_log = _run(data, tmp_path / "k1", capsys=capsys)
    two, two_log = _run(data, tmp_path / "k2", "--steps_per_dispatch", "2", capsys=capsys)
    assert one["final_step"] == two["final_step"] == 10
    assert _losses(one_log) == _losses(two_log) and len(_losses(one_log)) == 10
    rows = lambda t: [{k: v for k, v in json.loads(l).items() if k != "steps_per_s"}
                      for l in t.splitlines() if l.startswith('{"step"')]
    assert rows(one_log) == rows(two_log)  # lr and every metric of every step
    _assert_equal(_final(one), _final(two))
    assert "[stop]" not in two_log


def test_resume_with_grouped_dispatch_trains_the_tail_batches(data, tmp_path, capsys):
    """A grouped run stopped past --max_steps 3 (at 4, with a runtime
    checkpoint there and the overshoot line) and resumed grouped: the
    resumed epoch yields one batch, which must run as a tail group of 1, so
    the result equals the uninterrupted per-step run."""
    whole, whole_log = _run(data, tmp_path / "a", capsys=capsys)
    _, stopped_log = _run(data, tmp_path / "b", "--steps_per_dispatch", "2",
                          "--runtime_save_iter", "3", "--max_steps", "3", capsys=capsys)
    assert ("[stop] --steps_per_dispatch group overshot --max_steps 3 by 1 steps "
            "(stopped at 4)") in stopped_log.splitlines()
    saves = [json.loads(l) for l in stopped_log.splitlines()
             if l.startswith('{"runtime_checkpoint"')]
    assert [s["at_step"] for s in saves] == [4]
    resumed, resumed_log = _run(data, tmp_path / "b", "--steps_per_dispatch", "2",
                                "--resume", "auto", capsys=capsys)
    assert "[resume] at step 4 (epoch 0, batch 4)" in resumed_log
    assert resumed["final_step"] == 10
    assert _losses(stopped_log) + _losses(resumed_log) == _losses(whole_log)
    _assert_equal(_final(whole), _final(resumed))


def test_refuses_a_group_of_no_steps(data, tmp_path):
    with pytest.raises(SystemExit, match="at least 1"):
        _run(data, tmp_path, "--steps_per_dispatch", "0")


def _batch(seed, B=3, T=16, N=4, Wd=8):
    from temporalalignnet_torch.data.synthetic import synthetic_batch

    return {k: torch.from_numpy(v) for k, v in synthetic_batch(
        np.random.RandomState(seed), batch_size=B, seq_len=T, max_sentences=N,
        feature_dim=MODEL["video_embed_dim"], vocab_size=50, max_words=Wd).items()}


def _setup(cotrain=False, device="cpu", multi=False, group=None, **train_kw):
    head = dict(use_alignability_head=True) if cotrain else {}
    card = str(device) != "cpu"  # heads of 64: the kernels' head dim
    model = TANWithText(ModelConfig(**MODEL, **head, use_text_pos_enc=True, fused_milnce=card),
                        vocab_size=51)
    model.init_weights(torch.Generator().manual_seed(0)).to(device)
    tcfg = TrainConfig(lr=1e-3, warmup_iterations=1, total_iterations=20, **train_kw)
    opt = Optimizer(model, tcfg)
    twin = EMATwin(model, tcfg) if cotrain else None
    loss_kw = dict(model="cotrain", learn_agreement=True, **head) if cotrain else {}
    make = make_multi_train_step if multi else make_train_step
    step = make(model, opt, tcfg, LossConfig(use_fused_milnce=card, **loss_kw),
                compute_dtype=torch.float32, twin=twin, group=group)
    return model, opt, step, twin


def test_pos_starts_gather_the_rows_the_slice_took():
    """The random pos starts as a device index: the gathered rows are the
    slice's, bit for bit, and a forward given the starts as a tensor equals
    the forward given them as ints."""
    model = _setup()[0].train()
    table = model.temporal_pos_embed.detach()
    for start in (0, 5, 31, 200):
        got = model._pos_rows(table, 24, torch.tensor(start))
        assert torch.equal(got, table[start:start + 24])
        assert torch.equal(model._pos_rows(table, 24, start), got)
    assert torch.equal(model._pos_rows(table, 24, None), table[:24])
    b = _batch(1)
    args = (b["video"], b["input_ids"].long(), b["video_padding_mask"], b["text_padding_mask"])
    starts = model.draw_pos_starts(16, 4, torch.Generator().manual_seed(7))
    assert len(starts) == 3 and all(isinstance(s, int) for s in starts)
    assert 0 <= starts[0] < 8 and 0 <= starts[1] < 2 and 0 <= starts[2] < 8
    with torch.no_grad():
        ints = model(*args, pos_starts=starts)
        given = model(*args, pos_starts=torch.tensor(starts))
    for k in ints:
        assert torch.equal(ints[k], given[k]), k
    with pytest.raises(ValueError, match="pos_starts"):
        model(*args)
    model.cfg = dataclasses.replace(model.cfg, random_pos_start=False)
    assert model.draw_pos_starts(16, 4, None) is None  # no random start: no draw


def test_device_lr_table_equals_lr_at():
    cfg = TrainConfig(lr=3e-4, warmup_iterations=7, total_iterations=50)
    table = lr_table(cfg, "cpu")
    assert table.dtype == torch.float32 and table.numel() == 51
    assert table.tolist() == [lr_at(cfg, u) for u in range(51)]


def test_lr_table_refuses_updates_past_total_iterations():
    """A graphed run reads the lr from the table unchecked, so a group that
    would run past total_iterations is refused before it replays, and so is
    an eager step of the device form; the host form's lr needs no table."""
    model = _setup()[0]
    assert not hasattr(Optimizer(model, TrainConfig(total_iterations=20)), "_lr_table")
    opt = Optimizer(model, TrainConfig(total_iterations=20), capturable=True)
    opt.updates = 19
    assert opt._u.tolist() == [19] and opt._lr_table.numel() == 21
    opt.check_lr_table(2)  # updates 19 and 20: the table's last two
    with pytest.raises(ValueError, match="stops at total_iterations"):
        opt.check_lr_table(3)
    opt.updates = 21
    with pytest.raises(ValueError, match="stops at total_iterations"):
        opt.step()


def test_grouped_steps_equal_single_steps_on_the_cpu():
    batches = [_batch(s) for s in range(3)]
    ref_model, _, step, _ = _setup(cotrain=True)
    want = [step(b) for b in batches]
    model, opt, multi, twin = _setup(cotrain=True, multi=True)
    got = multi(batches)
    assert multi.updates_after.tolist() == [1, 2, 3] and twin.micro_steps == 3
    for k in want[0]:
        assert torch.equal(got[k], torch.stack([w[k] for w in want])), k
    _assert_equal(ref_model.state_dict(), model.state_dict())
    assert torch.equal(multi.generator.get_state(), step.generator.get_state())


# the card's grouped cases: (cotrain, TrainConfig flags, the batch made non-finite)
CARD_CASES = {"init": (False, {}, None), "cotrain": (True, {}, None),
              "init_backprop_freq_3": (False, dict(backprop_freq=3), None),
              "cotrain_backprop_freq_2": (True, dict(backprop_freq=2), None),
              "init_skip_nonfinite": (False, dict(skip_nonfinite_updates=True), 3)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_graphed_group_equals_eager_steps_on_card(cuda, case):
    """Groups (the eager warm-up steps, then replays of the captured steps,
    one graph per kind of step) against as many eager steps from the same
    state: equal losses, params, twin, update counts and non-finite count,
    to the bit.  Two groups, so that replays of both kinds run at k = 3 and
    a cycle crosses the groups; the non-finite batch is replayed.  The
    wrappers count the warm-up's launches and the captures', and no
    replay's."""
    from temporalalignnet_torch.ops.mha_fwd import mha_fwd

    cotrain, flags, bad = CARD_CASES[case]
    batches = [{k: v.pin_memory() for k, v in _batch(s).items()} for s in range(8)]
    if bad is not None:
        batches[bad]["video"][0, 0, 0] = float("nan")
    model, opt, step, twin = _setup(cotrain, cuda, **flags)
    want = torch.stack([step(b)["loss"] for b in batches])
    gmodel, gopt, multi, gtwin = _setup(cotrain, cuda, multi=True, **flags)
    before = mha_fwd.launches
    got = torch.cat([multi(batches[:4])["loss"], multi(batches[4:])["loss"]])
    torch.cuda.synchronize()
    per_step = multi.launches_per_step["mha_fwd"][""]
    assert per_step == (8 if cotrain else 4)
    assert mha_fwd.launches == before + (multi.warmup + len(multi.kinds)) * per_step
    assert torch.equal(got.isnan(), want.isnan()) and got.isnan().sum() == (bad is not None)
    assert torch.equal(got.nan_to_num(), want.nan_to_num())
    assert gopt.updates == opt.updates and gopt.notfinite == opt.notfinite
    assert gopt.micro == opt.micro and multi.updates_after.tolist()[-1] == opt.updates
    _assert_equal(model.state_dict(), gmodel.state_dict())
    _assert_equal(opt.adamw.state_dict(), gopt.adamw.state_dict())
    if cotrain:
        _assert_equal(twin.model.state_dict(), gtwin.model.state_dict())
        assert gtwin.micro_steps == twin.micro_steps == len(batches)
    if bad is not None:
        assert opt.updates == len(batches) - 1


def test_cli_grouped_with_backprop_freq_equals_the_per_step_run(data, tmp_path, capsys):
    """--steps_per_dispatch 2 with --backprop_freq 3 and --skip_nonfinite 1
    (on the card captured as two kinds of step), stopped past --max_steps 3
    mid-cycle and resumed grouped: the losses and the final weights and
    optimizer state equal the uninterrupted per-step run's."""
    flags = ("--backprop_freq", "3", "--skip_nonfinite", "1")
    whole, whole_log = _run(data, tmp_path / "a", *flags, capsys=capsys)
    _, stopped_log = _run(data, tmp_path / "b", *flags, "--steps_per_dispatch", "2",
                          "--max_steps", "3", capsys=capsys)
    resumed, resumed_log = _run(data, tmp_path / "b", *flags, "--steps_per_dispatch", "2",
                                "--resume", "auto", capsys=capsys)
    assert "[resume] at step 4 (epoch 0, batch 4)" in resumed_log
    assert resumed["final_step"] == whole["final_step"] == 10
    assert _losses(stopped_log) + _losses(resumed_log) == _losses(whole_log)
    _assert_equal(_final(whole), _final(resumed))
    assert _final(whole)[1]["updates"] == 3


@pytest.fixture
def world_of_one():
    """A gloo group of one CPU process, left at the end."""
    from port_fixtures import free_port
    from temporalalignnet_torch.parallel import distributed

    assert distributed.initialize_multihost(f"127.0.0.1:{free_port()}", 1, 0, device="cpu")
    try:
        yield distributed.default_group()
    finally:
        distributed.destroy()


@pytest.mark.parametrize("what", ["gloo", "tensor_parallel"])
def test_graph_refusals_say_why(world_of_one, what):
    """What a CUDA graph of the step cannot hold, refused with its reason
    (``check_graphable``, which the card runs before a capture): a gloo
    group's collectives are host code; a tensor-parallel model's graph
    would hold NCCL collectives over two or more ranks, one a card.  A
    model without either passes, whatever its --backprop_freq and
    --skip_nonfinite (the card's cases run them)."""
    from temporalalignnet_torch.parallel.tensor import TPGroup
    from temporalalignnet_torch.train.train_step import check_graphable

    model = _setup()[0]
    group = world_of_one if what == "gloo" else None
    if what == "tensor_parallel":
        model.joint_temporal_encoder.resblocks[0].attn.tp = TPGroup(world_of_one)
    match = {"gloo": "gloo collective is host code",
             "tensor_parallel": "tensor-parallel model.*two or more ranks, one a card"}[what]
    with pytest.raises(ValueError, match=match):
        check_graphable(model, group)
    check_graphable(_setup()[0])  # no group, no tensor parallelism: capturable


def test_grouped_steps_under_a_group_equal_single_steps_on_the_cpu(world_of_one):
    """On the CPU a group of steps under a process group (here gloo, a world
    of one) is that many eager data-parallel steps."""
    batches = [_batch(s) for s in range(3)]
    ref_model, _, step, _ = _setup(group=world_of_one)
    want = [step(b) for b in batches]
    model, _, multi, _ = _setup(multi=True, group=world_of_one)
    got = multi(batches)
    for k in want[0]:
        assert torch.equal(got[k], torch.stack([w[k] for w in want])), k
    _assert_equal(ref_model.state_dict(), model.state_dict())


@pytest.mark.cuda
@pytest.mark.parametrize("cotrain", [False, True], ids=["init", "cotrain"])
def test_graphed_group_under_nccl_equals_eager_steps_on_card(cuda, cotrain):
    """A world of one over NCCL: the captured step holds its collectives (the
    loss's gathers and statistics, the column merges, the gradient average);
    its replays against as many eager steps under the same group, to the bit."""
    import socket

    from temporalalignnet_torch.parallel import distributed
    from temporalalignnet_torch.train.train_step import GraphedStep

    with socket.socket() as sock:  # port_fixtures imports JAX, which the card's machine lacks
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    distributed.initialize_multihost(f"127.0.0.1:{port}", 1, 0, device="cuda")
    try:
        group = distributed.default_group()
        n = GraphedStep.WARMUP + 2
        batches = [{k: v.pin_memory() for k, v in _batch(s).items()} for s in range(n)]
        model, opt, step, twin = _setup(cotrain, cuda, group=group)
        want = torch.stack([step(b)["loss"] for b in batches])
        gmodel, gopt, multi, gtwin = _setup(cotrain, cuda, multi=True, group=group)
        got = multi(batches)["loss"]
        torch.cuda.synchronize()
        assert torch.equal(got, want) and gopt.updates == opt.updates == n
        _assert_equal(model.state_dict(), gmodel.state_dict())
        if cotrain:
            _assert_equal(twin.model.state_dict(), gtwin.model.state_dict())
    finally:
        distributed.destroy()
