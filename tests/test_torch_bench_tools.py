"""The port's bench tools (``tools/bench_train_step.py``, ``bench_e2e_step.py``,
``bench_loader.py``) against their JAX counterparts: the same flags (the port
adds only ``--device``) and output keys, the same configs and batches (JAX's
captured where its tool hands them on, the JAX package untouched), the same
corpora and loader batches; each tool runs on the CPU at tiny sizes, and
the e2e tool's FLOP count is held to S3D's multiply-adds."""

import argparse
import ast
import dataclasses
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
TOOLS = ("bench_train_step", "bench_e2e_step", "bench_loader")


class _Stop(BaseException):
    """Ends a JAX tool's main where its inputs are recorded (a BaseException:
    the tools catch Exception around their cost analysis)."""


def _jax_source(tool):
    return (REPO / "temporalalignnet_tpu" / "tools" / f"{tool}.py").read_text()


def _jax_flags(tool):
    """{flag: {type, default, choices, action}} of the JAX tool's
    ``add_argument`` calls, read from its source."""
    flags = {}
    for node in ast.walk(ast.parse(_jax_source(tool))):
        if not (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument"):
            continue
        kw = {k.arg: k.value for k in node.keywords}
        value = lambda k: (eval(compile(ast.Expression(kw[k]), tool, "eval"), {"__builtins__": {}})
                           if k in kw else None)
        flags[node.args[0].value] = {
            "type": kw["type"].id if "type" in kw else None,
            "default": value("default"), "choices": value("choices"),
            "action": value("action")}
    return flags


def _port_flags(parser):
    flags = {}
    for a in parser._actions:
        if not a.option_strings or isinstance(a, argparse._HelpAction):
            continue
        store_true = isinstance(a, argparse._StoreTrueAction)
        flags[a.option_strings[0]] = {
            "type": a.type.__name__ if a.type else None,
            "default": None if store_true else a.default, "choices": a.choices,
            "action": "store_true" if store_true else None}
    return flags


def _port_tool(tool):
    import importlib

    return importlib.import_module(f"temporalalignnet_torch.tools.{tool}")


@pytest.mark.parametrize("tool", TOOLS)
def test_flags_match_the_jax_tool(tool):
    jax_flags, port = _jax_flags(tool), _port_flags(_port_tool(tool).build_parser())
    assert set(port) - set(jax_flags) <= {"--device"}
    assert set(jax_flags) <= set(port)
    if "--device" in port:
        assert port["--device"]["default"] == "cuda"
    if tool == "bench_loader":  # the demand the cores are sized against is the card's
        assert jax_flags["--target_sps"]["default"] == pytest.approx(59.6 * 64)
        assert port["--target_sps"]["default"] == pytest.approx(58.67 * 64)
        jax_flags.pop("--target_sps"), port.pop("--target_sps")
    assert {k: port[k] for k in jax_flags} == jax_flags


def _jax_out_keys(tool):
    for node in ast.walk(ast.parse(_jax_source(tool))):
        if (isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == "out"
                and isinstance(node.value, ast.Dict)):
            return {k.value for k in node.value.keys}
    raise AssertionError(f"no out = {{...}} in {tool}")


def _printed(capsys):
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    assert len(lines) == 1, lines
    return json.loads(lines[0])


@pytest.fixture
def jax_config():
    """The JAX tools set the compilation cache options; restored after."""
    import jax

    names = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    saved = {n: getattr(jax.config, n) for n in names}
    yield
    for n, v in saved.items():
        jax.config.update(n, v)


def _common_fields(a, b):
    """The fields two config dataclasses share, each side's values."""
    names = {f.name for f in dataclasses.fields(a)} & {f.name for f in dataclasses.fields(b)}
    return ({n: getattr(a, n) for n in sorted(names)},
            {n: getattr(b, n) for n in sorted(names)})


def _assert_batches_equal(ours, theirs):
    assert set(ours) == set(theirs)
    for k in theirs:
        a, b = np.asarray(ours[k]), np.asarray(theirs[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


# ------------------------------------------------------------- train step

_BATCHES = {}


@pytest.fixture
def cached_batches(monkeypatch):
    """Each package's ``synthetic_batch`` computed once per inputs in this
    module (its 66,251-word projection costs seconds), copies returned."""
    import temporalalignnet_tpu.data.synthetic as jax_synthetic
    import temporalalignnet_torch.data.synthetic as port_synthetic

    for module in (jax_synthetic, port_synthetic):
        def cached(rng, *, _fn=module.synthetic_batch, _tag=module.__name__, **kw):
            key = (_tag, repr(sorted(kw.items())), repr(rng.get_state()))
            if key not in _BATCHES:
                _BATCHES[key] = _fn(rng, **kw)
            return {k: v.copy() for k, v in _BATCHES[key].items()}

        monkeypatch.setattr(module, "synthetic_batch", cached)


TRAIN_CASES = [["--stage", "1", "--fused", "0"], ["--stage", "1", "--fused", "1"],
               ["--stage", "2", "--fused", "0"], ["--stage", "2", "--fused", "1"],
               ["--remat", "1"]]


@pytest.mark.parametrize("argv", TRAIN_CASES, ids=lambda a: "_".join(a).replace("--", ""))
def test_train_step_configs_and_batch_equal_jax(argv, monkeypatch, jax_config, cached_batches):
    import temporalalignnet_tpu.train.train_step as jax_train_step
    from temporalalignnet_tpu.tools import bench_train_step as jax_tool

    seen = {}

    def record(model, tcfg, loss_cfg, batch, *a, **kw):
        seen.update(model=model, tcfg=tcfg, loss_cfg=loss_cfg, batch=batch)
        raise _Stop

    monkeypatch.setattr(jax_train_step, "create_train_state", record)
    with pytest.raises(_Stop):
        jax_tool.main(argv)

    tool = _port_tool("bench_train_step")
    args = tool.build_parser().parse_args(argv + ["--device", "cpu"])
    mcfg, loss_cfg, tcfg = tool.configs(args)
    for ours, theirs in ((mcfg, seen["model"].cfg), (loss_cfg, seen["loss_cfg"]),
                         (tcfg, seen["tcfg"])):
        a, b = _common_fields(ours, theirs)
        assert len(a) >= 7 and a == b
    assert mcfg.remat == seen["model"].remat
    assert tool.VOCAB_SIZE == seen["model"].vocab_size
    _assert_batches_equal(tool.make_batch(args, mcfg), seen["batch"])


@pytest.mark.parametrize("stage,fused", [(1, 1), (2, 1), (1, 0)])
def test_train_step_tool_runs_on_the_cpu(stage, fused, capsys, cached_batches):
    out = _port_tool("bench_train_step").main(
        ["--device", "cpu", "--stage", str(stage), "--fused", str(fused), "--batch_size", "2",
         "--seq_len", "16", "--max_sentences", "4", "--iters", "1", "--repeats", "1"])
    printed = _printed(capsys)
    assert printed == out
    assert set(printed) == _jax_out_keys("bench_train_step")
    assert np.isfinite(printed["value"]) and printed["value"] > 0
    assert printed["metric"] == f"stage{stage}_train_steps_per_sec"
    assert printed["fused_milnce"] is bool(fused) and printed["backend"] == "cpu"
    assert printed["temp_mb"] is None


@pytest.mark.parametrize("tool", ["bench_train_step", "bench_e2e_step"])
def test_tools_refuse_cuda_without_a_card(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        _port_tool(tool).main(["--device", "cuda"])


# --------------------------------------------------------------- e2e step

E2E_TINY = ["--batch_size", "1", "--num_frames", "8", "--crop_size", "64", "--max_words", "8"]
E2E_CASES = [E2E_TINY,
             E2E_TINY + ["--train_bn_stats", "1", "--freeze_early", "1", "--fold_s2d", "0",
                         "--num_classes", "256", "--vocab_size", "1000", "--f32"],
             ["--batch_size", "2", "--clips_per_video", "3", "--num_frames", "4",
              "--crop_size", "32", "--max_words", "5"]]


@pytest.mark.parametrize("argv", E2E_CASES, ids=("tiny", "flags", "shapes"))
def test_e2e_step_model_config_and_batch_equal_jax(argv, monkeypatch, jax_config):
    import temporalalignnet_tpu.train.end2end as jax_e2e
    from temporalalignnet_tpu.tools import bench_e2e_step as jax_tool

    seen = {}

    class Model:
        def __init__(self, **kw):
            seen["model_kwargs"] = kw

        def init(self, rng, clips, ids):
            return {"params": {}, "batch_stats": {}}

    class Tx:
        def init(self, params):
            return {}

    class Step:
        def lower(self, state, batch):
            seen["batch"] = batch
            raise _Stop

    def optimizer(tcfg, params):
        seen["tcfg"] = tcfg
        return Tx()

    def train_step(model, tx, temperature):
        seen["temperature"] = temperature
        return Step()

    monkeypatch.setattr(jax_e2e, "S3DWithText", Model)
    monkeypatch.setattr(jax_e2e, "make_e2e_optimizer", optimizer)
    monkeypatch.setattr(jax_e2e, "make_e2e_train_step", train_step)
    with pytest.raises(_Stop):
        jax_tool.main(argv)

    tool = _port_tool("bench_e2e_step")
    args = tool.build_parser().parse_args(argv + ["--device", "cpu"])
    jax_kwargs = dict(seen["model_kwargs"])
    assert np.dtype(jax_kwargs.pop("dtype")) == np.float32  # f32 on the CPU, as the port
    assert tool.model_kwargs(args) == jax_kwargs
    a, b = _common_fields(tool.train_config(), seen["tcfg"])
    assert len(a) >= 7 and a == b
    assert seen["temperature"] == 0.07
    _assert_batches_equal(tool.make_batch(args), seen["batch"])


def test_e2e_step_tool_runs_on_the_cpu_and_counts_its_flops(capsys, tmp_path):
    """One JSON line with JAX's keys; the forward's FLOPs are 2 x S3D's
    convolution and linear multiply-adds (``chip_smoke.s3d_macs``), and the
    step's lie between 2x and 3x the forward's (the clips take no gradient,
    so conv1 has no data gradient)."""
    import chip_smoke
    from temporalalignnet_torch.train.end2end import S3DWithText

    tool = _port_tool("bench_e2e_step")
    out = tool.main(E2E_TINY + ["--device", "cpu", "--iters", "1", "--repeats", "1",
                                "--profile_dir", str(tmp_path)])
    printed = _printed(capsys)
    assert printed == out
    assert set(printed) == _jax_out_keys("bench_e2e_step")
    assert np.isfinite(printed["value"]) and printed["value"] > 0
    assert printed["dtype"] == "float32" and printed["backend"] == "cpu"
    assert [p.name for p in tmp_path.iterdir()] == [f"trace_{os.getpid()}.json"]

    args = tool.build_parser().parse_args(E2E_TINY)
    model = S3DWithText(**tool.model_kwargs(args))
    model.init_weights(torch.Generator().manual_seed(0))
    clips = torch.from_numpy(tool.make_batch(args)["clips"])
    x = clips.reshape((-1,) + clips.shape[2:]).permute(0, 4, 1, 2, 3)
    with torch.no_grad():
        _, forward = tool.count_flops(lambda: model(x))
    assert forward == 2 * chip_smoke.s3d_macs(torch, model, x) * x.shape[0]
    assert 2 * forward < printed["gflops_per_step"] * 1e9 < 3 * forward


# ----------------------------------------------------------------- loader


def test_loader_corpora_are_byte_equal_to_jax(tmp_path):
    from temporalalignnet_tpu.tools import bench_loader as jax_tool

    tool = _port_tool("bench_loader")
    assert tool.WORDS == jax_tool.WORDS
    for name, build, n in (("corpus", "build_corpus", 3),
                           ("metadata", "build_metadata_corpus", 20)):
        ours, theirs = tmp_path / f"port_{name}", tmp_path / f"jax_{name}"
        ours.mkdir(), theirs.mkdir()
        getattr(tool, build)(str(ours), n, np.random.RandomState(0))
        getattr(jax_tool, build)(str(theirs), n, np.random.RandomState(0))
        files = sorted(p.relative_to(theirs) for p in theirs.rglob("*") if p.is_file())
        assert files == sorted(p.relative_to(ours) for p in ours.rglob("*") if p.is_file())
        assert len(files) >= 2
        for f in files:
            assert (ours / f).read_bytes() == (theirs / f).read_bytes(), f


def test_loader_batches_equal_jax(tmp_path):
    from temporalalignnet_tpu.core.config import DataConfig as JaxDataConfig
    from temporalalignnet_tpu.data.htm import HTMFeatureDataset as JaxDataset
    from temporalalignnet_tpu.data.prefetch import TrainLoader as JaxLoader
    from temporalalignnet_tpu.models.word2vec import Word2VecTokenizer as JaxTokenizer
    from temporalalignnet_tpu.tools import bench_loader as jax_tool

    tool = _port_tool("bench_loader")
    feat_dir, cap_path = tool.build_corpus(str(tmp_path), 8, np.random.RandomState(0))
    ours = tool.TrainLoader(tool.make_dataset(feat_dir, cap_path, 256), batch_size=4, seed=0,
                            num_workers=1, prefetch=2)
    # as JAX's bench_loader.main builds them
    cfg = JaxDataConfig(batch_size=4, feature_dim=512)
    theirs = JaxLoader(JaxDataset(feat_dir, cap_path, cfg, "train",
                                  JaxTokenizer(jax_tool.WORDS, max_words=cfg.max_words),
                                  cache_videos=256),
                       batch_size=4, shuffle=True, seed=0, num_workers=1, prefetch=2,
                       drop_last=True)
    assert len(ours) == len(theirs) == 2
    for a, b in zip(ours, theirs):
        _assert_batches_equal({k: v.numpy() for k, v in a.items()}, b)


@pytest.mark.parametrize("argv,expect", [
    (["--videos", "8", "--batches", "2", "--workers", "1,2", "--batch_size", "4"],
     ["corpus: 8 samples over 8 videos", "workers=1:", "workers=2:",
      "feeding 3,755 samples/s"]),
    (["--metadata", "200"], ["corpus metadata: 200 videos", "convert_captions",
                             "monolithic json.load: init", "indexed .jsonl store: init",
                             "190 train videos"]),
    (["--vlen_files", "20"], ["build_vlen_table: 20 files"]),
], ids=("workers", "metadata", "vlen_files"))
def test_loader_tool_runs(argv, expect, capsys):
    _port_tool("bench_loader").main(argv)
    out = capsys.readouterr().out
    for text in expect:
        assert text in out, (text, out)
