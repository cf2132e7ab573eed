"""The correctness check must fail a broken timed path.  Each test drives
the rest of a run on the CPU at tiny shapes (past the harness's look for a
card), once sound and once with the program broken underneath, and holds
the cell's own limits: a step that leaves its state unchanged, half of the
batch left out (the mean over the rest), an answer altered where it is
produced.  The control (the reference in float8 products put in the
program's place) must fail them too.  No cell runs across cards, so no
exchange between chips can be left out."""

import pytest
import torch

from benchmark import harness
from benchmark.drivers.tan_infer import answer_gaps
from benchmark.reference.common import training_numbers

from . import tiny



def _limits(cell):
    return harness.workload_of(cell)["limits"]


def _fails(out) -> bool:
    return out["correct"] is False


@pytest.mark.parametrize("cell", ["tan.stage1_graph", "tan.infer_b512"])
def test_a_sound_run_is_correct(cell):
    out = tiny.run(cell)
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0


def test_a_step_that_leaves_its_state_unchanged_fails(monkeypatch):
    from temporalalignnet_torch.train import optimizer

    monkeypatch.setattr(optimizer.Optimizer, "step", lambda self: False)
    assert _fails(tiny.run("tan.stage1_graph"))


def _half(x, dims):
    for d in dims:
        x = x.narrow(d, 0, x.shape[d] // 2)
    return x


def test_half_the_batch_left_out_fails_tan(monkeypatch):
    from temporalalignnet_torch.train import train_step

    inner = train_step.get_loss

    def half_loss(outputs, batch, cfg, group=None):
        # the cross-batch logits [B, S, T, B, N] lose half of both batch axes
        outs = {k: _half(v, (0, 3) if k.split("-")[-1].startswith("logits") else (0,))
                for k, v in outputs.items()}
        return inner(outs, {k: _half(v, (0,)) for k, v in batch.items()}, cfg, group)

    monkeypatch.setattr(train_step, "get_loss", half_loss)
    assert _fails(tiny.run("tan.stage1_graph"))


def _patch_answers(monkeypatch, change):
    from temporalalignnet_torch.models.net import TANWithText

    inner = TANWithText.text_visual_sims
    seen = []

    def broken(self, *a, **kw):
        out = inner(self, *a, **kw)
        seen.append(out)
        return change(out, seen)

    monkeypatch.setattr(TANWithText, "text_visual_sims", broken)


def test_an_answer_that_never_changes_fails_infer(monkeypatch):
    _patch_answers(monkeypatch, lambda out, seen: seen[0])
    assert _fails(tiny.run("tan.infer_b512"))


def test_an_answer_altered_where_it_is_produced_fails_infer(monkeypatch):
    def alter(out, seen):
        out = dict(out)
        out["sim"] = out["sim"].clone()
        out["sim"][0] = -out["sim"][0]
        return out

    _patch_answers(monkeypatch, alter)
    assert _fails(tiny.run("tan.infer_b512"))


def test_half_the_windows_left_out_fails_infer(monkeypatch):
    def halve(out, seen):
        return {k: torch.cat([_half(v, (0,)), torch.zeros_like(_half(v, (0,)))]) if v.shape[0] > 1
                else v for k, v in out.items()}

    _patch_answers(monkeypatch, halve)
    assert _fails(tiny.run("tan.infer_b512"))


def test_the_control_fails_stage1():
    drv = tiny.driver("tan.stage1_graph")
    drv.setup()
    drv.release()
    ref = drv.reference("f32")
    numbers = training_numbers(drv.reference("fp8"), ref)
    limits = _limits("tan.stage1_graph")
    assert any(numbers[k] > limits[k] for k in limits), numbers


def test_the_control_fails_infer():
    drv = tiny.driver("tan.infer_b512")
    drv.setup()
    for i in range(8):
        drv.dispatch(i)
    drv.sync()
    drv.release()
    assert drv.kept
    ref, fp8 = drv.reference("f32"), drv.reference("fp8")
    numbers = answer_gaps([(i, fp8[i]) for i, _ in drv.kept], ref)
    limits = _limits("tan.infer_b512")
    assert any(numbers[k] > limits[k] for k in limits), numbers
