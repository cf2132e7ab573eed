"""Grouped dispatch in the optimizer's device form (the one the card
captures in CUDA graphs) against the JAX package's ``make_multi_train_step``
(a ``lax.scan`` of the train step), f32 on the CPU, on the same weights
(moved through state_dict_from_jax) and the same seeded batches: cotrain at
``backprop_freq=2`` (tests/test_train.py::TestMultiStepDispatch's set-up),
Stage 1 at ``backprop_freq=3`` over a group that crosses a cycle, and
``skip_nonfinite_updates`` with a non-finite batch mid-group."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from port_fixtures import TINY, jax_model, to_torch
from temporalalignnet_torch.checkpoint import state_dict_from_jax
from temporalalignnet_torch.core.config import LossConfig, ModelConfig, TrainConfig
from temporalalignnet_torch.models.net import TANWithText
from temporalalignnet_torch.train import EMATwin, Optimizer, make_multi_train_step
from temporalalignnet_tpu.core import config as jcfg
from temporalalignnet_tpu.data.synthetic import synthetic_batch
from temporalalignnet_tpu.models.net import TANWithText as JaxTANWithText
from temporalalignnet_tpu.train.train_step import create_train_state, stack_batches
from temporalalignnet_tpu.train.train_step import make_multi_train_step as jax_multi

torch.set_num_threads(2)

LOSS_TOL = 2e-4  # whole steps (tests/test_torch_train.py)
PARAM_ATOL, PARAM_RTOL = 2e-4, 1e-3
COTRAIN = dict(model="cotrain", learn_agreement=True, use_alignability_head=True,
               loss_threshold=0.5)

# (loss flags, train flags, batches, the batch made non-finite); the lr schedule of
# the port's step tests (warmup 2: the first update at lr 0, the second at lr / 2)
CASES = {
    "cotrain_backprop_freq_2": (COTRAIN, dict(backprop_freq=2), 4, None),
    "stage1_backprop_freq_3": ({}, dict(backprop_freq=3), 7, None),
    "stage1_skip_nonfinite": ({}, dict(skip_nonfinite_updates=True), 3, 1),
}
SCHEDULE = dict(lr=1e-3, warmup_iterations=2, total_iterations=100)


def _batches(n, bad):
    out = [synthetic_batch(np.random.RandomState(s), batch_size=8, seq_len=32, max_sentences=4,
                           feature_dim=TINY["video_embed_dim"], vocab_size=50, max_words=8)
           for s in range(1, n + 1)]
    if bad is not None:
        out[bad]["video"][0, 0, 0] = np.nan
    return out


def _port(params, model_kw, tcfg, loss_kw):
    model = TANWithText(ModelConfig(**model_kw), vocab_size=51)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    opt = Optimizer(model, tcfg, capturable=True)
    twin = EMATwin(model, tcfg) if loss_kw.get("model") == "cotrain" else None
    multi = make_multi_train_step(model, opt, tcfg, LossConfig(**loss_kw), twin=twin)
    return model, opt, multi, twin


def _close(ours, ref, what):
    ref = state_dict_from_jax(jax.device_get(ref))
    assert set(ref) == set(ours)
    for k in ref:
        np.testing.assert_allclose(ours[k].numpy(), ref[k].numpy(), atol=PARAM_ATOL,
                                   rtol=PARAM_RTOL, err_msg=f"{what} {k}")


@pytest.mark.parametrize("case", list(CASES))
def test_device_form_group_matches_jax_scan(case):
    """One group through both: the per-step losses (loss ≤ LOSS_TOL, the
    non-finite step NaN in both), the params and EMA params (PARAM_ATOL /
    PARAM_RTOL), and the update counts against optax's (MultiSteps'
    gradient_step, the schedule's count, apply_if_finite's notfinite_count)."""
    loss_kw, train_kw, n, bad = CASES[case]
    loss_kw = dict(loss_kw, use_fused_milnce=False)
    model_kw = dict(TINY, random_pos_start=False,
                    use_alignability_head=loss_kw.get("use_alignability_head", False))
    train_kw = dict(SCHEDULE, **train_kw)
    batches = _batches(n, bad)

    jm = JaxTANWithText(jcfg.ModelConfig(**model_kw), vocab_size=51)
    jtrain, jloss = jcfg.TrainConfig(**train_kw), jcfg.LossConfig(**loss_kw)
    state, tx = create_train_state(jm, jtrain, jloss,
                                   {k: jnp.asarray(v) for k, v in batches[0].items()}, seed=0)
    params0 = jax.device_get(state.params)
    state, ref_m = jax_multi(jm, tx, jtrain, jloss)(state, stack_batches(batches))

    tcfg = TrainConfig(**train_kw)
    model, opt, multi, twin = _port(params0, model_kw, tcfg, loss_kw)
    got = multi([{k: to_torch(v) for k, v in b.items()} for b in batches])
    ref_loss = np.asarray(ref_m["loss"])
    ours = got["loss"].numpy()
    assert np.array_equal(np.isnan(ours), np.isnan(ref_loss))
    assert np.isnan(ours).sum() == (bad is not None)
    np.testing.assert_allclose(np.nan_to_num(ours), np.nan_to_num(ref_loss), atol=LOSS_TOL,
                               rtol=0)
    _close(model.state_dict(), state.params, "online")
    if twin is not None:
        _close(twin.model.state_dict(), state.ema_params, "target")

    k = tcfg.backprop_freq
    updates = n // k - (bad is not None)
    assert opt.updates == updates and opt._u.tolist() == [updates]
    assert multi.updates_after.tolist()[-1] == updates and opt.micro == n % k
    counts = [int(v) for _, v in optax.tree_utils.tree_get_all_with_path(state.opt_state,
                                                                         "count")]
    assert counts and all(c == updates for c in counts)
    if k > 1:
        assert int(optax.tree_utils.tree_get(state.opt_state, "gradient_step")) == n // k
    if bad is not None:
        assert int(optax.tree_utils.tree_get(state.opt_state, "notfinite_count")) == 0
        assert opt.notfinite == 0


def test_device_form_skip_leaves_the_state_unmoved():
    """The non-finite batch of ``stage1_skip_nonfinite`` alone, after the
    first: the params, AdamW's moments and step counts, and the lr index
    stay bit-equal, the non-finite count is 1; the group of three then
    equals the steps taken one group at a time."""
    tcfg = TrainConfig(**SCHEDULE, skip_nonfinite_updates=True)
    _, params = jax_model(random_pos_start=False)
    batches = [{k: to_torch(v) for k, v in b.items()} for b in _batches(3, 1)]
    model_kw = dict(TINY, random_pos_start=False)
    model, opt, multi, _ = _port(params, model_kw, tcfg, {})
    multi(batches[:1])
    before = copy.deepcopy((model.state_dict(), opt.adamw.state_dict()["state"], opt._u))
    multi(batches[1:2])
    assert opt.notfinite == 1 and multi.updates_after.tolist() == [1]
    _equal(model.state_dict(), before[0])
    _equal(opt.adamw.state_dict()["state"], before[1])
    assert torch.equal(opt._u, before[2])
    multi(batches[2:])
    whole, wopt, wmulti, _ = _port(params, model_kw, tcfg, {})
    wmulti(batches)
    _equal(whole.state_dict(), model.state_dict())
    _equal(wopt.adamw.state_dict(), opt.adamw.state_dict())
    assert wopt.updates == opt.updates == 2 and wopt.notfinite == opt.notfinite == 0


def _equal(a, b, path=""):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]")
    else:
        assert a == b, path
