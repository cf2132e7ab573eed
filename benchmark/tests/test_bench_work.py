"""The work counts: hand counts at one shape, the model FLOPs against
FlopCounterMode on the plain reference, and every share at most 100 %
given a kernel time at its bound."""

import math

import pytest
import torch

from benchmark import harness
from benchmark.reference import tan
from benchmark.reference.common import Precision
from benchmark.trace import Slice
from benchmark.work import (bound_s, card_peaks, mha_bwd_work, mha_fwd_work, milnce_work,
                            tan_flops)

from . import tiny

PEAKS = card_peaks("NVIDIA H100 80GB HBM3")


def test_peaks_are_the_data_sheets():
    assert PEAKS["hbm_bytes_per_s"] == 3.35e12 and PEAKS["bf16_flops"] == 989e12
    assert card_peaks("NVIDIA H100 PCIe")["bf16_flops"] == 756e12
    with pytest.raises(ValueError):
        card_peaks("NVIDIA A100")


def test_attention_and_milnce_counts_by_hand():
    # [64, 8, 80, 64] bf16, 64·64 video keys + 700 sentences valid
    valid = 64 * 64 + 700
    assert mha_fwd_work(64, 8, 80, 64, valid) == (
        (2 * 64 * 8 * 80 * 64 + 2 * valid * 8 * 64) * 2 + 64 * 80, 4 * 8 * 80 * 64 * valid)
    assert mha_bwd_work(64, 8, 80, 64, valid) == (
        (5 * 64 * 8 * 80 * 64 + 2 * valid * 8 * 64) * 2 + 64 * 80, 10 * 8 * 80 * 64 * valid)
    w = milnce_work(6, 4096, 1024, 512, shared_text=True)
    feat = (6 * 4096 * 512 + 1024 * 512) * 2 + 4096 * 1024 + 1024
    lse = (2 * 6 * 4096 + 2 * 6 * 1024) * 4
    assert w["milnce_fwd"] == (feat + lse, 2 * 6 * 4096 * 1024 * 512)
    assert w["milnce_dv"] == (feat + 2 * lse + 6 * 4096 * 512 * 2, 4 * 6 * 4096 * 1024 * 512)
    assert w["milnce_dt"] == (feat + 2 * lse + 1024 * 512 * 2, 4 * 6 * 4096 * 1024 * 512)
    # the bound of the PR 18 row: 0.02606 ms, operations
    assert math.isclose(bound_s(*w["milnce_fwd"], PEAKS) * 1e3, 0.02606, rel_tol=1e-3)


def count_flops(fn) -> int:
    """The FLOPs ``torch.utils.flop_counter.FlopCounterMode`` counts in
    ``fn()`` (products, forward and backward)."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return counter.get_total_flops()


def _ref_inputs(cfg, B, T, N, W):
    shapes = tan.param_shapes(cfg)
    p = {n: torch.zeros(s, device="meta", requires_grad=tan.trainable(n))
         for n, s in shapes.items()}
    batch = {"video": torch.zeros(B, T, cfg["video_embed_dim"], device="meta"),
             "input_ids": torch.ones(B, N, W, dtype=torch.long, device="meta"),
             "video_padding_mask": torch.zeros(B, T, dtype=torch.bool, device="meta"),
             "text_padding_mask": torch.zeros(B, N, dtype=torch.bool, device="meta"),
             "start": torch.zeros(B, N, device="meta"), "end": torch.ones(B, N, device="meta"),
             "abs_text_pos": torch.zeros(B, N, 2, device="meta")}
    return p, batch


@pytest.mark.parametrize("train", [False, True])
def test_tan_flops_equal_flop_counter_on_the_reference(train):
    cfg = tiny.config("tan.stage1_graph")
    B, T, N, W = 3, 16, 4, 8
    p, batch = _ref_inputs(cfg, B, T, N, W)
    f32 = Precision("f32")
    if train:
        counted = count_flops(lambda: tan.train_loss(p, cfg, batch, (0, 0, 0), f32).backward())
    else:
        counted = count_flops(lambda: tan.eval_sims(p, cfg, batch["video"], batch["input_ids"], f32))
    assert tan_flops(cfg, B, T, N, W, B * T, B * (T + N), train=train, milnce=train) == counted


def _run_with_times(cell, seconds_per_family):
    drv = tiny.driver(cell)
    drv.pool = [{"text_padding_mask": torch.zeros(drv.B, drv.N, dtype=torch.bool)}]
    bounds = drv.kernel_bounds(PEAKS)
    ops, t = [], 0.0
    for family, prefix in (("attention", "void mha_fwd_wgmma_kernel<1>"),
                           ("milnce", "milnce_fwd_wgmma_kernel")):
        if family in bounds:
            dt = bounds[family] * seconds_per_family
            ops.append((prefix, t, t + dt))
            t += dt
    sl = Slice(units=1, span_s=t, device_ops=ops)
    return harness.Run(t, 1, PEAKS, drv, sl)  # a window as busy as the slice


@pytest.mark.parametrize("cell", ["tan.stage1_graph", "tan.infer_b512"])
def test_shares_are_at_most_100_at_the_bound(cell):
    names = [m["name"] for m in harness.cell_metrics(harness.manifest(), cell,
                                                      harness.workload_of(cell)["rate"]["metric"]
                                                      )["per_layer"]]
    at_bound = _run_with_times(cell, 1.0)
    slower = _run_with_times(cell, 2.5)
    shares = [n for n in names if "roofline" in n]
    assert shares
    for n in shares:
        v = harness.reader(n)(at_bound)
        assert v is not None and v <= 100.0 + 1e-9 and math.isclose(v, 100.0, rel_tol=1e-9)
        assert math.isclose(harness.reader(n)(slower), 40.0, rel_tol=1e-9)
    for n in names:
        if "idle" in n:
            assert 0.0 <= harness.reader(n)(at_bound) < 1e-9
