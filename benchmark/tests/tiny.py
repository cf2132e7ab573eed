"""Tiny shapes of the benchmark's cells for CPU tests (the port's own CPU
paths in float32: the word2vec tower keeps its fixed widths)."""

from __future__ import annotations

import time

import torch

from benchmark import harness

TAN = {"width": 64, "heads": 4, "num_encoder_layers": 2, "num_joint_layers": 2,
       "video_embed_dim": 48, "vocab_size": 101, "num_pos_embeds": 128}
WINDOWS = {"batch": 4, "seq_len": 16, "sentences": 4, "min_sentences": 2, "words": 8,
           "feature_dim": 48, "edge": 2, "pool": 6, "projection_rows": 16}

OVERRIDES = {
    "tan.stage1_graph": (TAN, WINDOWS, {"steps_per_dispatch": 2}),
    "tan.infer_b512": (TAN, dict(WINDOWS, batch=6, min_sentences=4), {}),
}


def workload(cell: str) -> dict:
    cfg, traffic, extra = OVERRIDES[cell]
    wl = harness.workload_of(cell)
    return {**wl, **extra, "traffic": {**wl["traffic"], **traffic}}


def config(cell: str) -> dict:
    man = harness.manifest()
    entry = harness.find(man["workloads"], cell, "cell")
    return {**harness.config_of(man, entry), **OVERRIDES[cell][0]}


def run(cell: str, seed: int = 5, seconds: float = 0.3) -> dict:
    torch.set_num_threads(2)
    return harness.run_cell(cell, seed, seconds, False, time.time(), device="cpu",
                            config_override=OVERRIDES[cell][0], workload_override=workload(cell))


def driver(cell: str, seed: int = 5):
    torch.set_num_threads(2)
    wl = workload(cell)
    return harness.driver_class(wl["driver"])(config(cell), wl, seed, torch.device("cpu"))
