"""The TAN's zero-shot eval forward as a corpus job runs it: ``encode_text``
+ ``text_visual_sims`` of ``TANWithText`` (the forward that
``tools/export_eval.py`` exports), bf16 weights, the alignability head on.
One unit is one call on a batch of windows; calls go out back to back, each
call's outputs are copied to pinned host memory without blocking and read
``read_lag`` calls later.

The outputs of ``sample`` of the window's calls, drawn from the seed
uniformly over the whole window (a reservoir sample, taken as the host reads
the outputs), are kept as read; the check holds each against the plain
reference's forward of the same batch in float32.
"""

from __future__ import annotations

import gc
import random
from typing import Dict, List

import torch

from ..reference import tan
from ..reference.common import Precision, draw_weights, exact_matmuls
from ..traffic import make_pool
from ..work import bound_s, mha_fwd_work, tan_flops
from .common import Marks, module_with, nonfinite


class Driver:
    def __init__(self, cfg: dict, wl: dict, seed: int, device: torch.device):
        self.cfg, self.wl, self.seed, self.device = cfg, wl, seed, device
        self.cuda = device.type == "cuda"
        t = wl["traffic"]
        self.B, self.T, self.N, self.W = t["batch"], t["seq_len"], t["sentences"], t["words"]
        self.lag = wl["read_lag"]
        self.bad = torch.zeros((), dtype=torch.long, device=device)
        self.rng = random.Random(seed)
        self.kept: List[tuple] = []

    def setup(self) -> None:
        from temporalalignnet_torch.core.config import ModelConfig
        from temporalalignnet_torch.models.net import TANWithText

        cfg, dev = self.cfg, self.device
        mark = self.marks = Marks()
        mcfg = ModelConfig(
            width=cfg["width"], heads=cfg["heads"], num_encoder_layers=cfg["num_encoder_layers"],
            num_joint_layers=cfg["num_joint_layers"], video_embed_dim=cfg["video_embed_dim"],
            language_model="word2vec", pos_enc="learned", num_pos_embeds=cfg["num_pos_embeds"],
            use_text_pos_enc=False, use_alignability_head=cfg["use_alignability_head"],
            mlp_ratio=cfg["mlp_ratio"], random_pos_start=False)
        weights = draw_weights(tan.param_shapes(cfg), tan.init_rule(cfg), self.seed, dev)
        mark("draw")
        self.init = {n: w.cpu() for n, w in weights.items()}
        mark("host copy")
        model = module_with(lambda: TANWithText(mcfg, vocab_size=cfg["vocab_size"]), weights, dev)
        del weights
        dtype = getattr(torch, cfg["serve_dtype"]) if self.cuda else torch.float32
        self.model = model.to(dtype=dtype).eval()
        mark("module")
        self.pool = make_pool(self.wl["traffic"], cfg["vocab_size"], self.seed, dev)
        for b in self.pool:
            b["input_ids"] = b["input_ids"].long()
        out = self._forward(self.pool[0])
        self.host = [{k: torch.empty(v.shape, dtype=v.dtype, pin_memory=self.cuda)
                      for k, v in out.items()} for _ in range(self.lag + 1)]
        self.events = [torch.cuda.Event() if self.cuda else None for _ in range(self.lag + 1)]
        self.pending: List[int] = []
        self.calls = 0
        self.warm = self.lag + 1
        mark("traffic")
        for _ in range(self.warm):  # every slot of the ring once
            self.dispatch(-1)
        self.sync()
        mark("warm calls")

    def _forward(self, b: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        ids = b["input_ids"]
        with torch.inference_mode():
            return self.model.text_visual_sims(b["video"],
                                               self.model.encode_text(ids, (ids != 0).int()))

    def dispatch(self, i: int) -> None:
        j = self.calls
        self.calls += 1
        slot = j % (self.lag + 1)
        with torch.profiler.record_function("bench.eval_call"):
            out = self._forward(self.pool[j % len(self.pool)])
            for k, v in out.items():
                self.host[slot][k].copy_(v, non_blocking=True)
            self.bad += nonfinite(out["sim"])
            if self.cuda:
                self.events[slot].record()
        self.pending.append(j)
        while len(self.pending) > self.lag:
            self._read(self.pending.pop(0))

    def _read(self, j: int) -> None:
        with torch.profiler.record_function("bench.read_outputs"):
            slot = j % (self.lag + 1)
            if self.cuda:
                self.events[slot].synchronize()
            w = j - self.warm  # the window's call index
            if w < 0:
                return
            at = w if w < self.wl["sample"] else self.rng.randrange(w + 1)
            if at < self.wl["sample"]:
                kept = (j % len(self.pool), {k: v.clone() for k, v in self.host[slot].items()})
                if at < len(self.kept):
                    self.kept[at] = kept
                else:
                    self.kept.append(kept)

    def sync(self) -> None:
        while self.pending:
            self._read(self.pending.pop(0))
        if self.cuda:
            torch.cuda.synchronize()

    def failed(self) -> int:
        return int(self.bad) * self.B

    def release(self) -> None:
        del self.model
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()

    def reference(self, kind: str = "f32", batches=None) -> Dict[int, Dict[str, torch.Tensor]]:
        """The plain forward of each kept call's batch (or of the pool's
        ``batches``), on the host."""
        exact_matmuls()
        prec = Precision(kind)
        p = {n: w.to(self.device) for n, w in self.init.items()}
        out = {}
        with torch.no_grad():
            for idx in sorted({i for i, _ in self.kept} if batches is None else set(batches)):
                b = self.pool[idx]
                r = tan.eval_sims(p, self.cfg, b["video"], b["input_ids"], prec)
                out[idx] = {k: v.float().cpu() for k, v in r.items()}
        return out

    def check(self) -> Dict[str, float]:
        if not self.kept:
            return {"sim_gap": float("inf"), "head_gap": float("inf")}
        return answer_gaps(self.kept, self.reference())

    def flops_per_unit(self) -> float:
        B, T, N = self.B, self.T, self.N
        return tan_flops(self.cfg, B, T, N, self.W, B * T, B * (T + N), train=False)

    def kernel_bounds(self, peaks) -> Dict[str, float]:
        cfg = self.cfg
        H, D = cfg["heads"], cfg["width"]
        B, T, N = self.B, self.T, self.N
        dual = bound_s(*mha_fwd_work(B, H, T, D // H, B * T, elem_bytes=2), peaks)
        joint = bound_s(*mha_fwd_work(B, H, T + N, D // H, B * (T + N), elem_bytes=2), peaks)
        return {"attention": cfg["num_encoder_layers"] * dual + cfg["num_joint_layers"] * joint}


def answer_gaps(kept, ref) -> Dict[str, float]:
    """The widest gap of the kept answers from the reference's: the cosine
    sims absolutely, the head's logits against the reference's rms."""
    sim_gap = head_gap = 0.0
    for idx, out in kept:
        r = ref[idx]
        for k in ("sim", "dual-sim"):
            sim_gap = max(sim_gap, float((out[k].float() - r[k]).abs().max()))
        for k in ("alignability-dual", "alignability-joint"):
            if k in r:
                rms = float(r[k].pow(2).mean().sqrt().clamp(min=1e-12))
                head_gap = max(head_gap, float((out[k].float() - r[k]).abs().max()) / rms)
    return {"sim_gap": sim_gap, "head_gap": head_gap}
