"""TAN Stage-1 training as the train CLI runs it at ``--steps_per_dispatch``
k > 1: ``train_step.make_multi_train_step`` (a CUDA graph of the whole step
replayed per batch, ``GraphedStep``), the fused MIL-NCE where the kernels
are (``--fused_milnce auto``), capturable AdamW, bf16 compute on f32
params.  Each unit is one group of k batches handed over from pinned host
memory, as the CLI's loader hands them.

Set-up draws the weights from the seed, builds the step and drives its
first 1 + 2k steps through the window's own call and feed, in three groups:
step 1 alone (an eager step; its gradient read back from AdamW's first
moment), then k steps (the second eager step, the capture, replays), then
k replays, a group as the window dispatches it (the gradients it fed AdamW
read back from the first moment before and after it; the parameters'
change read after it).  The check follows those steps with the plain
reference from the same weights, batches and position starts.
"""

from __future__ import annotations

import gc
from typing import Dict, List

import torch

from ..reference import tan
from ..reference.common import (AdamW, Precision, draw_weights, exact_matmuls, leaf_norms,
                                training_numbers)
from ..traffic import make_pool
from ..work import bound_s, mha_bwd_work, mha_fwd_work, milnce_work, tan_flops
from .common import (Marks, first_moments, follow, group_gradient, module_with, nonfinite,
                     pinned)


class Driver:
    def __init__(self, cfg: dict, wl: dict, seed: int, device: torch.device):
        self.cfg, self.wl, self.seed, self.device = cfg, wl, seed, device
        self.cuda = device.type == "cuda"
        self.k = wl["steps_per_dispatch"]
        if self.k < 2:
            raise ValueError("tan_train drives grouped steps: steps_per_dispatch >= 2")
        self.check_steps = 1 + 2 * self.k
        t = wl["traffic"]
        self.B, self.T, self.N, self.W = t["batch"], t["seq_len"], t["sentences"], t["words"]
        self.bad = torch.zeros((), dtype=torch.long, device=device)

    # ----------------------------------------------------------- the program

    def setup(self) -> None:
        from temporalalignnet_torch.core.config import LossConfig, ModelConfig, TrainConfig
        from temporalalignnet_torch.models.net import TANWithText
        from temporalalignnet_torch.train.optimizer import Optimizer
        from temporalalignnet_torch.train.train_step import make_multi_train_step

        cfg, wl, dev = self.cfg, self.wl, self.device
        mark = self.marks = Marks()
        fused = self.cuda  # --fused_milnce auto: the kernels wherever they run
        mcfg = ModelConfig(
            width=cfg["width"], heads=cfg["heads"], num_encoder_layers=cfg["num_encoder_layers"],
            num_joint_layers=cfg["num_joint_layers"], video_embed_dim=cfg["video_embed_dim"],
            language_model="word2vec", pos_enc="learned", num_pos_embeds=cfg["num_pos_embeds"],
            use_text_pos_enc=False, use_alignability_head=cfg["use_alignability_head"],
            mlp_ratio=cfg["mlp_ratio"], fused_milnce=fused)
        loss_cfg = LossConfig(model="init", temperature=cfg["temperature"],
                              use_alignability_head=cfg["use_alignability_head"],
                              use_fused_milnce=fused)
        o = wl["optimizer"]
        tcfg = TrainConfig(lr=o["lr"], wd=o["wd"], warmup_iterations=o["warmup_iterations"],
                           total_iterations=o["total_iterations"], seed=self.seed)
        weights = draw_weights(tan.param_shapes(cfg), tan.init_rule(cfg), self.seed, dev)
        mark("draw")
        self.init = {n: w.cpu() for n, w in weights.items()}
        mark("host copy")
        model = module_with(lambda: TANWithText(mcfg, vocab_size=cfg["vocab_size"]), weights, dev)
        del weights
        mark("module")
        opt = Optimizer(model, tcfg)
        compute = getattr(torch, cfg["compute_dtype"]) if self.cuda else torch.float32
        self.multi = make_multi_train_step(model, opt, tcfg, loss_cfg, compute_dtype=compute)
        mark("step")
        pool = make_pool(wl["traffic"], cfg["vocab_size"], self.seed, dev)
        self.pool = [pinned(b) for b in pool] if self.cuda else pool
        del pool
        mark("traffic")
        self.model, self.opt = model, opt
        # the first steps, through the window's own call and feed
        trained = {id(p) for p in opt.params}
        self.names = [n for n, p in model.named_parameters() if id(p) in trained]
        params = dict(model.named_parameters())
        zeros = {n: torch.zeros_like(params[n]) for n in self.names}
        self.next = 0
        losses = self._call(1)
        grad1 = group_gradient(zeros, first_moments(opt.adamw, params, self.names), 1)
        losses += self._call(self.k)
        before = first_moments(opt.adamw, params, self.names)
        losses += self._call(self.k)
        after = first_moments(opt.adamw, params, self.names)
        change = leaf_norms({n: params[n].detach().cpu() - self.init[n] for n in self.names})
        self.prog = {"losses": losses, "grad1": grad1,
                     "group_grad": group_gradient(before, after, self.k), "change": change}
        mark("first steps")

    def _group(self, size: int) -> List[Dict[str, torch.Tensor]]:
        P = len(self.pool)
        batches = [self.pool[(self.next + j) % P] for j in range(size)]
        self.next += size
        return batches

    def _call(self, size: int) -> List[float]:
        return self.multi(self._group(size))["loss"].tolist()

    def dispatch(self, i: int) -> None:
        with torch.profiler.record_function("bench.train_group"):
            out = self.multi(self._group(self.k))
            self.bad += nonfinite(out["loss"])

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def failed(self) -> int:
        return int(self.bad) * self.B

    def release(self) -> None:
        del self.multi, self.model, self.opt
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()

    # --------------------------------------------------------- the reference

    def reference(self, kind: str = "f32", half: bool = False) -> dict:
        """The plain reference's readings of the first steps, its products
        in ``kind`` precision; ``half``: on the first half of each batch."""
        exact_matmuls()
        dev, cfg = self.device, self.cfg
        prec = Precision(kind)
        p = {n: w.to(dev) for n, w in self.init.items()}
        for n in self.names:
            p[n].requires_grad_(True)
        steps = self.check_steps
        gen = torch.Generator().manual_seed(self.seed)
        starts = [tan.draw_pos_starts(gen, self.T, self.N) for _ in range(steps)]
        rows = self.B // 2 if half else self.B
        P = len(self.pool)

        def loss_and_grads(params, i):
            batch = {k: v[:rows].to(dev) for k, v in self.pool[i % P].items()}
            loss = tan.train_loss(params, cfg, batch, starts[i], prec)
            grads = torch.autograd.grad(loss, [params[n] for n in self.names], allow_unused=True)
            return loss.detach(), {n: g for n, g in zip(self.names, grads) if g is not None}

        o = self.wl["optimizer"]
        opt = AdamW(p, o["lr"], o["wd"], o["warmup_iterations"], o["total_iterations"],
                    tan.decays, frozen=[n for n in p if n not in self.names])
        return follow(p, steps, loss_and_grads, opt, self.names, self.k)

    def check(self) -> Dict[str, float]:
        return training_numbers(self.prog, self.reference())

    # -------------------------------------------------------------- the work

    def _valid_keys(self):
        """Valid attention keys summed over a batch's rows, averaged over the
        pool: every video step, then the joint encoder's sentences too."""
        sents = sum(float((~b["text_padding_mask"]).sum()) for b in self.pool) / len(self.pool)
        return self.B * self.T, self.B * self.T + sents

    def flops_per_unit(self) -> float:
        dual, joint = self._valid_keys()
        return self.k * tan_flops(self.cfg, self.B, self.T, self.N, self.W, dual, joint,
                                  train=True, milnce=True)

    def kernel_bounds(self, peaks) -> Dict[str, float]:
        cfg = self.cfg
        H, D = cfg["heads"], cfg["width"]
        dh, S = D // H, cfg["num_joint_layers"]
        dual, joint = self._valid_keys()
        attn = 0.0
        for layers, seq, valid in ((cfg["num_encoder_layers"], self.T, dual),
                                   (cfg["num_joint_layers"], self.T + self.N, joint)):
            for work in (mha_fwd_work, mha_bwd_work):
                attn += layers * bound_s(*work(self.B, H, seq, dh, valid), peaks)
        milnce = 0.0
        for layers, shared in ((cfg["num_encoder_layers"], True), (S, False)):
            for nbytes, flops in milnce_work(layers, self.B * self.T, self.B * self.N, D,
                                             shared).values():
                milnce += bound_s(nbytes, flops, peaks)
        return {"attention": self.k * attn, "milnce": self.k * milnce}
