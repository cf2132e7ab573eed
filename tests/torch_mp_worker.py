"""One rank of the port's 2-process gloo runs on the CPU (the tests of
``tests/test_torch_parallel.py`` and ``tests/test_torch_multiprocess.py``).

    python tests/torch_mp_worker.py <rank> <world> <port> <job_dir>

Reads the jobs the test wrote to ``<job_dir>/jobs.pt``, a list of dicts with
a ``name`` and a ``kind``, runs each on this rank and saves its result to
``<job_dir>/<name>.<rank>.pt``.  The library jobs (``milnce``, ``step``,
``e2e``, ``loader``) run first, in one process group set up by
``initialize_multihost`` on ``127.0.0.1:<port>``; the CLI jobs (``cli``) then
run one after the other, each CLI setting up its own group through its
``--multihost`` flags on the job's port and leaving it at its end.  Imports
no JAX: the tests hold the results against JAX and against one process.
"""

import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
torch.set_num_threads(1)

from temporalalignnet_torch.parallel import distributed  # noqa: E402
from temporalalignnet_torch.parallel.mesh import local_batch_rows  # noqa: E402


def milnce(job, group):
    """The sharded fused MIL-NCE: this rank's rows and columns, the backward
    of its share of sum(g_v · v_el) + sum(g_t · t_el)."""
    from temporalalignnet_torch.ops.milnce import fused_milnce_elements

    W, r = distributed.world_size(), distributed.rank()
    v, t = job["video"], job["text"]
    R, K = v.shape[1] // W, t.shape[-2] // W
    rows, cols = slice(r * R, (r + 1) * R), slice(r * K, (r + 1) * K)
    v = v[:, rows].clone().requires_grad_()
    t = t[..., cols, :].clone().requires_grad_()
    v_el, t_el = fused_milnce_elements(v, t, job["pos_mask"][rows], job["col_valid"],
                                       job["mask_value"], job["inv_temp"], group=group)
    ((v_el * job["g_v"][:, rows]).sum() + (t_el * job["g_t"]).sum() / W).backward()
    return {"v_el": v_el.detach(), "t_el": t_el.detach(), "dv": v.grad, "dt": t.grad}


def _rows(batch, group):
    lo, hi = local_batch_rows(len(batch["video"] if "video" in batch else batch["clips"]),
                              group)
    return {k: torch.from_numpy(np.ascontiguousarray(v[lo:hi])) for k, v in batch.items()}


def step(job, group):
    """Train steps of the tiny TAN on this rank's rows of the global batch:
    the metrics of each step, the averaged gradients of the last, the params
    (and the twin's) after."""
    from temporalalignnet_torch.core.config import LossConfig, ModelConfig, TrainConfig
    from temporalalignnet_torch.models.net import TANWithText
    from temporalalignnet_torch.train import EMATwin, Optimizer, make_train_step

    model = TANWithText(ModelConfig(**job["model_kw"]), vocab_size=job["vocab_size"])
    model.load_state_dict(job["state_dict"], strict=True)
    tcfg = TrainConfig(**job["train_kw"])
    loss_cfg = LossConfig(**job["loss_kw"])
    twin = EMATwin(model, tcfg) if loss_cfg.model == "cotrain" else None
    opt = Optimizer(model, tcfg, policy=loss_cfg.optim_policy)
    fn = make_train_step(model, opt, tcfg, loss_cfg, twin=twin, group=group)
    batch = _rows(job["batch"], group)
    metrics = [{k: v.item() for k, v in fn(batch).items()} for _ in range(job["steps"])]
    return {"metrics": metrics,
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None},
            "params": model.state_dict(),
            "target": twin.model.state_dict() if twin is not None else None}


def e2e(job, group):
    """One e2e step of S3DWithText on this rank's videos of the global batch."""
    from temporalalignnet_torch.core.config import TrainConfig
    from temporalalignnet_torch.train.end2end import (S3DWithText, make_e2e_optimizer,
                                                      make_e2e_train_step)

    model = S3DWithText(**job["model_kw"]).to(job["state_dict"]["fc.weight"].dtype)
    model.load_state_dict(job["state_dict"], strict=True)
    opt = make_e2e_optimizer(model, TrainConfig(**job["train_kw"]))
    grads = {}
    apply = opt.step

    def spy():  # the averaged gradient the update sees
        grads.update({n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None})
        return apply()

    opt.step = spy
    fn = make_e2e_train_step(model, opt, group=group)
    metrics = {k: v.item() for k, v in fn(_rows(job["batch"], group)).items()}
    return {"metrics": metrics, "grads": grads, "state": model.state_dict()}


def loader(job, group):
    """This rank's rows of the first batches of a feature directory."""
    from temporalalignnet_torch.core.config import DataConfig
    from temporalalignnet_torch.data import HTMFeatureDataset, TrainLoader
    from temporalalignnet_torch.models.word2vec import Word2VecTokenizer

    tok = Word2VecTokenizer(job["vocab"], max_words=job["words"])
    ds = HTMFeatureDataset(job["features"], job["captions"], DataConfig(**job["data_kw"]),
                           "train", tok, cache_videos=0)
    rows = local_batch_rows(job["batch_size"], group)
    ld = TrainLoader(ds, job["batch_size"], seed=job["seed"], num_workers=2, local_rows=rows)
    ld.set_epoch(job["epoch"])
    return {"rows": rows, "batches": [b for b in ld]}


def cli(job, rank, world):
    """A CLI's main with --multihost on the job's port; its return value and
    the files it leaves are the result."""
    import importlib

    main = importlib.import_module(job["module"]).main
    flags = ["--multihost", "--coordinator", f"127.0.0.1:{job['port']}",
             "--num_processes", str(world), "--process_id", str(rank)]
    return {"out": main(job["argv"] + flags)}


LIBRARY = {"milnce": milnce, "step": step, "e2e": e2e, "loader": loader}


def main(argv):
    rank, world, port, job_dir = int(argv[0]), int(argv[1]), int(argv[2]), argv[3]
    jobs = torch.load(os.path.join(job_dir, "jobs.pt"), weights_only=False)
    save = lambda job, out: torch.save(out, os.path.join(job_dir, f"{job['name']}.{rank}.pt"))
    library = [j for j in jobs if j["kind"] in LIBRARY]
    if library:
        distributed.initialize_multihost(f"127.0.0.1:{port}", world, rank, device="cpu")
        group = distributed.default_group()
        for job in library:
            save(job, LIBRARY[job["kind"]](job, group))
        distributed.destroy()
    for job in jobs:
        if job["kind"] == "cli":
            save(job, cli(job, rank, world))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
