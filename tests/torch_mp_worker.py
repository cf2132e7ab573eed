"""One rank of the port's multi-process gloo runs on the CPU (the tests of
``tests/test_torch_parallel.py``, ``tests/test_torch_multiprocess.py`` and
``tests/test_torch_tensor_parallel.py``).

    python tests/torch_mp_worker.py <rank> <world> <port> <job_dir>

Reads the jobs the test wrote to ``<job_dir>/jobs.pt``, a list of dicts with
a ``name`` and a ``kind``, runs each on this rank and saves its result to
``<job_dir>/<name>.<rank>.pt``.  The library jobs (``milnce``, ``step``,
``e2e``, ``loader``) run first, in one process group set up by
``initialize_multihost`` on ``127.0.0.1:<port>`` (``tp_step`` and ``tp_shards``
make their (dp, tp) mesh in it); the CLI jobs (``cli``) then
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


def tp_step(job, group):
    """Train steps of the tiny TAN on a (dp, tp) mesh of the world: this
    rank's shard of the encoder blocks, the rows of its dp index.  The
    metrics of each step, the gathered gradients of the last, params, twin
    and optimizer state after, and this rank's own replicated params.  With
    ``planted`` the row-parallel biases are added on every rank, before the
    reduce (the fault ``row_parallel_linear`` avoids)."""
    import torch.nn.functional as F

    from temporalalignnet_torch.core.config import LossConfig, ModelConfig, TrainConfig
    from temporalalignnet_torch.models.net import TANWithText
    from temporalalignnet_torch.parallel import tensor as tp_ops
    from temporalalignnet_torch.parallel.mesh import make_mesh
    from temporalalignnet_torch.train import EMATwin, Optimizer, make_train_step

    mesh = make_mesh(job["dp"], job["tp"])
    model = TANWithText(ModelConfig(**job["model_kw"]), vocab_size=job["vocab_size"])
    model.load_state_dict(job["state_dict"], strict=True)
    tp_ops.shard_model_(model, mesh.tp_group)
    tcfg = TrainConfig(**job["train_kw"])
    loss_cfg = LossConfig(**job["loss_kw"])
    twin = EMATwin(model, tcfg) if loss_cfg.model == "cotrain" else None
    opt = Optimizer(model, tcfg, policy=loss_cfg.optim_policy)
    fn = make_train_step(model, opt, tcfg, loss_cfg, twin=twin, group=mesh.dp_group)
    batch = _rows(job["batch"], mesh.dp_group)
    row = tp_ops.row_parallel_linear
    if job.get("planted"):
        tp_ops.row_parallel_linear = lambda x, w, b, g: tp_ops.reduce_from_tp(
            F.linear(x, w, b), g)
    try:
        metrics = [{k: v.item() for k, v in fn(batch).items()} for _ in range(job["steps"])]
    finally:
        tp_ops.row_parallel_linear = row
    gather = lambda sd: tp_ops.tp_gather_state_dict(sd, mesh.tp_group)
    return {"metrics": metrics,
            "grads": gather({n: p.grad.clone() for n, p in model.named_parameters()
                             if p.grad is not None}),
            "params": gather(model.state_dict()),
            "target": gather(twin.model.state_dict()) if twin is not None else None,
            "optimizer": opt.state_dict(),
            "replicated": {n: v for n, v in model.state_dict().items()
                           if tp_ops.tp_dim(n) is None},
            "sharded": sorted(n for n, p in model.named_parameters() if tp_ops.is_sharded(p)),
            "shapes": {n: tuple(p.shape) for n, p in model.named_parameters()}}


def tp_shards(job, group):
    """The round trips of a full state_dict and of a full optimizer state
    through this rank's shard and the gather over its tp ranks."""
    from temporalalignnet_torch.core.config import ModelConfig, TrainConfig
    from temporalalignnet_torch.models.net import TANWithText
    from temporalalignnet_torch.parallel import tensor as tp_ops
    from temporalalignnet_torch.parallel.mesh import make_mesh
    from temporalalignnet_torch.train import Optimizer

    mesh = make_mesh(job["dp"], job["tp"])
    sd = job["state_dict"]
    r = distributed.rank(mesh.tp_group)
    back = tp_ops.tp_gather_state_dict(tp_ops.tp_shard_state_dict(sd, r, mesh.tp), mesh.tp_group)
    model = TANWithText(ModelConfig(**job["model_kw"]), vocab_size=job["vocab_size"])
    model.load_state_dict(sd, strict=True)
    tp_ops.shard_model_(model, mesh.tp_group)
    opt = None
    if job["optimizer"] is not None:
        opt = Optimizer(model, TrainConfig(**job["train_kw"]))
        opt.load_state_dict(job["optimizer"])  # full -> this rank's shard
    return {"state_dict": back, "optimizer": opt.state_dict() if opt is not None else None,
            "rows": _rows(job["batch"], mesh.dp_group)["video"].shape[0],
            "dp_rank": distributed.rank(mesh.dp_group), "tp_rank": r}


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


LIBRARY = {"milnce": milnce, "step": step, "e2e": e2e, "loader": loader, "tp_step": tp_step,
           "tp_shards": tp_shards}


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
