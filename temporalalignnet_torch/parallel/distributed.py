"""Process groups, the master gate and the collectives of data parallelism
(counterpart of temporalalignnet_tpu/parallel/distributed.py; reference
end2end/main_nce.py:140-158).

``initialize_multihost`` joins this process to the others, one process per
card, reading the same sources as the JAX package in the same order: the
explicit arguments, then ``SLURM_NTASKS`` / ``SLURM_PROCID``, then torchrun's
``WORLD_SIZE`` / ``RANK`` / ``LOCAL_RANK`` with ``MASTER_ADDR`` /
``MASTER_PORT`` (the PyTorch launcher's counterpart of JAX's pod
autodetection).  The backend follows the device: NCCL for ``cuda``, gloo for
the CPU.  The one other choice is gloo for CUDA tensors, taken only by an
explicit ``backend="gloo"`` (two ranks on one card, which NCCL refuses); no
CLI flag selects it.

The collectives are autograd Functions whose backward is the forward's
adjoint, so that a rank's backward yields the gradient of the sum of every
rank's loss with respect to what this rank computed:

- ``all_gather(x, dim)``: the ranks' pieces concatenated in rank order; its
  backward sum-reduce-scatters the cotangent back to each rank's piece;
- ``all_reduce_sum(x)``: its backward is again a sum over the ranks (every
  rank's output depends on every rank's input);
- ``all_reduce_max(x)``: statistics only, returned without a gradient;
- ``reduce_scatter(x, dim)``: ``all_gather``'s backward, for the
  hand-written backward of ``ops/milnce.py``.

``average_(x)`` averages a tensor over the ranks in place (the gradients),
no gradient: NCCL's AVG, which launches its kernel in a world of one too
(NCCL copies, or skips, an in-place SUM over one rank), and gloo's SUM
divided by the world size (gloo has no AVG).

``group=None`` means no process group: each function returns its input.
gloo takes CUDA tensors for every collective used here (``all_gather_into_
tensor``, ``reduce_scatter_tensor`` and ``all_reduce`` ran on CUDA tensors
under gloo on an H100 with torch 2.11), so no helper stages a tensor
through host memory; the backend alone fixes a helper's path, and none
changes its path on an error.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(minutes=10)


def _from_environment(num_processes, process_id, coordinator_address):
    """(num_processes, process_id, coordinator, local_rank) from the
    arguments, then SLURM, then torchrun's variables."""
    local = None
    if num_processes is None and "SLURM_NTASKS" in os.environ:
        num_processes = int(os.environ["SLURM_NTASKS"])
        process_id = int(os.environ.get("SLURM_PROCID", 0))
        local = os.environ.get("SLURM_LOCALID")
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ.get("RANK", 0))
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', 29500)}"
    local = os.environ.get("LOCAL_RANK", local)
    return num_processes, process_id, coordinator_address, None if local is None else int(local)


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device: str = "cuda",
) -> bool:
    """Set up the default process group; True if one was set up.

    Without a coordinator and without more than one process from the
    arguments or the environment it sets up nothing and returns False (one
    process, as JAX's ``initialize_multihost`` outside a pod).  A coordinator
    with ``num_processes=1`` sets up a group of one, whose collectives run.
    On ``cuda`` the process is bound to ``cuda:LOCAL_RANK`` (SLURM_LOCALID, or
    its rank modulo the cards here), unless ``device`` names a card."""
    if process_id is not None and num_processes is None:
        raise ValueError("--process_id needs --num_processes (jax.distributed.initialize "
                         "takes them together)")
    num_processes, process_id, coordinator_address, local = _from_environment(
        num_processes, process_id, coordinator_address)
    if num_processes is None and coordinator_address is None:
        return False
    num_processes = 1 if num_processes is None else num_processes
    process_id = 0 if process_id is None else process_id
    if coordinator_address is None:
        raise ValueError(f"{num_processes} processes need a coordinator: --coordinator "
                         "host:port, or MASTER_ADDR and MASTER_PORT (torchrun sets them)")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside [0, {num_processes})")
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    elif backend != "gloo" or device.type != "cuda":
        raise ValueError(f"backend {backend!r} on {device.type}: the backend follows the "
                         "device (NCCL for cuda, gloo for the CPU); only gloo for cuda is a "
                         "choice")
    kwargs = {}
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_multihost on cuda: no CUDA device here")
        if backend == "nccl" and not dist.is_nccl_available():
            raise RuntimeError("initialize_multihost on cuda: this PyTorch has no NCCL")
        index = device.index
        if index is None:
            index = (local if local is not None else process_id) % torch.cuda.device_count()
        torch.cuda.set_device(index)
        if backend == "nccl":  # binds the communicator to the card at once
            kwargs["device_id"] = torch.device("cuda", index)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id, timeout=TIMEOUT,
                            **kwargs)
    return True


def process_device(device: str) -> torch.device:
    """The device of this process: ``cuda`` becomes the card
    ``initialize_multihost`` bound it to."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and dist.is_initialized():
        return torch.device("cuda", torch.cuda.current_device())
    return device


def default_group():
    """The default process group, or None without one."""
    return dist.group.WORLD if dist.is_initialized() else None


def rank(group=None) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


def world_size(group=None) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def is_master() -> bool:
    """The gate of side effects (reference main_nce.py:406-407)."""
    return rank() == 0


def master_print(*args, **kwargs) -> None:
    """Print on rank 0 only (main_nce.py:154-158)."""
    if is_master():
        print(*args, **kwargs)


def barrier() -> None:
    """Wait for every rank; nothing without a process group."""
    if dist.is_initialized():
        dist.barrier()


def destroy() -> None:
    """Leave the default process group, where there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def add_multihost_flags(p) -> None:
    """--multihost and its coordinates (JAX train/cli.py:113-119)."""
    p.add_argument("--multihost", action="store_true",
                   help="join the other processes (one per card) in a process group")
    p.add_argument("--coordinator", default=None,
                   help="host:port of process 0 for --multihost (else SLURM's or "
                        "torchrun's MASTER_ADDR / MASTER_PORT)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)


def start_multihost(args) -> bool:
    """``initialize_multihost`` from the flags where ``--multihost`` is given
    (the coordinates are refused without it); True if a process group was
    set up, which the caller destroys at its end."""
    if not args.multihost:
        given = [f for f in ("coordinator", "num_processes", "process_id")
                 if getattr(args, f) is not None]
        if given:
            raise SystemExit(f"--{given[0]} goes with --multihost")
        return False
    try:
        return initialize_multihost(args.coordinator, args.num_processes, args.process_id,
                                    device=args.device)
    except (ValueError, RuntimeError) as e:
        raise SystemExit(f"--multihost: {e}") from None


# ------------------------------------------------------------- collectives


def _gather0(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' [n, ...] pieces as [W·n, ...], in rank order."""
    x = x.contiguous()
    out = x.new_empty((dist.get_world_size(group) * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def _reduce_scatter0(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the ranks of [W·n, ...], this rank's [n, ...] rows."""
    x = x.contiguous()
    out = x.new_empty((x.shape[0] // dist.get_world_size(group),) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM, group=group)
    return out


def _all_reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    x = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, op=op, group=group)
    return x


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather0(x.movedim(dim, 0), group).movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter0(g.movedim(ctx.dim, 0), ctx.group).movedim(0, ctx.dim), None, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, dist.ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, dist.ReduceOp.SUM, ctx.group), None


def all_gather(x: torch.Tensor, dim: int = 0, group=None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order (equal
    shapes); the gradient sum-reduce-scatters back to the pieces."""
    if group is None:
        return x
    return _AllGather.apply(x, dim % x.dim(), group)


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over the ranks; differentiable, its adjoint is the same sum."""
    if group is None:
        return x
    return _AllReduceSum.apply(x, group)


def reduce_scatter(x: torch.Tensor, dim: int = 0, group=None) -> torch.Tensor:
    """The sum over the ranks of ``x``, this rank's block along ``dim`` (the
    backward of ``all_gather``, for a hand-written backward); no gradient."""
    if group is None:
        return x
    return _reduce_scatter0(x.movedim(dim, 0), group).movedim(0, dim)


def average_(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` averaged over the ranks, in place; no gradient."""
    if group is None:
        return x
    if dist.get_backend(group) == "nccl":
        dist.all_reduce(x, op=dist.ReduceOp.AVG, group=group)
    else:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        x /= dist.get_world_size(group)
    return x


def all_reduce_max(x: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise max over the ranks, without a gradient."""
    if group is None:
        return x.detach()
    return _all_reduce(x.detach(), dist.ReduceOp.MAX, group)
