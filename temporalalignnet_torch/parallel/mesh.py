"""The data-parallel mesh and the row contracts (the data-parallel part of
temporalalignnet_tpu/parallel/mesh.py).

Under ``torch.distributed`` the mesh is the process group: one rank per card,
each holding a full copy of the params, and the batch split over the ranks
in contiguous row blocks (the JAX package's ``P('data')`` over the
``data`` axis).  Tensor parallelism (the JAX package's ``model`` axis and
its ``_TP_RULES``) is not here: ``tp > 1`` is refused.

- ``make_mesh(dp, tp)``: checks ``dp`` against the world size;
- ``local_batch_rows(global_batch)``: this rank's ``[lo, hi)`` rows of a
  global batch (mesh.py:73-95), refused unless the world size divides it;
- ``sharded_rows`` / ``fetch_global``: the process-group forms of the JAX
  package's ``put_from_host`` and ``fetch_global`` (mesh.py:115-128,
  147-160) for the evaluators: every rank holds the whole host array, runs
  a forward call on its rows of it (``row_split``: ceil(n / W) rows a
  rank, the last ranks fewer or none), and the rows each rank computed are
  gathered back to every rank, padded for the gather.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from temporalalignnet_torch.parallel import distributed

TP_WORK = "tensor parallelism (ROADMAP Queue A 5)"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``dp`` ranks of ``group`` (None: one process, no group)."""

    dp: int
    group: Any = None


def make_mesh(dp_size: int = -1, tp_size: int = 1, group=None) -> Mesh:
    """The data-parallel mesh over the default process group (or ``group``):
    ``dp_size`` -1 means every rank; any other value must be the world size."""
    if tp_size != 1:
        raise ValueError(f"--tp {tp_size}: tensor parallelism is not in the port; it comes "
                         f"with {TP_WORK}")
    if group is None:
        group = distributed.default_group()
    world = distributed.world_size(group)
    if dp_size not in (-1, world):
        hint = ("" if group is not None else
                "; start one process per card with torchrun (or --multihost with "
                "--coordinator, --num_processes and --process_id in each)")
        raise ValueError(f"--dp {dp_size}: the data-parallel size is the world size, "
                         f"{world}{hint}")
    return Mesh(world, group)


def local_batch_rows(global_batch: int, group=None) -> Tuple[int, int]:
    """[lo, hi): this rank's contiguous rows of a global batch."""
    world, r = distributed.world_size(group), distributed.rank(group)
    if global_batch % world:
        raise ValueError(f"batch {global_batch} does not split over {world} ranks: the "
                         "global batch must be a multiple of the world size")
    per = global_batch // world
    return r * per, (r + 1) * per


def row_split(n: int, group=None) -> Tuple[int, int, int]:
    """(lo, hi, per): this rank's rows [lo, hi) of n split in pieces of
    per = ceil(n / W)."""
    world, r = distributed.world_size(group), distributed.rank(group)
    per = -(-n // world)
    lo = min(r * per, n)
    return lo, min(lo + per, n), per


def fetch_global(x: torch.Tensor, n: int, group=None) -> torch.Tensor:
    """Every rank's rows (``row_split``'s split of n rows), gathered back to
    [n, ...] on every rank, in order; no gradient."""
    if group is None:
        return x
    _, _, per = row_split(n, group)
    pad = x.new_zeros((per - x.shape[0],) + tuple(x.shape[1:]))
    return distributed.all_gather(torch.cat([x.detach(), pad]), 0, group)[:n]


def sharded_rows(n: int, run: Callable[[int, int], tuple], group=None) -> tuple:
    """``run(lo, hi)`` (a tuple of [hi - lo, ...] tensors) over this rank's
    rows of n, each result gathered back to [n, ...] on every rank: the
    forward calls of a sharded evaluation.  A rank without rows runs the
    last row and keeps none of it (JAX pads a call by repeating the last)."""
    if group is None:
        return run(0, n)
    lo, hi, _ = row_split(n, group)
    out = run(lo, hi) if hi > lo else tuple(x[:0] for x in run(n - 1, n))
    return tuple(fetch_global(x.contiguous(), n, group) for x in out)
