"""The (dp, tp) mesh and the row contracts (counterpart of
temporalalignnet_tpu/parallel/mesh.py).

Under ``torch.distributed`` the mesh is the process group: one rank per
card, ``dp`` data-parallel replicas of ``tp`` tensor-parallel ranks each.
Rank r is dp index r // tp and tp index r % tp, JAX's row-major reshape of
the devices to ``(dp, tp)`` (mesh.py:60 there).  The batch is split over
the dp index in contiguous row blocks (the JAX package's ``P('data')``), so
the tp ranks of one replica share their rows; the encoder blocks are
sharded over the tp ranks (``parallel/tensor.py``, JAX's ``_TP_RULES`` on
the ``model`` axis).

- ``make_mesh(dp, tp)``: checks ``dp · tp`` against the world size and,
  with tp > 1, makes the dp groups (the ranks of one tp index: the loss's
  global batch, the gradient average) and the tp groups (the ranks of one
  dp index); with tp = 1 the dp group is the whole group;
- ``local_batch_rows(global_batch, dp_group)``: this rank's ``[lo, hi)``
  rows of a global batch (mesh.py:73-95), by its dp index, refused unless
  the dp size divides it;
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

@dataclasses.dataclass(frozen=True)
class Mesh:
    """``dp`` replicas over ``dp_group`` (None: one process, no group), each
    of ``tp`` ranks over ``tp_group`` (None: tp = 1)."""

    dp: int
    dp_group: Any = None
    tp: int = 1
    tp_group: Any = None


def make_mesh(dp_size: int = -1, tp_size: int = 1, group=None) -> Mesh:
    """The mesh over the default process group (or ``group``): ``dp_size``
    -1 means world / tp; the world must be dp · tp.  Every rank makes every
    subgroup, in one order (``dist.new_group`` is collective)."""
    if tp_size < 1:
        raise ValueError(f"--tp {tp_size}: must be at least 1")
    if group is None:
        group = distributed.default_group()
    world = distributed.world_size(group)
    hint = ("" if group is not None else
            "; start one process per card with torchrun (or --multihost with "
            "--coordinator, --num_processes and --process_id in each)")
    if world % tp_size:
        raise ValueError(f"--tp {tp_size} does not divide the {world} processes{hint}")
    if dp_size not in (-1, world // tp_size):
        raise ValueError(f"--dp {dp_size}: the data-parallel size is the world size over "
                         f"--tp, {world} / {tp_size} = {world // tp_size}{hint}")
    if tp_size == 1:
        return Mesh(world, group)
    import torch.distributed as dist

    ranks = dist.get_process_group_ranks(group)
    dp_size, me = world // tp_size, distributed.rank(group)
    tp_groups = [dist.new_group([ranks[i * tp_size + j] for j in range(tp_size)])
                 for i in range(dp_size)]
    dp_groups = [dist.new_group([ranks[i * tp_size + j] for i in range(dp_size)])
                 for j in range(tp_size)]
    return Mesh(dp_size, dp_groups[me % tp_size], tp_size, tp_groups[me // tp_size])


def local_batch_rows(global_batch: int, group=None) -> Tuple[int, int]:
    """[lo, hi): this rank's contiguous rows of a global batch, by its rank in
    ``group`` (the dp group: its dp index)."""
    world, r = distributed.world_size(group), distributed.rank(group)
    if global_batch % world:
        raise ValueError(f"batch {global_batch} does not split over {world} ranks: the "
                         "global batch must be a multiple of the data-parallel size")
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
