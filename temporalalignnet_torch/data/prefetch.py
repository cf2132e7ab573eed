"""Host input pipeline: threaded sample building and background batch
prefetch (counterpart of temporalalignnet_tpu/data/prefetch.py; reference
utils/data_utils.py:9-93, ``DataLoaderBG``).

- a thread pool builds the fixed-shape numpy samples (file IO and numpy
  release the GIL);
- a producer thread stacks batches into a bounded queue, as torch tensors,
  in pinned memory with ``pin_memory=True`` so the copy to the card can run
  asynchronously (``tensor.to(device, non_blocking=True)``).

Determinism: the epoch order is a shuffle by ``RandomState((seed, epoch))``
and sample i of the epoch draws from ``RandomState((seed, epoch, i))``, as in
the JAX package, so both give bit-equal batches.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np
import torch

from temporalalignnet_torch.data.htm import stack_samples


class TrainLoader:
    """Iterable over fixed-shape batches of ``dataset.sample(i, rng)`` dicts,
    as dicts of torch tensors."""

    def __init__(self, dataset, batch_size: int, seed: int = 0, num_workers: int = 4,
                 prefetch: int = 2, pin_memory: bool = False):
        if len(dataset) == 0:
            raise ValueError("empty dataset")
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.prefetch = prefetch
        self.pin_memory = pin_memory
        self.epoch = 0
        self.start_batch = 0
        self._pool = ThreadPoolExecutor(num_workers)  # persistent across epochs

    def set_epoch(self, epoch: int, start_batch: int = 0) -> None:
        """The next iteration yields batches [start_batch, len) of this
        epoch's order (a mid-epoch resume)."""
        self.epoch = epoch
        self.start_batch = start_batch

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size  # the last partial batch is dropped

    def epoch_order(self) -> np.ndarray:
        order = np.arange(len(self.dataset))
        np.random.RandomState((self.seed, self.epoch)).shuffle(order)
        return order

    def _to_torch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        out = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
        return {k: v.pin_memory() for k, v in out.items()} if self.pin_memory else out

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        order = self.epoch_order()
        nb, epoch = len(self), self.epoch
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def build_sample(flat_idx: int):
            rng = np.random.RandomState((self.seed, epoch, int(flat_idx)))
            return self.dataset.sample(int(order[flat_idx]), rng)

        def producer():
            try:
                for b in range(self.start_batch, nb):
                    if stop.is_set():
                        return
                    lo = b * self.batch_size
                    samples = list(self._pool.map(build_sample, range(lo, lo + self.batch_size)))
                    q.put(self._to_torch(stack_samples(samples)))
                q.put(None)
            except BaseException as e:  # surface worker errors to the consumer
                q.put(e)

        threading.Thread(target=producer, daemon=True).start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            while not q.empty():  # unblock the producer's put()
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
