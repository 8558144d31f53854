"""The loader: a ``torch.utils.data.DataLoader`` over a dataset and a collate
(counterpart of tpgsr_tpu/data/loader.py:20-144, whose thread and process
pools it replaces; the reference ran torch's, interfaces/base.py:250-255).

``EpochBatchSampler`` gives the JAX loader's batches (``_batch_indices``,
loader.py:92-107): epoch e (from 1) shuffles ``arange(n)`` with
``np.random.default_rng(seed + e)``, then cuts batches in order, dropping a
short last one with ``drop_last``.  ``make_loader`` runs it in a ``Loader``:

* ``workers`` > 0 starts that many worker processes that persist across
  epochs, so each keeps its copy of the dataset's decode cache.  They start
  by forkserver, never fork (a fork of a process with live threads can
  deadlock), so a script that iterates a loader with workers guards its body
  with ``if __name__ == "__main__":``; the collate must pickle
  (``functools.partial`` of a module function).
* A worker's batch crosses to the main process as numpy arrays in the
  pipe's bytes.  A tensor would cross as a shared-memory file whose
  descriptor torch passes over a new authenticated socket connection each,
  which cost more than the collate itself (``PERF.md`` §6, PR 7).  Each
  array travels in a ``HostArray``, which torch's pin-memory thread turns
  into a pinned tensor when the steps' device is the card, so that neither
  the receipt nor the pinning holds up the thread that drives the card,
  and the steps' ``non_blocking`` copies overlap the card's work.  Without
  pinning the ``Loader`` makes them plain tensors.
* It has its own ``torch.Generator``, so worker seeds do not come from the
  global torch RNG.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Iterator, List

import numpy as np
import torch
from torch.utils.data import DataLoader, Sampler

from tpgsr_tpu_torch.device import DeviceLike, resolve_device


class EpochBatchSampler(Sampler):
    """Lists of dataset indices, one per batch, reshuffled each epoch."""

    def __init__(self, n: int, batch_size: int, shuffle: bool = True, drop_last: bool = True, seed: int = 0):
        self.n = n
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0

    def __len__(self) -> int:
        if self.drop_last:
            return self.n // self.batch_size
        return -(-self.n // self.batch_size)

    def __iter__(self) -> Iterator[List[int]]:
        # a generator: the epoch advances at its first batch, so an iterator
        # made and dropped unread does not count (torch's multi-process
        # loader makes two at its first epoch)
        self.epoch += 1
        idx = np.arange(self.n)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        end = (self.n // self.batch_size) * self.batch_size if self.drop_last else self.n
        for s in range(0, end, self.batch_size):
            yield idx[s : s + self.batch_size].tolist()


class HostArray:
    """A collated numpy array on its way to the steps: it pickles as the
    array, and torch's pin-memory thread calls ``pin_memory``."""

    __slots__ = ("arr",)

    def __init__(self, arr: np.ndarray):
        self.arr = arr

    def pin_memory(self, device=None) -> torch.Tensor:
        return torch.from_numpy(self.arr).pin_memory()


def _host_arrays(collate_fn: Callable, items) -> Dict:
    return {k: HostArray(v) if isinstance(v, np.ndarray) else v for k, v in collate_fn(items).items()}


class Loader(DataLoader):
    """A ``DataLoader`` over a collate that gives dicts of numpy arrays (and
    lists); it yields them with each array a tensor, pinned by torch's
    pin-memory thread when ``pin_memory``."""

    def __iter__(self) -> Iterator[Dict]:
        for batch in super().__iter__():
            yield {k: torch.from_numpy(v.arr) if isinstance(v, HostArray) else v for k, v in batch.items()}


def make_loader(dataset, batch_size: int, collate_fn: Callable, shuffle: bool = True, drop_last: bool = True,
                seed: int = 0, workers: int = 0, device: DeviceLike = None) -> Loader:
    """A ``Loader`` over ``dataset`` in the JAX loader's batch order, with
    ``workers`` persistent worker processes (0: load in the caller), pinned
    batches when ``device`` is the card (the default)."""
    dev = resolve_device(device)
    sampler = EpochBatchSampler(len(dataset), batch_size, shuffle, drop_last, seed)
    pool = {"multiprocessing_context": "forkserver", "persistent_workers": True} if workers > 0 else {}
    return Loader(dataset, batch_sampler=sampler, collate_fn=functools.partial(_host_arrays, collate_fn),
                  num_workers=workers, pin_memory=dev.type == "cuda", generator=torch.Generator().manual_seed(seed),
                  **pool)
