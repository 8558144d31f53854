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
* With ``workers`` > 1 the workers draw the JAX loader's random streams
  (tpgsr_tpu/data/loader.py:216-230, :286-321): batch i of an epoch is read
  by worker ``i % workers`` (torch's ``DataLoader`` deals the batches to its
  workers in turn from worker 0 every epoch; each worker checks that it got
  its own), and a worker reseeds its copy of the dataset when the first
  batch of a new epoch e reaches it, with ``seed + e * 100003 + worker``
  (``reseed_dataset``; e from 1).  The epoch and the batch's place travel
  with its indices (``EpochBatch``).  With one worker or none the dataset's
  own streams run on, as before.
* ``shard_index``/``shard_count`` (a rank and the world of a data-parallel
  run) give each rank its contiguous slice of every global batch, after the
  shuffle that all ranks share (tpgsr_tpu/data/loader.py:53-104).
"""

from __future__ import annotations

import functools
import random
from typing import Callable, Dict, Iterator, List

import numpy as np
import torch
from torch.utils.data import DataLoader, Dataset, Sampler, get_worker_info

from tpgsr_tpu_torch.device import DeviceLike, resolve_device


# a worker's seed in epoch e: seed + e * EPOCH_SEED_STRIDE + worker; the stride
# exceeds any worker count, so (e, w + 1) never replays (e + 1, w)
EPOCH_SEED_STRIDE = 100003
# the seed stride between the parts of a ConcatDataset
CONCAT_SEED_STRIDE = 1000003


class EpochBatch(list):
    """A batch's dataset indices, with its ``epoch`` (from 1) and its
    ``index`` in the epoch."""

    def __init__(self, indices, epoch: int, index: int):
        super().__init__(indices)
        self.epoch = epoch
        self.index = index


class EpochBatchSampler(Sampler):
    """Lists of dataset indices, one per batch, reshuffled each epoch; with
    ``shard_count`` > 1, the ``shard_index``-th contiguous slice of each
    global batch of ``batch_size``."""

    def __init__(self, n: int, batch_size: int, shuffle: bool = True, drop_last: bool = True, seed: int = 0,
                 shard_index: int = 0, shard_count: int = 1):
        if shard_count > 1:
            if batch_size % shard_count:
                raise ValueError(f"global batch_size {batch_size} must divide evenly over {shard_count} processes")
            if not drop_last:
                raise ValueError("shard_count > 1 requires drop_last=True (a partial final batch cannot be split "
                                 "evenly across hosts; eval paths shard inside evaluate() instead)")
        self.n = n
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.shard_index = shard_index
        self.shard_count = max(1, shard_count)
        self.epoch = 0

    def __len__(self) -> int:
        if self.drop_last:
            return self.n // self.batch_size
        return -(-self.n // self.batch_size)

    def __iter__(self) -> Iterator[EpochBatch]:
        # a generator: the epoch advances at its first batch, so an iterator
        # made and dropped unread does not count (torch's multi-process
        # loader makes two at its first epoch)
        self.epoch += 1
        idx = np.arange(self.n)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        end = (self.n // self.batch_size) * self.batch_size if self.drop_last else self.n
        local = self.batch_size // self.shard_count
        for i, s in enumerate(range(0, end, self.batch_size)):
            b = idx[s: s + self.batch_size]
            if self.shard_count > 1:
                b = b[self.shard_index * local: (self.shard_index + 1) * local]
            yield EpochBatch(b.tolist(), self.epoch, i)


def reseed_dataset(ds, seed: int) -> None:
    """Give a worker's copy of ``ds`` its own streams, by the JAX loader's
    rule (tpgsr_tpu/data/loader.py:286-306): ``reseed(seed)`` where the
    dataset has it, else each part of a ``ConcatDataset`` k from ``seed +
    1000003 (k + 1)``, else a ``random.Random`` or numpy ``Generator`` held as
    ``rng`` drawn anew from ``seed`` (``MixedLMDB``'s coin)."""
    if hasattr(ds, "reseed"):
        ds.reseed(seed)
    elif hasattr(ds, "datasets"):
        for k, part in enumerate(ds.datasets):
            reseed_dataset(part, seed + CONCAT_SEED_STRIDE * (k + 1))
    elif isinstance(getattr(ds, "rng", None), random.Random):
        ds.rng = random.Random(seed)
    elif isinstance(getattr(ds, "rng", None), np.random.Generator):
        ds.rng = np.random.default_rng(seed)


class EpochSeeded(Dataset):
    """``dataset`` read by a loader's workers (more than one), each copy
    reseeded when a new epoch's first batch reaches its worker
    (``reseed_dataset`` with ``seed + epoch * 100003 + worker``)."""

    def __init__(self, dataset, seed: int):
        self.dataset = dataset
        self.seed = seed
        self._epoch = None

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, i):
        return self.dataset[i]

    def __getitems__(self, batch: EpochBatch) -> list:
        info = get_worker_info()
        if batch.index % info.num_workers != info.id:
            raise RuntimeError(f"batch {batch.index} reached worker {info.id} of {info.num_workers}: the loader no "
                               "longer deals batches to its workers in turn from worker 0")
        if batch.epoch != self._epoch:
            reseed_dataset(self.dataset, self.seed + batch.epoch * EPOCH_SEED_STRIDE + info.id)
            self._epoch = batch.epoch
        return [self.dataset[int(j)] for j in batch]


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
                seed: int = 0, workers: int = 0, device: DeviceLike = None, shard_index: int = 0,
                shard_count: int = 1) -> Loader:
    """A ``Loader`` over ``dataset`` in the JAX loader's batch order, with
    ``workers`` persistent worker processes (0: load in the caller), pinned
    batches when ``device`` is the card (the default); rank ``shard_index``
    of ``shard_count`` reads its slice of each global batch of
    ``batch_size``."""
    dev = resolve_device(device)
    sampler = EpochBatchSampler(len(dataset), batch_size, shuffle, drop_last, seed, shard_index, shard_count)
    pool = {"multiprocessing_context": "forkserver", "persistent_workers": True} if workers > 0 else {}
    if workers > 1:
        dataset = EpochSeeded(dataset, seed)
    return Loader(dataset, batch_sampler=sampler, collate_fn=functools.partial(_host_arrays, collate_fn),
                  num_workers=workers, pin_memory=dev.type == "cuda", generator=torch.Generator().manual_seed(seed),
                  **pool)
