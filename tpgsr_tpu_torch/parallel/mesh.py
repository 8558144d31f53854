"""Data parallelism over one process a card (counterpart of
tpgsr_tpu/parallel/mesh.py, tpgsr_tpu/train/checkpoint.py:30
``is_primary_host`` and ``jax.distributed.initialize``).

The JAX package runs one jitted step over a batch-sharded global array:
every reduction of the step covers the global batch and XLA inserts the
collectives.  The port runs one process a card, PyTorch's idiom, and makes
each of those reductions global by hand through ``torch.distributed``:

* ``init``/``shutdown`` join and leave a process group: NCCL on the card,
  gloo on the CPU.  ``backend="gloo"`` on the card is the one-card mode
  (several ranks on one card, gloo moving CUDA tensors); nothing falls back
  from NCCL to gloo.  Collectives time out after ``TIMEOUT_S``, so a dead
  rank ends the run instead of hanging it.
* ``spawn`` starts one process a rank (the ``spawn`` start method), each
  joined through a ``file://`` rendezvous; ``under_torchrun``/``join_env``
  join the group torchrun describes in the environment instead.
* ``n_ranks`` is ``data_mesh``'s rule for TRAIN.n_devices (0: every visible
  card, :25-31); ``rank_and_world`` is ``process_shard_info``; the train
  loader takes each rank's contiguous slice of every global batch
  (``data.loader.EpochBatchSampler``); ``pad_to_multiple`` (:62) and
  ``local_rows`` give eval each rank's slice of a padded batch
  (``host_local_batch_to_global``, :125) and ``gather_rows`` puts the
  per-sample outputs back together on every rank (``gather_global_to_host``,
  :144).
* ``replicate`` gives every rank rank 0's state (``shard_params``, :57),
  with the trainable models' BatchNorm over the global batch
  (``parallel.batchnorm``); ``average_gradients`` is the gradient all-reduce
  XLA derives from the shardings, one flat buffer.

Outside a process group every function acts as on one rank of a world of
one.
"""

from __future__ import annotations

import datetime
import os
import pathlib
import pickle
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, Iterable, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from tpgsr_tpu_torch.device import DeviceLike, resolve_device
from tpgsr_tpu_torch.parallel.batchnorm import globalize_batchnorm

# seconds a collective (and the rendezvous) waits for the other ranks
TIMEOUT_S = 600
# the environment torchrun gives each process it starts
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def rank_and_world() -> Tuple[int, int]:
    """(this process's rank, the number of ranks); (0, 1) outside a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_primary() -> bool:
    """True on the rank that writes files: rank 0, or a process alone."""
    return rank_and_world()[0] == 0


def n_ranks(n_devices: int, device: DeviceLike = None) -> int:
    """The ranks TRAIN.n_devices asks for: 0 means one a visible card (one on
    the CPU), a positive value that many.  On the card a value above the
    cards there are raises ``ValueError`` (the JAX package would take the
    cards there are, fewer than asked)."""
    dev = resolve_device(device)
    n = int(n_devices or 0)
    if dev.type != "cuda":
        return max(n, 1)
    cards = torch.cuda.device_count()
    if n > cards:
        raise ValueError(f"TRAIN.n_devices {n}: only {cards} card(s) visible")
    return n if n > 0 else cards


def rank_device(device: DeviceLike = None, local_rank: Optional[int] = None) -> torch.device:
    """The device of this rank: a card named without an index (or ``None``)
    becomes ``cuda:<local rank>`` (torchrun's LOCAL_RANK, else the rank in
    the group); a named card or the CPU stays as it is."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", rank_and_world()[0]))
    return torch.device("cuda", local_rank)


def init(rank: int, world: int, init_method: str, device: torch.device, backend: Optional[str] = None) -> None:
    """Join the group of ``world`` ranks as ``rank`` on ``device``: NCCL on
    the card, gloo on the CPU, or ``backend`` ('gloo' on the card is the
    one-card mode).  NCCL takes no CPU device."""
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"NCCL needs a card, got {device}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S),
                            device_id=device if backend == "nccl" else None)


def under_torchrun() -> bool:
    """True where torchrun started this process (its environment is set)."""
    return all(k in os.environ for k in TORCHRUN_ENV)


def join_env(device: DeviceLike = None, backend: Optional[str] = None) -> torch.device:
    """Join the group torchrun's environment describes; returns this rank's
    device (``rank_device``)."""
    resolve_device(device)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = rank_device(device, int(os.environ.get("LOCAL_RANK", rank)))
    init(rank, world, "env://", dev, backend)
    return dev


def shutdown() -> None:
    """Leave the process group, if this process is in one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def barrier() -> None:
    if rank_and_world()[1] > 1:
        dist.barrier()


# ------------------------------------------------------------------ batches
def pad_to_multiple(arr, multiple: int):
    """``arr`` (numpy or a tensor) with its last row repeated along axis 0 up
    to a multiple of ``multiple`` (tpgsr_tpu/parallel/mesh.py:62)."""
    n = arr.shape[0]
    pad = -n % multiple
    if not pad:
        return arr
    if isinstance(arr, torch.Tensor):
        return torch.cat([arr, arr[-1:].expand(pad, *arr.shape[1:])])
    return np.concatenate([arr, np.repeat(arr[-1:], pad, axis=0)])


def local_rows(arr, rank: int, world: int):
    """This rank's contiguous slice of ``arr`` padded to a multiple of
    ``world`` (the slice ``host_local_batch_to_global`` assembles, :125)."""
    padded = pad_to_multiple(arr, world)
    per = padded.shape[0] // world
    return padded[rank * per: (rank + 1) * per]


def gather_rows(t: torch.Tensor, n: int, axis: int = 0) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``axis`` in rank order, cut to
    its first ``n`` rows: the per-sample outputs of a batch whose rows the
    ranks split by ``local_rows`` (``gather_global_to_host``, :144)."""
    world = rank_and_world()[1]
    if world == 1:
        return t.narrow(axis, 0, n)
    parts = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(parts, t.contiguous())
    return torch.cat(parts, axis).narrow(axis, 0, n)


# -------------------------------------------------------------------- state
def _broadcast_(tensors: Iterable[torch.Tensor], device: torch.device) -> None:
    """Rank 0's values into ``tensors`` in place: one broadcast a dtype, of
    the tensors flattened on ``device`` (a collective costs the same for a
    scalar as for a model's worth of bytes here)."""
    by_dtype: Dict[torch.dtype, list] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1).to(device) for t in group])
        dist.broadcast(flat, 0)
        offset = 0
        with torch.no_grad():
            for t in group:
                t.copy_(flat[offset: offset + t.numel()].view_as(t))
                offset += t.numel()


def replicate(trainable: Sequence[torch.nn.Module], frozen: Sequence[Optional[torch.nn.Module]] = (),
              optimizer: Optional[torch.optim.Optimizer] = None) -> None:
    """Make this rank's state rank 0's (``shard_params``, :57): every
    BatchNorm of the ``trainable`` models over the global batch
    (``batchnorm.globalize_batchnorm``), then the parameters and buffers of
    all the models and the optimizer's state broadcast from rank 0.  Does
    nothing outside a group of several ranks."""
    if rank_and_world()[1] == 1:
        return
    models = [m for m in (*trainable, *frozen) if m is not None]
    for m in trainable:
        globalize_batchnorm(m)
    device = next(t for m in models for t in (*m.parameters(), *m.buffers())).device
    _broadcast_((t for m in models for t in (*m.parameters(), *m.buffers())), device)
    if optimizer is not None:
        keys = [sorted(optimizer.state[p]) for g in optimizer.param_groups for p in g["params"]]
        mine = torch.tensor([len(k) for k in keys], device=device)
        first = mine.clone()
        dist.broadcast(first, 0)
        if not torch.equal(mine, first):
            raise RuntimeError("the ranks' optimizers hold different state; resume every rank from one save")
        _broadcast_((optimizer.state[p][k] for g in optimizer.param_groups for p in g["params"]
                     for k in sorted(optimizer.state[p]) if isinstance(optimizer.state[p][k], torch.Tensor)),
                    device)


def average_gradients(params: Iterable[torch.nn.Parameter], average: bool = True) -> None:
    """The gradient all-reduce of a data-parallel step, as one flat buffer:
    each gradient becomes the mean over the ranks (``average``; the sum
    without it, for a loss that sums over the batch).  Parameters without a
    gradient are skipped, as on every rank alike."""
    world = rank_and_world()[1]
    grads = [p.grad for p in params if p.grad is not None]
    if world == 1 or not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    if average:
        flat.div_(world)
    offset = 0
    for g in grads:
        g.copy_(flat[offset: offset + g.numel()].view_as(g))
        offset += g.numel()


def reduce_metrics(metrics: Mapping[str, torch.Tensor], average: bool = True) -> Dict[str, torch.Tensor]:
    """Scalar metrics summed over the ranks, divided by the world with
    ``average``: a batch mean of each rank's equal share becomes the global
    batch's mean.  One all-reduce."""
    world = rank_and_world()[1]
    if world == 1:
        return dict(metrics)
    keys = sorted(metrics)
    flat = torch.stack([metrics[k].detach().float() for k in keys])
    dist.all_reduce(flat)
    if average:
        flat.div_(world)
    return dict(zip(keys, flat.unbind()))


# ----------------------------------------------------------------- launcher
def _rank_main(rank: int, world: int, init_method: str, device: str, backend: Optional[str], payload: bytes,
               tmp: str, blocked: Sequence[str]) -> None:
    """A spawned rank: join the group, run ``fn(*args, device=...)`` of the
    pickled ``(fn, args)``, leave the group; rank 0 pickles its result to
    ``<tmp>/result.pkl``, a failed rank its traceback to ``<tmp>/rank<r>.err``."""
    for name in blocked:  # optional imports the parent blocked stay blocked
        sys.modules[name] = None
    try:
        fn, args = pickle.loads(payload)
        dev = rank_device(device, rank)
        init(rank, world, init_method, dev, backend)
        try:
            value = fn(*args, device=dev)
        finally:
            shutdown()
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    if rank == 0:
        with open(os.path.join(tmp, "result.pkl"), "wb") as f:
            pickle.dump(value, f)


def spawn(world: int, fn: Callable, *args, device: DeviceLike = None, backend: Optional[str] = None,
          timeout: Optional[float] = None) -> Any:
    """Run ``fn(*args, device=<the rank's device>)`` on ``world`` ranks, one
    process each (``torch.multiprocessing.start_processes``, the ``spawn``
    start method), in one group; returns rank 0's result, which must pickle
    (tensors on the CPU).  Arguments and result cross as plain pickles: no
    tensor of the caller is moved to shared memory, and the result outlives
    the rank that made it.

    ``device``: ``None`` or 'cuda' puts rank r on ``cuda:r`` (NCCL); a named
    card puts every rank on it (the one-card mode, with ``backend="gloo"``);
    'cpu' runs them on the CPU (gloo).  On the card the kernels are built
    here first, so that the ranks do not compile them each.  If a rank
    fails, or the group outlives ``timeout`` seconds, the others are
    stopped and ``RuntimeError`` (``TimeoutError``) is raised with the
    failed ranks' tracebacks: the rank torch reports first is often one
    that lost its peer, not the one that failed first."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        from tpgsr_tpu_torch.ops import _build

        _build.build(_build.all_sources())
    blocked = [name for name, mod in sys.modules.items() if mod is None]
    payload = pickle.dumps((fn, args))
    deadline = None if timeout is None else time.monotonic() + timeout
    with tempfile.TemporaryDirectory(prefix="tpgsr-rendezvous-") as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        context = mp.start_processes(_rank_main, (world, init_method, str(dev), backend, payload, tmp, blocked),
                                     nprocs=world, join=False, start_method="spawn")
        try:
            while not context.join(timeout=1.0):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"the {world} ranks did not finish in {timeout} s")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            errs = [(r, pathlib.Path(tmp, f"rank{r}.err")) for r in range(world)]
            failed = [f"rank {r} of {world} failed:\n{p.read_text()}" for r, p in errs if p.exists()]
            raise RuntimeError("\n".join(failed) or str(e)) from e
        finally:
            for p in context.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        with open(os.path.join(tmp, "result.pkl"), "rb") as f:
            return pickle.load(f)
