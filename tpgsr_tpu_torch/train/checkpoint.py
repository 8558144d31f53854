"""Checkpoints in the original TPGSR's ``.pth`` layout (counterpart of
tpgsr_tpu/train/checkpoint.py: ``save_checkpoint`` :75, ``restore_checkpoint``
:121; reference interfaces/base.py:402-424,546-585).

Files, with the JAX package's names and rules for when each is written:

* ``checkpoint_<i>.pth`` at every save, ``model_best_<i>.pth`` on a new
  best: ``{"state_dict_G", "info", "best_history_res", "best_model_info",
  "param_num", "converge"}`` for SR stage i, as the original saves them;
* ``recognizer_<i>.pth`` at every save, ``recognizer_best_<i>.pth`` on a new
  best: student i's plain ``state_dict`` (none for an arch without a prior,
  which has no students);
* ``opt_state.pth``: Adam's ``state_dict`` (the original drops it; the JAX
  package keeps it, so a resume continues exactly);
* ``info.json``: the info dict with ``step``, ``param_num`` and
  ``converge``.

The ``state_dict`` keys are the original's, so the JAX package's
``restore_reference_checkpoint`` reads these files unchanged.  In a
data-parallel run rank 0 alone writes them (every rank holds the same
state; tpgsr_tpu/train/checkpoint.py:93) and the other ranks wait at a
barrier until it has, so that a ``--resume`` reads whole files.
``load_recognizer_state_dict`` reads the original's pretrained recognizer
files (``aster_demo.pth.tar``, ``moran_demo.pth``).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from tpgsr_tpu_torch.parallel import barrier, is_primary
from tpgsr_tpu_torch.train.state import TrainState
from tpgsr_tpu_torch.utils.cost import param_count

INFO_KEYS = ("arch", "iters", "epochs", "batch_size", "voc_type", "up_scale_factor")


def save_checkpoint(ckpt_dir: str, state: TrainState, info: Dict[str, Any], is_best: bool,
                    converge_list: Optional[list] = None) -> None:
    """Write the periodic files, and the best ones when ``is_best``.

    ``info`` is the trainer's dict: ``INFO_KEYS`` plus ``best_history_res``
    and ``best_model_info``.  Rank 0 writes; every rank returns after it
    has."""
    if is_primary():
        _write(ckpt_dir, state, info, is_best, converge_list)
    barrier()


def _write(ckpt_dir: str, state: TrainState, info: Dict[str, Any], is_best: bool,
           converge_list: Optional[list]) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    converge = list(converge_list or [])
    for i, sr in enumerate(state.sr):
        save_dict = {
            "state_dict_G": sr.state_dict(),
            "info": {k: info[k] for k in INFO_KEYS},
            "best_history_res": info["best_history_res"],
            "best_model_info": info["best_model_info"],
            "param_num": param_count(sr),
            "converge": converge,
        }
        torch.save(save_dict, os.path.join(ckpt_dir, f"checkpoint_{i}.pth"))
        if is_best:
            torch.save(save_dict, os.path.join(ckpt_dir, f"model_best_{i}.pth"))
    for i, stu in enumerate(state.stu):
        sd = stu.state_dict()
        torch.save(sd, os.path.join(ckpt_dir, f"recognizer_{i}.pth"))
        if is_best:
            torch.save(sd, os.path.join(ckpt_dir, f"recognizer_best_{i}.pth"))
    torch.save(state.optimizer.state_dict(), os.path.join(ckpt_dir, "opt_state.pth"))
    meta = dict(info)
    meta["step"] = int(state.step)
    meta["param_num"] = [param_count(sr) for sr in state.sr]
    if converge_list is not None:
        meta["converge"] = converge
    with open(os.path.join(ckpt_dir, "info.json"), "w") as f:
        json.dump(meta, f, indent=2, default=str)


def _load(path: str) -> Any:
    return torch.load(path, map_location="cpu", weights_only=True)


def _numpy_globals() -> list:
    """numpy's scalar and array reconstructors and dtypes, under the names
    of numpy 2 and of numpy 1 (``numpy.core``), for ``torch.load``'s
    weights-only unpickler: building a number or an array runs no other
    code."""
    try:
        from numpy._core.multiarray import _reconstruct, scalar
    except ImportError:  # numpy 1
        from numpy.core.multiarray import _reconstruct, scalar
    dtypes = [type(np.dtype(t)) for t in (np.float16, np.float32, np.float64, np.int32, np.int64, np.bool_)]
    return [scalar, _reconstruct, (scalar, "numpy.core.multiarray.scalar"),
            (_reconstruct, "numpy.core.multiarray._reconstruct"), np.ndarray, np.dtype, *dtypes]


def load_recognizer_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of an original recognizer file, keyed as its model's
    ``state_dict``: the ``state_dict`` entry when the file is a dict that
    has one (``aster_demo.pth.tar`` keeps it beside its epoch and best
    score), ``module.`` prefixes of ``DataParallel`` stripped, entries that
    are not tensors dropped (as tpgsr_tpu/interop/torch_import.py:29-45
    reads it).  The file is read with ``weights_only=True``: plain Python
    values, tensors, and numpy scalars and arrays (allowed here: a score
    computed with numpy pickles as one) load; a file that needs any other
    class raises ``pickle.UnpicklingError`` and is not executed."""
    with torch.serialization.safe_globals(_numpy_globals()):
        obj = _load(path)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k.replace("module.", ""): v for k, v in obj.items() if isinstance(v, torch.Tensor)}


def load_generator_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The SR model's ``state_dict`` of a generator file in the original's
    layout (``model_best_0.pth``: its ``state_dict_G``)."""
    return _load(path)["state_dict_G"]


def restore_checkpoint(ckpt_dir_or_file: str, state: TrainState, prefer_best: bool = False) -> TrainState:
    """Load a checkpoint into ``state`` in place; returns it.

    A directory: with ``prefer_best`` False (resuming training), the
    periodic ``checkpoint_<i>`` / ``recognizer_<i>`` files, which every save
    writes together with ``opt_state.pth`` and ``info.json``'s ``step``, all
    three restored; the best files where a periodic one is missing.  With
    ``prefer_best`` (``--go_test``, ``--test``, ``--demo``) the best files
    first, and neither Adam's state nor the step, which belong to the latest
    save.  A file: its ``state_dict_G`` into every SR stage, as the original
    loads ``--resume`` for each stage."""
    if not os.path.isdir(ckpt_dir_or_file):
        sd = load_generator_state_dict(ckpt_dir_or_file)
        for sr in state.sr:
            sr.load_state_dict(sd)
        return state
    d = ckpt_dir_or_file

    def pick(best: str, periodic: str) -> Optional[str]:
        order = (best, periodic) if prefer_best else (periodic, best)
        return next((os.path.join(d, f) for f in order if os.path.exists(os.path.join(d, f))), None)

    for i, sr in enumerate(state.sr):
        path = pick(f"model_best_{i}.pth", f"checkpoint_{i}.pth")
        if path is not None:
            sr.load_state_dict(_load(path)["state_dict_G"])
    for i, stu in enumerate(state.stu):
        path = pick(f"recognizer_best_{i}.pth", f"recognizer_{i}.pth")
        if path is not None:
            stu.load_state_dict(_load(path))
    if not prefer_best:
        opt_path = os.path.join(d, "opt_state.pth")
        if os.path.exists(opt_path):
            state.optimizer.load_state_dict(_load(opt_path))
        info_path = os.path.join(d, "info.json")
        if os.path.exists(info_path):
            with open(info_path) as f:
                step = json.load(f).get("step")
            if step is not None:
                state.step = int(step)
    return state
