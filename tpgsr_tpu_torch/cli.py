"""``python -m tpgsr_tpu_torch.cli``: main.py's command line on the port
(counterpart of tpgsr_tpu/cli.py; flag surface main.py:22-52).

    python -m tpgsr_tpu_torch.cli --arch tsrn_tl_cascade --batch_size 48 --STN --mask \\
        --use_distill --gradient --sr_share --stu_iter 1 --config my.yaml

runs on the card.  ``main(argv, device="cpu")`` runs on the CPU: the flag
surface is the reference's, so the device is an argument of the entry
point, not a flag.  ``main`` returns what the run returns: ``test()``'s
metric dict, ``demo()``'s predictions, ``train()``'s state, or
``--go_test``'s metric dicts.  The "OPT" text-prior generator's options
(``--tpg OPT``) are main.py's (``config.tpg_opt``).

Data parallelism (TRAIN.n_devices; 0, the packaged value, means every
visible card, as the JAX package's ``data_mesh``): above one rank ``main``
starts one process a card (``parallel.spawn``, NCCL; gloo with
``device="cpu"``), each running ``run`` on its card, and returns rank 0's
result with its tensors on the CPU.  Started by torchrun
(``torchrun --nproc_per_node k -m tpgsr_tpu_torch.cli ...``), each process
joins torchrun's group instead, as ``jax.distributed.initialize`` joins the
JAX package's hosts.  ``--demo`` runs in one process (rank 0 under
torchrun), as the JAX package's demo does.
"""

from __future__ import annotations

import os
import sys
from typing import Optional, Sequence

from tpgsr_tpu_torch.config import AttrDict, build_arg_parser, load_config, tpg_opt
from tpgsr_tpu_torch.device import DeviceLike
from tpgsr_tpu_torch.parallel import join_env, n_ranks, shutdown, spawn, under_torchrun
from tpgsr_tpu_torch.train.state import TrainState, state_on
from tpgsr_tpu_torch.train.trainer import TextSR


def _parse(argv: Optional[Sequence[str]]) -> AttrDict:
    return AttrDict(vars(build_arg_parser().parse_args(argv)))


def run(argv: Optional[Sequence[str]] = None, device: DeviceLike = None):
    """One process's run of ``argv``: ``TextSR`` on ``device`` (in a group,
    this rank's card), then ``--test``, ``--demo`` or ``train()``."""
    args = _parse(argv)
    mission = TextSR(load_config(args["config"]), args, tpg_opt(), device=device)
    if args.get("test"):
        return mission.test()
    if args.get("demo"):
        return mission.demo()
    return mission.train()


def run_rank(argv: Optional[Sequence[str]] = None, device: DeviceLike = None):
    """``run`` on one spawned rank, its result on the CPU (a train state
    copied there), to cross back to the launching process."""
    result = run(argv, device=device)
    return state_on(result, "cpu") if isinstance(result, TrainState) else result


def main(argv: Optional[Sequence[str]] = None, device: DeviceLike = None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parse(argv)
    if args.get("demo"):
        if under_torchrun() and int(os.environ["RANK"]) != 0:
            return None
        return run(argv, device=device)
    if under_torchrun():
        dev = join_env(device)
        try:
            return run(argv, device=dev)
        finally:
            shutdown()
    world = n_ranks(load_config(args["config"]).TRAIN.get("n_devices", 0), device)
    if world > 1:
        return spawn(world, run_rank, argv, device=device)
    return run(argv, device=device)


if __name__ == "__main__":
    main()
