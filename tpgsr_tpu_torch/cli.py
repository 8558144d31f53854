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
"""

from __future__ import annotations

from typing import Optional, Sequence

from tpgsr_tpu_torch.config import AttrDict, build_arg_parser, load_config, tpg_opt
from tpgsr_tpu_torch.device import DeviceLike
from tpgsr_tpu_torch.train.trainer import TextSR


def main(argv: Optional[Sequence[str]] = None, device: DeviceLike = None):
    args = AttrDict(vars(build_arg_parser().parse_args(argv)))
    config = load_config(args["config"])
    mission = TextSR(config, args, tpg_opt(), device=device)
    if args.get("test"):
        return mission.test()
    if args.get("demo"):
        return mission.demo()
    return mission.train()


if __name__ == "__main__":
    main()
