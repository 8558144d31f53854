"""Where the SR zoo's train and eval steps spend the card's time.

    python -m tpgsr_tpu_torch.profile_zoo [train_SRResNet.sh | edsr ...]   # from the root of a checkout; one card

For each train script named (the seven of the zoo by default), builds its
``TextSR`` with the script's flags, batch 48 (random weights from the
YAML's seed, TF32 off) and traces 5 train steps in fp32, 5 in bf16 and 5
eval steps with ``torch.profiler`` (``profile_eval.trace``): the device's
busy share of the traced wall time, its ms a step, kernels a step, and the
kernels that take the most device time.  An arch of ``ARCH_FLAGS`` in place
of a script runs with the flags that table gives it (``--rest`` names them
all).  Prints one JSON object a line; a card is required.
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

from tpgsr_tpu_torch.config import AttrDict, build_arg_parser, load_config, script_argv, tpg_opt
from tpgsr_tpu_torch.device import DeviceLike
from tpgsr_tpu_torch.profile_eval import random_batch, trace
from tpgsr_tpu_torch.train.trainer import TextSR

BATCH = 48
SCRIPTS = ("train_TSRN.sh", "train_SRCNN.sh", "train_TPGSR-SRCNN.sh", "train_SRResNet.sh", "train_TPGSR-SRResNet.sh",
           "train_RDN.sh", "train_TPGSR-RDN.sh")
# the archs no train script runs, with the flags each reads of --STN and
# --mask (and a cascade's --use_distill)
ARCH_FLAGS = {
    "tsrn_tl_wmask": ["--STN", "--mask"],
    "tsrn_tl": ["--STN", "--mask"],
    "textzoom_net": ["--STN"],
    "vdsr": [],
    "vdsr_tl": ["--mask", "--use_distill"],
    "edsr": [],
    "lapsrn": ["--STN"],
    "esrgan": [],
    "esrgan_tl": [],
    "bicubic": ["--mask"],
}


def argv_of(name: str) -> list:
    """The flags of a train script (``*.sh``) or of an arch of ``ARCH_FLAGS``."""
    return script_argv(name) if name.endswith(".sh") else ["--arch", name, *ARCH_FLAGS[name]]


def mission(argv, compute_dtype: str = "fp32", device: DeviceLike = None):
    """(``TextSR``, its state, its eval models) for a script's flags
    ``argv`` on ``device`` (the card unless told otherwise): SR weights drawn
    from the YAML's seed on the CPU, then the teacher or the eval CRNN (no
    ``crnn_pretrained``), so every device gets the same weights."""
    cfg = load_config()
    cfg.TRAIN.compute_dtype = compute_dtype
    cfg.TRAIN.VAL.crnn_pretrained = ""
    m = TextSR(cfg, AttrDict(vars(build_arg_parser().parse_args(argv))), tpg_opt(), device=device)
    state = m.init_state()
    m._build_steps()
    return m, state, m._eval_models(state, m._eval_recognizer())


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("profile_zoo: CUDA is not available; this run needs an NVIDIA card", file=sys.stderr)
        return 1
    scripts = (sys.argv[1:] if argv is None else argv) or SCRIPTS
    if "--rest" in scripts:
        scripts = [s for s in scripts if s != "--rest"] + list(ARCH_FLAGS)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(json.dumps({"card": smi.splitlines()[0], "torch": torch.__version__, "batch": BATCH}), flush=True)
    batch = random_batch(np.random.default_rng(0), BATCH)
    for script in scripts:
        for what in ("fp32", "bf16", "eval"):
            m, state, models = mission(argv_of(script), "bf16" if what == "bf16" else "fp32")
            if what == "eval":
                summary, top = trace(models, m._eval_step, batch)
            else:
                summary, top = trace(state, m._train_step, batch)
            row = {"script": script, "arch": m.arch, "step": what}
            print(json.dumps({**row, **summary}), flush=True)
            for k in top:
                print(json.dumps({**row, **k}), flush=True)
            del m, state, models
    return 0


if __name__ == "__main__":
    sys.exit(main())
