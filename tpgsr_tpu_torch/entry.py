"""The flagship TPGSR-TSRN eval and train paths (counterparts of
``__graft_entry__._flagship``, __graft_entry__.py:19-40, and of its train
step).

``train_TPGSR-TSRN.sh``: ``--arch tsrn_tl_cascade --STN --mask --use_distill
--gradient --sr_share --stu_iter=1``, LR 16x64x4 -> SR 32x128x4.  Both build
TSRN_TL (scale 2, 128x32, STN, mask, 5 SRBs, hidden 32) with a student CRNN
for the prior and a teacher CRNN, weights drawn from a seeded
``torch.Generator`` on the CPU and then moved to ``device``, so the same
seed gives the same weights on every device.  ``flagship`` serves in eval
mode; ``flagship_train`` returns the train state (the student a copy of the
teacher, Adam) and its train step in fp32 or bf16 (TRAIN.compute_dtype).
"""

from __future__ import annotations

from typing import Tuple

import torch

from tpgsr_tpu_torch.charset import CTC_NUM_CLASSES
from tpgsr_tpu_torch.device import DeviceLike, resolve_device
from tpgsr_tpu_torch.models.crnn import CRNN
from tpgsr_tpu_torch.models.layers import init_torch_defaults_
from tpgsr_tpu_torch.models.tsrn import TSRN_TL
from tpgsr_tpu_torch.train.state import TrainState, create_train_state
from tpgsr_tpu_torch.train.step import EvalModels, EvalStep, TrainStep, make_eval_step, make_train_step

FLAGSHIP_ARGS = {"stu_iter": 1, "sr_share": True, "tpg_share": False, "use_distill": True, "gradient": True,
                 "mask": True}
LR_SIZE = (16, 64)  # h, w; SR and HR are 32x128
TRAIN_WIDTH = 128


def _flagship_models(gen: torch.Generator, dev: torch.device):
    """(TSRN_TL, student CRNN, teacher CRNN), drawn in that order."""
    h, w = LR_SIZE
    sr = TSRN_TL(scale_factor=2, width=2 * w, height=2 * h, stn=True, mask=True,
                 srb_nums=5, hidden_units=32)
    stu = CRNN(nclass=CTC_NUM_CLASSES)
    teacher = CRNN(nclass=CTC_NUM_CLASSES)
    return [init_torch_defaults_(m, gen).to(dev) for m in (sr, stu, teacher)]


def flagship(device: DeviceLike = None, seed: int = 0) -> Tuple[EvalModels, EvalStep]:
    """(models in eval mode on ``device``, their eval step)."""
    dev = resolve_device(device)
    sr, stu, teacher = _flagship_models(torch.Generator().manual_seed(seed), dev)
    eval_models = EvalModels(sr=[sr], stu=[stu], teacher=teacher).eval()
    return eval_models, make_eval_step(FLAGSHIP_ARGS, TRAIN_WIDTH, device=dev)


def flagship_train(device: DeviceLike = None, seed: int = 0,
                   compute_dtype: str = "fp32") -> Tuple[TrainState, TrainStep]:
    """(train state on ``device``, its train step with the models in
    ``compute_dtype``, 'fp32' or 'bf16').  The same draws as ``flagship``;
    the student starts as a copy of the teacher."""
    dev = resolve_device(device)
    sr, _, teacher = _flagship_models(torch.Generator().manual_seed(seed), dev)
    state = create_train_state([sr], teacher, n_stu=1)
    return state, make_train_step(FLAGSHIP_ARGS, TRAIN_WIDTH, device=dev, compute_dtype=compute_dtype)
