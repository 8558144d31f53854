"""The train state of the SR zoo (counterpart of tpgsr_tpu/train/state.py).

Plain PyTorch objects in place of the JAX package's functional state:

* ``sr``: the SR models, one per stage or one with ``--sr_share``;
* ``stu``: the trainable student CRNNs, one per stage or one with
  ``--tpg_share``; they start as copies of the teacher, as the reference
  starts every student from the pretrained CRNN (state.py:103-108);
* ``teacher``: the frozen CRNN, in eval mode with ``requires_grad`` off;
* one ``torch.optim.Adam(lr=1e-3, betas=(0.5, 0.999))`` over the SR and
  student parameters (reference interfaces/base.py:447-449, the YAML's
  TRAIN.lr and beta1);

an arch without a prior has no students and no teacher (``stu`` empty,
``teacher`` None; tpgsr_tpu/train/state.py:67-117 with ``n_stu=0``), and
Adam covers its SR model alone; a model without parameters (``bicubic``)
gets an Adam of one empty group, which steps, saves and loads as the JAX
package's Adam of an empty tree does: it changes nothing;
* ``step``, the count of optimizer steps.

``clip_sr_grads`` clips each SR model's gradients at global norm 0.25 and
leaves the students unclipped (super_resolution.py:419-423).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch
import torch.nn as nn

LR = 1e-3
BETA1 = 0.5
SR_CLIP_NORM = 0.25


@dataclass
class TrainState:
    sr: List[nn.Module]
    stu: List[nn.Module]
    teacher: Optional[nn.Module]
    optimizer: torch.optim.Optimizer
    step: int = 0


def create_train_state(sr: Sequence[nn.Module], teacher: Optional[nn.Module], n_stu: int = 1, lr: float = LR,
                       beta1: float = BETA1) -> TrainState:
    """The state for ``sr`` and ``n_stu`` students copied from ``teacher``,
    all on the teacher's device (no teacher and ``n_stu=0`` for an arch
    without a prior); Adam at ``lr`` and ``beta1`` (the YAML's TRAIN.lr and
    beta1)."""
    if teacher is None:
        if n_stu:
            raise ValueError(f"{n_stu} students need a teacher to copy")
        stu = []
    else:
        teacher.eval().requires_grad_(False)
        stu = [copy.deepcopy(teacher).train().requires_grad_(True) for _ in range(n_stu)]
    for m in stu:  # a copy's LSTM weights are no longer one cuDNN block
        for rnn in m.modules():
            if isinstance(rnn, nn.RNNBase):
                rnn.flatten_parameters()
    params = [p for m in (*sr, *stu) for p in m.parameters()]
    # one group, so that an empty list is a group and not an error
    optimizer = torch.optim.Adam([{"params": params}], lr=lr, betas=(beta1, 0.999))
    return TrainState(sr=list(sr), stu=stu, teacher=teacher, optimizer=optimizer)


@torch.no_grad()
def clip_sr_grads(sr: Sequence[nn.Module]) -> None:
    """Scale each SR model's gradients by min(1, 0.25 / (norm + 1e-6)),
    norm the global L2 norm of that model's gradients (state.py:49-58)."""
    for model in sr:
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        if not grads:
            continue
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        scale = torch.clamp(SR_CLIP_NORM / (norm + 1e-6), max=1.0)
        for g in grads:
            g.mul_(scale)


def state_on(state: TrainState, device) -> TrainState:
    """A copy of ``state`` on ``device``: the models copied, Adam rebuilt over
    the copies' parameters with the same settings and state."""
    sr = [copy.deepcopy(m).to(device) for m in state.sr]
    stu = [copy.deepcopy(m).to(device) for m in state.stu]
    teacher = None if state.teacher is None else copy.deepcopy(state.teacher).to(device)
    params = [p for m in (*sr, *stu) for p in m.parameters()]
    optimizer = type(state.optimizer)([{"params": params}], **state.optimizer.defaults)
    optimizer.load_state_dict(state.optimizer.state_dict())
    return TrainState(sr=sr, stu=stu, teacher=teacher, optimizer=optimizer, step=state.step)
