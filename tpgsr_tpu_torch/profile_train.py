"""Where the flagship train step's time goes on one NVIDIA card.

    python -m tpgsr_tpu_torch.profile_train       # from the root of a checkout; needs one card

Builds the flagship train state (``entry.flagship_train``) at batch 48, fp32
with TF32 off, and:

* times each part of the train step with CUDA events (median of 20 after
  warmup): the teacher on HR (no grad), the student's forward and backward
  (distillation loss), TSRN_TL's forward and backward (STN, TPS, 5 SRBs,
  image loss), the SR clip and Adam's step, and the whole step;
* traces 5 train steps with ``torch.profiler`` and prints the device's busy
  share of the traced wall time, the kernels that take the most device time,
  and K1's forward (``bigru_seq_kernel``) and backward
  (``bigru_seq_backward``) kernels wherever they rank.

The parts run the same modules as the step, so each part's own optimizer
step and BatchNorm updates move the state: the times are what they measure,
the parameters after them are not a training run.  Prints one JSON object a
line; a card is required.
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

from tpgsr_tpu_torch.entry import flagship_train
from tpgsr_tpu_torch.losses import image_loss, semantic_loss
from tpgsr_tpu_torch.profile_eval import median_ms, random_batch, trace
from tpgsr_tpu_torch.train.priors import logits_to_prior, parse_crnn_data, prior_dropout_first_quarter
from tpgsr_tpu_torch.train.state import clip_sr_grads
from tpgsr_tpu_torch.train.step import crnn_width

BATCH = 48
K1_KERNELS = ("bigru_seq_kernel", "bigru_seq_backward")


def parts(state, step, batch, dev):
    """Median ms of each part of the train step, on tensors already on the card."""
    cw = crnn_width(128)
    lr = torch.from_numpy(batch["lr"]).to(dev)
    hr = torch.from_numpy(batch["hr"]).to(dev)
    sr_model, stu, teacher = state.sr[0], state.stu[0], state.teacher
    lr_nchw = lr.permute(0, 3, 1, 2)

    def teacher_prior():
        with torch.no_grad():
            return torch.softmax(teacher(parse_crnn_data(hr, cw).permute(0, 3, 1, 2)), -1)

    target = teacher_prior()

    def student():
        logits = stu(parse_crnn_data(lr, cw).permute(0, 3, 1, 2))
        (semantic_loss(torch.softmax(logits, -1), target) * 100.0).backward()

    with torch.no_grad():
        logits = stu(parse_crnn_data(lr, cw).permute(0, 3, 1, 2))
        prior = prior_dropout_first_quarter(logits_to_prior(logits)).permute(0, 3, 1, 2)

    def tsrn_tl():
        sr = sr_model(lr_nchw, prior).permute(0, 2, 3, 1)
        (image_loss(sr, hr, gradient=True) * 100.0).backward()

    def optimizer():
        clip_sr_grads(state.sr)
        state.optimizer.step()

    return {
        "teacher_ms": median_ms(teacher_prior),
        "student_fwd_bwd_ms": median_ms(student),
        "tsrn_tl_fwd_bwd_ms": median_ms(tsrn_tl),
        "clip_and_adam_ms": median_ms(optimizer),
        "step_ms": median_ms(lambda: step(state, batch)),
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_train: CUDA is not available; this run needs an NVIDIA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(json.dumps({"card": smi.splitlines()[0], "torch": torch.__version__, "batch": BATCH, "tf32": False}),
          flush=True)
    dev = torch.device("cuda")
    state, step = flagship_train(device=dev, seed=0)
    batch = random_batch(np.random.default_rng(0), BATCH)
    row = parts(state, step, batch, dev)
    row["images_per_s"] = BATCH / row["step_ms"] * 1e3
    summary, top = trace(state, step, batch, extra=K1_KERNELS)
    print(json.dumps({**row, **summary}), flush=True)
    for k in top:
        print(json.dumps(k), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
