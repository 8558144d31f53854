"""Where the flagship train step's time goes on one NVIDIA card.

    python -m tpgsr_tpu_torch.profile_train [--compute_dtype fp32|bf16]   # needs one card

Builds the flagship train state (``entry.flagship_train``) at batch 48, in
TRAIN.compute_dtype's precision (fp32 unless told; bf16 runs the models
under autocast, as the train step does), with TF32 off, and:

* times each part of the train step with CUDA events (median of 20 after
  warmup): the teacher on HR (no grad), the student's forward and backward
  (distillation loss), TSRN_TL's forward and backward (STN, TPS, 5 SRBs,
  image loss), the SR clip and Adam's step, and the whole step;
* traces 5 train steps with ``torch.profiler`` and prints the device's busy
  share of the traced wall time, the kernels that take the most device time,
  and K1's forward and backward kernels wherever they rank
  (``bigru_seq_kernel`` and ``bigru_seq_backward`` in fp32,
  ``bigru_seq_bf16_kernel`` and ``bigru_seq_bwd_bf16_kernel`` in bf16).

The parts run the same modules as the step, so each part's own optimizer
step and BatchNorm updates move the state: the times are what they measure,
the parameters after them are not a training run.  Prints one JSON object a
line; a card is required.
"""

from __future__ import annotations

import argparse
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
from tpgsr_tpu_torch.train.step import COMPUTE_DTYPES, compute_context, crnn_width

BATCH = 48
K1_KERNELS = ("bigru_seq_kernel", "bigru_seq_backward", "bigru_seq_bf16_kernel", "bigru_seq_bwd_bf16_kernel")


def parts(state, step, batch, dev, dtype=torch.float32):
    """Median ms of each part of the train step, on tensors already on the
    card, with the models in ``dtype`` and the casts of the step."""
    cw = crnn_width(128)
    lr = torch.from_numpy(batch["lr"]).to(dev, dtype)
    hr = torch.from_numpy(batch["hr"]).to(dev, dtype)
    sr_model, stu, teacher = state.sr[0], state.stu[0], state.teacher
    lr_nchw = lr.permute(0, 3, 1, 2)

    def run(model, *inputs):
        with compute_context(dev.type, dtype):
            return model(*inputs)

    def teacher_prior():
        with torch.no_grad():
            return torch.softmax(run(teacher, parse_crnn_data(hr, cw).permute(0, 3, 1, 2)).float(), -1)

    target = teacher_prior()

    def student():
        logits = run(stu, parse_crnn_data(lr, cw).permute(0, 3, 1, 2)).float()
        (semantic_loss(torch.softmax(logits, -1), target) * 100.0).backward()

    with torch.no_grad():
        logits = run(stu, parse_crnn_data(lr, cw).permute(0, 3, 1, 2)).float()
        prior = prior_dropout_first_quarter(logits_to_prior(logits)).to(dtype).permute(0, 3, 1, 2)

    def tsrn_tl():
        sr = run(sr_model, lr_nchw, prior).permute(0, 2, 3, 1)
        (image_loss(sr.float(), hr.float(), gradient=True) * 100.0).backward()

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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--compute_dtype", choices=sorted(COMPUTE_DTYPES), default="fp32",
                        help="the train step's precision, as TRAIN.compute_dtype")
    compute_dtype = parser.parse_args(argv).compute_dtype
    if not torch.cuda.is_available():
        print("profile_train: CUDA is not available; this run needs an NVIDIA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(json.dumps({"card": smi.splitlines()[0], "torch": torch.__version__, "batch": BATCH, "tf32": False,
                      "compute_dtype": compute_dtype}), flush=True)
    dev = torch.device("cuda")
    state, step = flagship_train(device=dev, seed=0, compute_dtype=compute_dtype)
    batch = random_batch(np.random.default_rng(0), BATCH)
    row = parts(state, step, batch, dev, COMPUTE_DTYPES[compute_dtype])
    row["images_per_s"] = BATCH / row["step_ms"] * 1e3
    summary, top = trace(state, step, batch, extra=K1_KERNELS)
    print(json.dumps({**row, **summary}), flush=True)
    for k in top:
        print(json.dumps(k), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
