"""Where the flagship eval step's time goes on one NVIDIA card.

    python -m tpgsr_tpu_torch.profile_eval        # from the root of a checkout; needs one card

Builds the flagship (``entry.flagship``) at batch 48 and, twice (fp32 with
TF32 off, as ``chip_smoke.py`` runs it, and then with TF32 on, PyTorch's
default for cuDNN convolutions):

* times each part of the eval step with CUDA events (median of 20 after
  warmup): the prior (bicubic + student CRNN + softmax), TSRN_TL, the
  teacher CRNN on SR, LR and HR, the MSE/SSIM metrics, the whole step, and
  ``evaluate`` per batch (the step plus host-side decoding and scoring);
* traces 5 eval steps with ``torch.profiler`` and prints the device's busy
  share of the traced wall time, the kernels that take the most device
  time, and K1 (``bigru_seq``) wherever it ranks.

Prints one JSON object per line; a card is required.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from tpgsr_tpu_torch.entry import flagship
from tpgsr_tpu_torch.ops.image import ssim
from tpgsr_tpu_torch.train.evaluate import evaluate
from tpgsr_tpu_torch.train.priors import logits_to_prior, parse_crnn_data
from tpgsr_tpu_torch.train.step import crnn_width

BATCH = 48
ITERS = 20
TOP_KERNELS = 12


def median_ms(fn, iters: int = ITERS, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def random_batch(rng: np.random.Generator, n: int):
    def image(h, w):
        rgb = rng.random((n, h, w, 3), dtype=np.float32)
        mask = (rng.random((n, h, w, 1)) < 0.5).astype(np.float32)
        return np.concatenate([rgb, mask], axis=-1)

    return {"hr": image(32, 128), "lr": image(16, 64), "labels": ["text"] * n}


def parts(models, step, batch, dev):
    """Median ms of each part of the eval step, on tensors already on the card."""
    cw = crnn_width(128)
    lr = torch.from_numpy(batch["lr"]).to(dev)
    hr = torch.from_numpy(batch["hr"]).to(dev)
    sr_model, stu, teacher = models.sr[0], models.stu[0], models.teacher

    def prior():
        return logits_to_prior(stu(parse_crnn_data(lr, cw).permute(0, 3, 1, 2)))

    p = prior().permute(0, 3, 1, 2)
    lr_nchw = lr.permute(0, 3, 1, 2)
    sr = sr_model(lr_nchw, p).permute(0, 2, 3, 1)

    def recognize(img):
        return teacher(parse_crnn_data(img, cw).permute(0, 3, 1, 2))

    def metrics():
        diff = (sr[..., :3] - hr[..., :3]) * 255.0
        return torch.mean(diff * diff, dim=(1, 2, 3)), ssim(sr, hr, size_average=False)

    with torch.no_grad():
        out = {
            "prior_ms": median_ms(prior),
            "tsrn_tl_ms": median_ms(lambda: sr_model(lr_nchw, p)),
            "recognizer_sr_lr_hr_ms": median_ms(lambda: [recognize(x) for x in (sr, lr, hr)]),
            "metrics_ms": median_ms(metrics),
        }
    out["step_ms"] = median_ms(lambda: step(models, batch))
    out["evaluate_per_batch_ms"] = median_ms(lambda: evaluate(step, models, [batch]))
    return out


def trace(models, step, batch, steps: int = 5, extra=("bigru_seq",)):
    """Busy share of the card over ``steps`` steps and the top kernels, with
    those whose names hold a string of ``extra`` wherever they rank."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        step(models, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(models, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device events, less the profiler's own annotations ("Optimizer.step#Adam.step")
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and "#" not in e.key]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    top = [{"kernel": e.key[:90], "calls_per_step": e.count / steps,
            "ms_per_step": e.self_device_time_total / 1e3 / steps,
            "share": e.self_device_time_total / 1e3 / device_ms if device_ms else 0.0}
           for e in kernels[:TOP_KERNELS] + [e for e in kernels[TOP_KERNELS:] if any(x in e.key for x in extra)]]
    return {"traced_steps": steps, "wall_ms_per_step": wall_ms / steps,
            "device_ms_per_step": device_ms / steps,
            "device_busy_share": device_ms / wall_ms if wall_ms else 0.0,
            "kernels_per_step": sum(e.count for e in kernels) / steps}, top


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_eval: CUDA is not available; this run needs an NVIDIA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(json.dumps({"card": smi.splitlines()[0], "torch": torch.__version__, "batch": BATCH}), flush=True)
    dev = torch.device("cuda")
    models, step = flagship(device=dev, seed=0)
    batch = random_batch(np.random.default_rng(0), BATCH)
    for tf32 in (False, True):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        row = {"tf32": tf32, **parts(models, step, batch, dev)}
        row["images_per_s_evaluate"] = BATCH / row["evaluate_per_batch_ms"] * 1e3
        summary, top = trace(models, step, batch)
        print(json.dumps({**row, **summary}), flush=True)
        for k in top:
            print(json.dumps({"tf32": tf32, **k}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
