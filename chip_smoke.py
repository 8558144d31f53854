#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tpgsr_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout; needs one card

Phases, in order; any failure ends the run with a non-zero exit and no
result line (so does a missing card, or a missing ``tpgsr_tpu_torch``
package beside this script):

1. device: requires CUDA, prints the card's name and power limit;
2. build: compiles every kernel under tpgsr_tpu_torch/csrc with nvcc and
   checks that no instantiation of K1's forward or backward spills;
3. K1 (the BiGRU recurrence) against its plain PyTorch version on the card,
   at the flagship's two sweep shapes, at edge cases and at every compiled
   instantiation (hidden size x rows a thread), with times beside the plain
   version, ``nn.GRU`` and the card's bound, and the launch configuration
   of each timed shape;
4. the flagship eval path on the card against the same path on the CPU;
5. serving: ``evaluate`` over 4 batches of 48 at full width, with K1's
   launches counted on that run alone;
6. K1's backward kernel (with the GEMM for dW_hh) against the plain BPTT on
   the card, at the flagship's two sweeps, edge cases and every compiled
   instantiation (hidden size x rows a thread), with times beside the plain
   version, ``nn.GRU`` forward + backward and the card's bound, and the
   launch configuration of each case;
7. one flagship train step on the card against the same step on the CPU,
   from the same weights and batch: losses, every gradient, BN statistics;
8. training: 20 flagship train steps at batch 48 after 2 warm-up steps, with
   K1's forward and backward launches counted on that run alone, images/s
   by CUDA events and peak memory;
9. the TextZoom data path: a synthetic TextZoom at full geometry written
   with the port's ``write_lmdb`` (two train LMDBs of 22 x 48 pairs in all,
   val splits of 162, 141 and 134), then (a) the card's contour mask from a
   pinned loader batch against the host collate's, byte for byte, and one
   ``--use_label`` train step on a loader batch on the card against the
   CPU; (b) the loader alone, epochs 1 and 2, one worker; (c) 20 flagship
   train steps at batch 48 from ``train_loader`` after 2 warm-up steps,
   K1's launches counted; (d) ``evaluate`` over the three ``val_loaders``,
   a second pass timed, K1's launches counted, then the same batches
   preloaded, for the twin of the same shapes.  (b) and (c) also run the
   same dataset and collate through torch's default wire (tensors from the
   workers, pinned by the ``DataLoader``) for comparison.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import functools
import io
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from PIL import Image, ImageDraw

from tpgsr_tpu_torch import entry
from tpgsr_tpu_torch.bench_k1 import device_ms, ptxas_report
from tpgsr_tpu_torch.data.datasets import ConcatDataset, TextZoomDataset
from tpgsr_tpu_torch.data.lmdb import write_lmdb
from tpgsr_tpu_torch.data.loader import EpochBatchSampler
from tpgsr_tpu_torch.ops import _build, gru_seq, rnn
from tpgsr_tpu_torch.ops.ctc import decode_crnn
from tpgsr_tpu_torch.ops.image import append_contour_mask_u8
from tpgsr_tpu_torch.train import trainer
from tpgsr_tpu_torch.train.evaluate import evaluate
from tpgsr_tpu_torch.train.step import make_train_step

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and fp32 outside the
# tensor cores; the comparisons run in full fp32 (TF32 off).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12

BATCH = 48
SERVE_BATCHES = 4
TRAIN_STEPS = 20
TRAIN_WARMUP = 2
CARD_VS_CPU_TRAIN_BATCH = 8
N_SRB = 5  # flagship SRBs; each runs K1 once over W and once over H
# the synthetic TextZoom: train pairs in two LMDBs, and a tenth of TextZoom's
# easy / medium / hard val splits (1,619 / 1,411 / 1,343), each ending short
TRAIN_PAIRS = (TRAIN_WARMUP + TRAIN_STEPS) * BATCH
VAL_PAIRS = (162, 141, 134)


# conv biases that a BatchNorm follows in train mode: zero gradient in exact arithmetic
PRE_BN_BIAS = re.compile(r"(block\d+\.conv[12]|block7\.0|stn_convnet\.\d+\.0|stn_fc1\.0|cnn\.conv[246])\.bias$")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def median_ms(fn, iters: int, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bigru_bound_ms(n: int, t: int, c: int, h: int, projection: bool):
    """(ms for the bytes at HBM bandwidth, ms for the fp32 products at the
    fp32 rate) of the BiGRU; the least time is the larger.  With
    ``projection`` the function is x [N,T,C] -> [N,T,2H] (as nn.GRU);
    without, K1 alone, xp [N,T,6H] -> [N,T,2H]."""
    weights = 2 * 3 * h * h + 2 * 3 * h
    if projection:
        weights += 6 * h * c + 6 * h
        bytes_moved = 4 * (n * t * c + n * t * 2 * h + weights)
        flops = 2 * n * t * c * 6 * h + 2 * n * t * 2 * 3 * h * h
    else:
        bytes_moved = 4 * (n * t * 6 * h + n * t * 2 * h + weights)
        flops = 2 * n * t * 2 * 3 * h * h
    return bytes_moved / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FP32_FLOP_PER_S * 1e3


def bound_fields(t_bytes: float, t_ops: float, prefix: str = ""):
    return {f"{prefix}bound_ms": max(t_bytes, t_ops),
            f"{prefix}bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def gru_case(seed: int, n: int, t: int, c: int, h: int):
    rng = np.random.default_rng(seed)
    bound = 1.0 / np.sqrt(h)
    x = torch.from_numpy(rng.standard_normal((n, t, c)).astype(np.float32)).cuda()

    def direction():
        return {k: torch.from_numpy(rng.uniform(-bound, bound, shape).astype(np.float32)).cuda()
                for k, shape in (("w_ih", (3 * h, c)), ("w_hh", (3 * h, h)),
                                 ("b_ih", (3 * h,)), ("b_hh", (3 * h,)))}

    return x, direction(), direction()


def phase_k1():
    """K1 against the plain version; times at the two flagship sweep shapes."""
    # (label, N, T, C, H, atol).  1e-5 is fp32 noise for a few steps; at T = 64
    # the kernel's and cuBLAS's differently ordered sums compound over 64
    # dependent steps, so 2e-5 there.
    cases = [
        ("sweep over W, B=48", BATCH * 16, 64, 64, 32, 2e-5),
        ("sweep over H, B=48", BATCH * 64, 16, 64, 32, 1e-5),
        ("ragged N", 771, 64, 64, 32, 2e-5),
        ("T=1", 37, 1, 64, 32, 1e-5),
        ("H=8", 100, 20, 16, 8, 1e-5),
        ("H=16", 100, 20, 32, 16, 1e-5),
        ("2 rows a thread, ragged", 1500, 16, 64, 32, 1e-5),
        ("4 rows a thread, ragged", 3070, 16, 64, 32, 1e-5),
        ("T=3 < S", 37, 3, 64, 32, 1e-5),
        ("T=13, not a multiple of S", 45, 13, 64, 32, 1e-5),
    ]
    max_err, shapes = 0.0, []
    for i, (label, n, t, c, h, tol) in enumerate(cases):
        x, fw, bw = gru_case(i, n, t, c, h)
        got = gru_seq.bigru(x, fw, bw)
        torch.cuda.synchronize()
        ref = rnn.bigru(x, fw, bw)
        err = float((got - ref).abs().max())
        check(torch.isfinite(got).all().item(), f"K1 {label}: non-finite output")
        check(err <= tol, f"K1 {label}: max abs err {err:.3g} > {tol}")
        cfg = gru_seq.config_for(n, h, x.device)
        print(f"K1 {label}: N={n} T={t} C={c} H={h} rpt={cfg.rpt} S={gru_seq.RING_STAGES} "
              f"max_abs_err={err:.3g} (tol {tol})", flush=True)
        max_err = max(max_err, err)
        if i >= 2:
            continue
        print(f"K1 {label}: launch rpt={cfg.rpt} S={gru_seq.RING_STAGES} grid={cfg.blocks} "
              f"blocks_per_sm={cfg.blocks_per_sm} waves={cfg.waves}", flush=True)
        lib = torch.nn.GRU(c, h, bidirectional=True, batch_first=True).cuda()
        with torch.no_grad():
            for sfx, d in (("", fw), ("_reverse", bw)):
                for ours, theirs in (("w_ih", "weight_ih_l0"), ("w_hh", "weight_hh_l0"),
                                     ("b_ih", "bias_ih_l0"), ("b_hh", "bias_hh_l0")):
                    getattr(lib, theirs + sfx).copy_(d[ours])
            lib_err = float((lib(x)[0] - ref).abs().max())
            xp = rnn.input_projection(x, fw, bw).contiguous()
            w_hh = torch.stack([fw["w_hh"], bw["w_hh"]]).contiguous()
            b_hh = torch.stack([fw["b_hh"], bw["b_hh"]]).contiguous()
            row = {
                "label": label, "N": n, "T": t, "C": c, "H": h, "max_abs_err": err,
                "rpt": cfg.rpt, "stages": gru_seq.RING_STAGES, "blocks": cfg.blocks,
                "blocks_per_sm": cfg.blocks_per_sm, "waves": cfg.waves,
                "ms": median_ms(lambda: gru_seq.bigru(x, fw, bw), 50),
                "plain_ms": median_ms(lambda: rnn.bigru(x, fw, bw), 5, warmup=1),
                "library_ms": median_ms(lambda: lib(x), 50),
                "kernel_only_ms": median_ms(lambda: gru_seq._launch(xp, w_hh, b_hh), 50),
                "device_ms": device_ms(lambda: gru_seq.bigru(x, fw, bw)),
                "library_device_ms": device_ms(lambda: lib(x)),
                "kernel_only_device_ms": device_ms(lambda: gru_seq._launch(xp, w_hh, b_hh)),
                "library_max_abs_err": lib_err,
            }
        row["bytes_ms"], row["operations_ms"] = bigru_bound_ms(n, t, c, h, projection=True)
        row.update(bound_fields(row["bytes_ms"], row["operations_ms"]))
        row.update(bound_fields(*bigru_bound_ms(n, t, c, h, projection=False), prefix="kernel_only_"))
        print("K1 timing " + json.dumps(row), flush=True)
        shapes.append(row)

    # every compiled instantiation, forced, on a ragged N at T = 13 and T = 3
    for h in gru_seq.SUPPORTED_HIDDEN:
        x, fw, bw = gru_case(100 + h, 3 * gru_seq.THREADS // h * 4 + 5, 13, 16, h)
        w_t = torch.stack([fw["w_hh"].t(), bw["w_hh"].t()]).contiguous()
        w_hh = torch.stack([fw["w_hh"], bw["w_hh"]])
        b_hh = torch.stack([fw["b_hh"], bw["b_hh"]])
        for t in (13, 3):
            xp = rnn.input_projection(x[:, :t].contiguous(), fw, bw).contiguous()
            ref = rnn.bigru_recurrence(xp, w_hh, b_hh)
            for rpt in gru_seq.RPTS:
                got = gru_seq._recurrence(xp, w_t, b_hh, config=gru_seq.LaunchConfig(rpt, 0, 0, 0))
                torch.cuda.synchronize()
                err = float((got - ref).abs().max())
                check(err <= 1e-5, f"K1 H={h} rpt={rpt} T={t}: max abs err {err:.3g} > 1e-5")
                max_err = max(max_err, err)
        print(f"K1 H={h}: rpt {gru_seq.RPTS} at N={x.shape[0]}, T=13 and T=3 agree (1e-5)", flush=True)
    return max_err, shapes


def synthetic_batch(rng, n: int, labels: bool = True):
    """Float NHWC HR 32x128 and LR 16x64 in [0, 1] with the contour mask
    (gray above its own mean -> 0, else 1) attached, and random words."""
    hr_rgb = rng.random((n, 32, 128, 3), dtype=np.float32)
    lr_rgb = hr_rgb.reshape(n, 16, 2, 64, 2, 3).mean(axis=(2, 4))

    def with_mask(rgb):
        gray = rgb @ np.array([0.299, 0.587, 0.114], np.float32)
        mask = (gray <= gray.mean(axis=(1, 2), keepdims=True)).astype(np.float32)
        return np.concatenate([rgb, mask[..., None]], axis=-1)

    batch = {"hr": with_mask(hr_rgb), "lr": with_mask(lr_rgb)}
    if labels:
        alphabet = np.array(list("0123456789abcdefghijklmnopqrstuvwxyz"))
        batch["labels"] = ["".join(rng.choice(alphabet, rng.integers(3, 9))) for _ in range(n)]
    return batch


def phase_card_vs_cpu():
    """The flagship at batch 4, same seeded weights, on the card and on the
    CPU (plain versions).  sr at 5e-4 (the full TSRN_TL's tolerance against
    JAX), logits at 2e-4 (the CRNN's), decoded strings equal."""
    batch = synthetic_batch(np.random.default_rng(1), 4, labels=False)
    gpu_models, gpu_step = entry.flagship(device="cuda", seed=0)
    cpu_models, cpu_step = entry.flagship(device="cpu", seed=0)
    sr_g, outs_g = gpu_step(gpu_models, batch)
    sr_c, outs_c = cpu_step(cpu_models, batch)
    check(tuple(sr_g.shape) == (4, 32, 128, 4), f"sr shape {tuple(sr_g.shape)}")
    check(torch.isfinite(sr_g).all().item(), "non-finite sr on the card")
    sr_err = float((sr_g.cpu() - sr_c).abs().max())
    check(sr_err <= 5e-4, f"sr card vs CPU: {sr_err:.3g} > 5e-4")
    for k in ("logits_sr", "logits_lr", "logits_hr"):
        err = float((outs_g[k].cpu() - outs_c[k]).abs().max())
        check(err <= 2e-4, f"{k} card vs CPU: {err:.3g} > 2e-4")
        check(decode_crnn(outs_g[k]) == decode_crnn(outs_c[k]), f"{k}: decoded strings differ")
    for k in ("mse", "ssim"):
        check(torch.allclose(outs_g[k].cpu(), outs_c[k], rtol=1e-4, atol=1e-4), f"{k} card vs CPU")
    print(f"card vs CPU: sr max_abs_err={sr_err:.3g}; logits and decoded strings agree", flush=True)
    return gpu_models, gpu_step


def phase_serve(models, step):
    rng = np.random.default_rng(2)
    warm = synthetic_batch(rng, BATCH)
    batches = [synthetic_batch(rng, BATCH) for _ in range(SERVE_BATCHES)]
    evaluate(step, models, [warm])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    gru_seq.LAUNCHES = 0
    start.record()
    t0 = time.perf_counter()
    metrics = evaluate(step, models, batches)
    end.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launches = gru_seq.LAUNCHES
    event_s = start.elapsed_time(end) / 1e3
    n_images = BATCH * SERVE_BATCHES
    print("serve metrics " + json.dumps(metrics), flush=True)
    check(metrics["images"] == n_images, f"images {metrics['images']} != {n_images}")
    check(all(np.isfinite(v) for v in metrics.values()), "non-finite metric")
    check(all(0.0 <= metrics[k] <= 1.0 for k in metrics if k.startswith("accuracy")), "accuracy outside [0, 1]")
    want = 2 * N_SRB * 1 * SERVE_BATCHES  # sweeps per SR forward x stages x batches
    check(launches == want, f"K1 launched {launches} times on the main path, expected {want}")
    serve = {"batch": BATCH, "batches": SERVE_BATCHES, "images_per_s": n_images / event_s,
             "event_s": event_s, "host_s": host_s, "k1_launches": launches,
             "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    print("serve " + json.dumps(serve), flush=True)
    return launches, serve["images_per_s"]


def bigru_backward_bound_ms(n: int, t: int, h: int):
    """(ms for the bytes, ms for the fp32 products) of the recurrence's
    backward, (xp, W_hh, b_hh, out, grad_out) -> (dxp, dW_hh, db_hh): reads
    xp, out and grad_out and writes dxp once; per row-step and direction it
    runs the recompute W_hh h, the product W_hh^T dhp and dhp^T h for dW_hh."""
    bytes_moved = 4 * (n * t * (6 * h + 2 * h + 2 * h + 6 * h) + 2 * (2 * 3 * h * h + 2 * 3 * h))
    flops = 3 * 2 * n * t * 2 * 3 * h * h
    return bytes_moved / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FP32_FLOP_PER_S * 1e3


def backward_case(seed: int, n: int, t: int, c: int, h: int):
    """(x, fw, bw, xp, w_hh, b_hh, out, grad_out) on the card."""
    x, fw, bw = gru_case(seed, n, t, c, h)
    xp = rnn.input_projection(x, fw, bw).contiguous()
    w_hh = torch.stack([fw["w_hh"], bw["w_hh"]]).contiguous()
    b_hh = torch.stack([fw["b_hh"], bw["b_hh"]]).contiguous()
    out = gru_seq._launch(xp, w_hh, b_hh)
    grad_out = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal((n, t, 2 * h)).astype(np.float32)).cuda()
    return x, fw, bw, xp, w_hh, b_hh, out, grad_out


def phase_k1_backward():
    """K1's backward against the plain BPTT; times at the two flagship sweeps."""
    # (label, N, T, C, H).  dxp at 2e-5, 5e-5 at T = 64 (a reverse chain of 64
    # dependent steps compounds differently ordered fp32 sums); dW_hh and
    # db_hh, sums over N * T row-steps, at 1e-5 of their largest entry.
    cases = [
        ("sweep over W, B=48", BATCH * 16, 64, 64, 32),
        ("sweep over H, B=48", BATCH * 64, 16, 64, 32),
        ("ragged N", 771, 64, 64, 32),
        ("T=1", 37, 1, 64, 32),
        ("T=3", 37, 3, 64, 32),
        ("H=8", 100, 20, 16, 8),
        ("H=16", 100, 20, 32, 16),
    ]
    max_err, shapes = 0.0, []
    for i, (label, n, t, c, h) in enumerate(cases):
        x, fw, bw, xp, w_hh, b_hh, out, grad_out = backward_case(200 + i, n, t, c, h)
        got = gru_seq.recurrence_backward(xp, w_hh, b_hh, out, grad_out)
        torch.cuda.synchronize()
        want = rnn.bigru_recurrence_backward(xp, w_hh, b_hh, out, grad_out)
        tol = 5e-5 if t >= 64 else 2e-5
        err = float((got[0] - want[0]).abs().max())
        check(all(torch.isfinite(g).all().item() for g in got), f"K1 backward {label}: non-finite output")
        check(err <= tol, f"K1 backward {label}: dxp max abs err {err:.3g} > {tol}")
        rel = [float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30) for g, w in zip(got[1:], want[1:])]
        check(max(rel) <= 1e-5, f"K1 backward {label}: dW_hh / db_hh rel err {rel} > 1e-5")
        print(f"K1 backward {label}: N={n} T={t} H={h} dxp max_abs_err={err:.3g} (tol {tol}) "
              f"dW_hh, db_hh rel_err={rel[0]:.3g}, {rel[1]:.3g} (tol 1e-5)", flush=True)
        max_err = max(max_err, err)
        cfg = gru_seq.config_for(n, h, x.device, backward=True)
        print(f"K1 backward {label}: launch rpt={cfg.rpt} grid={cfg.blocks} blocks_per_sm={cfg.blocks_per_sm} "
              f"waves={cfg.waves}", flush=True)
        if i >= 2:
            continue
        w_t = w_hh.transpose(1, 2).contiguous()
        leaves = [x.clone().requires_grad_(True), *({k: v.clone().requires_grad_(True) for k, v in d.items()}
                                                    for d in (fw, bw))]

        def fwd_bwd():
            gru_seq.bigru(*leaves).backward(grad_out)

        lib = torch.nn.GRU(c, h, bidirectional=True, batch_first=True).cuda()
        with torch.no_grad():
            for sfx, d in (("", fw), ("_reverse", bw)):
                for ours, theirs in (("w_ih", "weight_ih_l0"), ("w_hh", "weight_hh_l0"),
                                     ("b_ih", "bias_ih_l0"), ("b_hh", "bias_hh_l0")):
                    getattr(lib, theirs + sfx).copy_(d[ours])
        x_lib = x.clone().requires_grad_(True)

        def lib_fwd_bwd():
            lib(x_lib)[0].backward(grad_out)

        row = {
            "label": label, "N": n, "T": t, "C": c, "H": h, "max_abs_err": err, "w_b_rel_err": max(rel),
            "rpt": cfg.rpt, "blocks": cfg.blocks, "blocks_per_sm": cfg.blocks_per_sm, "waves": cfg.waves,
            "ms": device_ms(lambda: gru_seq.recurrence_backward(xp, w_hh, b_hh, out, grad_out)),
            "kernel_only_ms": device_ms(lambda: gru_seq._backward_kernel(xp, w_t, b_hh, out, grad_out)),
            "fwd_bwd_ms": device_ms(fwd_bwd),
            "library_ms": device_ms(lib_fwd_bwd),
            "plain_ms": median_ms(lambda: rnn.bigru_recurrence_backward(xp, w_hh, b_hh, out, grad_out), 5, warmup=1),
        }
        row["bytes_ms"], row["operations_ms"] = bigru_backward_bound_ms(n, t, h)
        row.update(bound_fields(row["bytes_ms"], row["operations_ms"]))
        print("K1 backward timing " + json.dumps(row), flush=True)
        shapes.append(row)

    # every compiled instantiation, forced, on a ragged N at T = 13 and T = 3
    for h in gru_seq.SUPPORTED_HIDDEN:
        n = 3 * gru_seq.THREADS // h * 4 + 5
        for t in (13, 3):
            _, _, _, xp, w_hh, b_hh, out, grad_out = backward_case(300 + h + t, n, t, 16, h)
            w_t = w_hh.transpose(1, 2).contiguous()
            want = rnn.bigru_recurrence_backward(xp, w_hh, b_hh, out, grad_out)
            for rpt in gru_seq.RPTS:
                dxp, dhp, h_prev = gru_seq._backward_kernel(xp, w_t, b_hh, out, grad_out,
                                                            config=gru_seq.LaunchConfig(rpt, 0, 0, 0))
                got = (dxp, *gru_seq.recurrent_weight_grads(dhp, h_prev))
                torch.cuda.synchronize()
                err = float((got[0] - want[0]).abs().max())
                check(err <= 2e-5, f"K1 backward H={h} rpt={rpt} T={t}: dxp max abs err {err:.3g} > 2e-5")
                rel = [float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30) for g, w in zip(got[1:], want[1:])]
                check(max(rel) <= 1e-5, f"K1 backward H={h} rpt={rpt} T={t}: dW_hh / db_hh rel err {rel} > 1e-5")
                max_err = max(max_err, err)
        print(f"K1 backward H={h}: rpt {gru_seq.RPTS} at N={n}, T=13 and T=3 agree (dxp 2e-5, dW_hh/db_hh 1e-5)",
              flush=True)
    return max_err, shapes


def grads_of(module: torch.nn.Module):
    return {k: p.grad.detach().cpu() for k, p in module.named_parameters() if p.grad is not None}


def phase_train_card_vs_cpu():
    """One flagship train step from the same seeded weights and numpy batch
    on the card and on the CPU (plain versions).  Gradients are compared, not
    the parameters after Adam: its first update is lr * g / (|g| + eps),
    about +-lr wherever g is not tiny, so a gradient near zero whose sign the
    two devices round differently moves the copies 2 lr apart.  The pre-BN
    biases' gradients are zero in exact arithmetic and are held to 1e-4 of
    their model's gradient norm.  Every other gradient is held, relative to
    its own norm and to its model's as a whole, to about three times what
    fp32 itself gives against fp64 on the CPU at this width: up to 1.5e-3 in TSRN_TL
    (sums over five SRBs' recurrences) and 1e-2 in the student, whose
    gradient runs through the distillation's |teacher - student| where the
    two nearly tie and a rounding flips the sign.  Losses at rtol 1e-5, BN
    statistics after the step at 1e-4."""
    batch = synthetic_batch(np.random.default_rng(3), CARD_VS_CPU_TRAIN_BATCH, labels=False)
    card, card_step = entry.flagship_train(device="cuda", seed=0)
    cpu, cpu_step = entry.flagship_train(device="cpu", seed=0)
    m_card = card_step(card, batch)
    m_cpu = cpu_step(cpu, batch)
    for k in m_cpu:
        got, want = float(m_card[k]), float(m_cpu[k])
        check(np.isfinite(got) and abs(got - want) <= 1e-5 * abs(want), f"train {k}: card {got} vs CPU {want}")
    worst = {}
    for name, a, b, (tol_each, tol_all) in (("sr", card.sr[0], cpu.sr[0], (5e-3, 5e-3)),
                                            ("stu", card.stu[0], cpu.stu[0], (3e-2, 3e-2))):
        ga, gb = grads_of(a), grads_of(b)
        check(sorted(ga) == sorted(gb) and len(gb) == len(list(b.parameters())), f"{name}: gradients missing")
        total = float(torch.sqrt(sum(g.pow(2).sum() for g in gb.values())))
        diff = float(torch.sqrt(sum((ga[k] - gb[k]).pow(2).sum() for k in gb if not PRE_BN_BIAS.search(k))))
        check(diff <= tol_all * total, f"train {name}: gradient rel err {diff / total:.3g} > {tol_all}")
        worst[name] = diff / total
        for k in gb:
            if PRE_BN_BIAS.search(k):
                check(float(ga[k].norm()) <= 1e-4 * total, f"train {name}.{k}: pre-BN bias gradient not ~0")
                continue
            rel = float((ga[k] - gb[k]).norm()) / max(float(gb[k].norm()), 1e-30)
            check(rel <= tol_each, f"train {name}.{k}: gradient rel err {rel:.3g} > {tol_each}")
            worst[f"{name}.{k}"] = rel
        sa, sb = a.state_dict(), b.state_dict()
        for k in sb:
            if "running" in k:
                check(torch.allclose(sa[k].cpu(), sb[k], rtol=1e-4, atol=1e-5), f"train {name}.{k}: BN statistic")
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:5]
    print(f"train card vs CPU (batch {CARD_VS_CPU_TRAIN_BATCH}): losses "
          f"{ {k: float(v) for k, v in m_card.items()} }; worst gradient rel errs {top}", flush=True)


def phase_train():
    """20 flagship train steps at batch 48 on synthetic batches."""
    rng = np.random.default_rng(4)
    batches = [synthetic_batch(rng, BATCH, labels=False) for _ in range(TRAIN_WARMUP + TRAIN_STEPS)]
    state, step = entry.flagship_train(device="cuda", seed=0)
    for b in batches[:TRAIN_WARMUP]:
        step(state, b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    gru_seq.LAUNCHES = 0
    gru_seq.BACKWARD_LAUNCHES = 0
    start.record()
    t0 = time.perf_counter()
    metrics = [step(state, b) for b in batches[TRAIN_WARMUP:]]
    end.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launches, backward_launches = gru_seq.LAUNCHES, gru_seq.BACKWARD_LAUNCHES
    event_s = start.elapsed_time(end) / 1e3
    losses = [float(m["loss_total"]) for m in metrics]
    check(all(np.isfinite(v) for m in metrics for v in (float(x) for x in m.values())), "non-finite train loss")
    want = 2 * N_SRB * TRAIN_STEPS
    check(launches == want, f"K1 forward launched {launches} times in training, expected {want}")
    check(backward_launches == want, f"K1 backward launched {backward_launches} times in training, expected {want}")
    check(state.step == TRAIN_WARMUP + TRAIN_STEPS, f"train state at step {state.step}")
    train = {"batch": BATCH, "steps": TRAIN_STEPS, "images_per_s": BATCH * TRAIN_STEPS / event_s,
             "ms_per_step": event_s * 1e3 / TRAIN_STEPS, "event_s": event_s, "host_s": host_s,
             "k1_launches": launches, "k1_backward_launches": backward_launches,
             "loss_first": losses[0], "loss_last": losses[-1],
             "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    print("train " + json.dumps(train), flush=True)
    return launches, backward_launches, train["images_per_s"]


# the word renderer of tests/fixtures.py: text on a dark background, noise
def render_word(word: str, size, seed: int = 0) -> Image.Image:
    rng = np.random.default_rng(seed)
    bg = rng.integers(0, 80, 3)
    img = Image.new("RGB", size, tuple(int(c) for c in bg))
    d = ImageDraw.Draw(img)
    d.text((2, 2), word, fill=(int(200 + rng.integers(0, 55)),) * 3)
    arr = np.asarray(img, np.float32)
    noise = rng.normal(0, 8, arr.shape)
    return Image.fromarray(np.clip(arr + noise, 0, 255).astype(np.uint8))


def _jpeg(img: Image.Image) -> bytes:
    buf = io.BytesIO()
    img.save(buf, "JPEG", quality=92)
    return buf.getvalue()


def make_textzoom_lmdb(path: str, n: int, seed: int) -> str:
    """An lmdbDataset_real-style LMDB of ``n`` pairs (HR 128x32, LR 64x16
    JPEGs) of seeded words of 3 to 10 letters and digits."""
    rng = np.random.default_rng(seed)
    alphabet = np.array(list("0123456789abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"))
    items = [(b"num-samples", str(n).encode())]
    for i in range(1, n + 1):
        word = "".join(rng.choice(alphabet, rng.integers(3, 11)))
        hr = render_word(word, (128, 32), seed=seed * 100_000 + i)
        items.append((b"label-%09d" % i, word.encode()))
        items.append((b"image_hr-%09d" % i, _jpeg(hr)))
        items.append((b"image_lr-%09d" % i, _jpeg(hr.resize((64, 16), Image.BICUBIC))))
    write_lmdb(path, items)
    return path


def loader_kw(batch: int, device: str, workers: int = 1):
    """The flagship's TRAIN keys for the loaders: 128x32, batch ``batch``,
    the trainer's defaults otherwise (uint8 wire, mask on the device, decode
    cache, seed 1234, voc_type 'all')."""
    return dict(batch_size=batch, height=32, width=128, workers=workers, device=device)


def phase_data_card_vs_cpu(train_dirs, val_dirs):
    """(a) The contour mask appended on the card to the first batch of a
    pinned val loader (uint8 RGB) against the host collate's mask on the same
    items, byte for byte; one ``--use_label`` train step on the first batch of
    a train loader, on the card and on the CPU from the same seeded weights:
    losses at rtol 1e-5."""
    loader = trainer.val_loaders(val_dirs[:1], "tsrn_tl_cascade", mask=True, **loader_kw(BATCH, "cuda"))[0]
    batch = next(iter(loader))
    check(batch["hr"].is_pinned() and batch["hr"].shape == (BATCH, 32, 128, 3), "val batch not pinned uint8 RGB")
    ds = TextZoomDataset(val_dirs[0], voc_type="all")
    host = trainer.make_collate("tsrn_tl_cascade", False, mask=True, device_mask=False)([ds[i] for i in range(BATCH)])
    for k in ("hr", "lr"):
        card = append_contour_mask_u8(batch[k].cuda(non_blocking=True)).cpu()
        check(torch.equal(card, torch.from_numpy(host[k])), f"{k}: the card's contour mask differs from the host "
              "collate's")
    del loader

    args = dict(entry.FLAGSHIP_ARGS, use_label=True)
    cpu_batch = next(iter(trainer.train_loader(train_dirs, "tsrn_tl_cascade", mask=True,
                                               **loader_kw(CARD_VS_CPU_TRAIN_BATCH, "cpu", workers=0))))
    check(cpu_batch["ctc_lengths"].min().item() > 0, "a train word without a CTC label")
    losses = []
    for dev in ("cuda", "cpu"):
        state, _ = entry.flagship_train(device=dev, seed=0)
        step = make_train_step(args, entry.TRAIN_WIDTH, device=dev)
        losses.append({k: float(v) for k, v in step(state, cpu_batch).items()})
    card, cpu = losses
    for k in cpu:
        check(np.isfinite(card[k]) and abs(card[k] - cpu[k]) <= 1e-5 * abs(cpu[k]),
              f"use_label train {k}: card {card[k]} vs CPU {cpu[k]}")
    print(f"data card vs CPU: contour masks equal on {BATCH} val pairs; use_label losses (batch "
          f"{CARD_VS_CPU_TRAIN_BATCH}) card {card} CPU {cpu}", flush=True)
    return card


def tensor_collate(collate, items):
    """The port's collate with its arrays as tensors: what torch's default
    wire sends from a worker (through shared memory), for comparison."""
    return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in collate(items).items()}


def tensor_wire_loader(train_dirs):
    """The train loader's dataset, batches and collate in a plain
    ``DataLoader`` that ships tensors and pins them in its own thread."""
    ds = ConcatDataset([TextZoomDataset(d, voc_type="all", cache_images=True) for d in train_dirs])
    collate = functools.partial(tensor_collate, trainer.make_collate("tsrn_tl_cascade", True, mask=True))
    return torch.utils.data.DataLoader(
        ds, batch_sampler=EpochBatchSampler(len(ds), BATCH, True, True, 1234), collate_fn=collate, num_workers=1,
        pin_memory=True, multiprocessing_context="forkserver", persistent_workers=True,
        generator=torch.Generator().manual_seed(1234))


def port_loader(train_dirs):
    return trainer.train_loader(train_dirs, "tsrn_tl_cascade", mask=True, **loader_kw(BATCH, "cuda"))


def phase_loader_only(name: str, loader):
    """(b) A train loader alone (one worker, pinned), two epochs: the first
    batch (worker start-up included) apart, then pairs/s."""
    out = {"wire": name}
    for epoch in (1, 2):
        t0 = time.perf_counter()
        it = iter(loader)
        next(it)
        t1 = time.perf_counter()
        rest = sum(1 for _ in it)
        t2 = time.perf_counter()
        out[f"epoch{epoch}_first_batch_s"] = t1 - t0
        out[f"epoch{epoch}_pairs_per_s"] = rest * BATCH / (t2 - t1)
        out[f"epoch{epoch}_batches"] = rest + 1
    check(out["epoch1_batches"] == out["epoch2_batches"] == TRAIN_WARMUP + TRAIN_STEPS, "loader batch count")
    print("loader " + json.dumps(out), flush=True)
    return out


def phase_lmdb_train(name: str, loader):
    """(c) 20 flagship train steps at batch 48 from a fresh train loader (one
    worker, cold decode: one epoch is the 22 batches), after 2 warm-up steps;
    the time the host waited on the loader is counted apart."""
    state, step = entry.flagship_train(device="cuda", seed=0)
    it = iter(loader)
    for _ in range(TRAIN_WARMUP):
        step(state, next(it))
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    gru_seq.LAUNCHES = 0
    gru_seq.BACKWARD_LAUNCHES = 0
    wait_s = 0.0
    start.record()
    t0 = time.perf_counter()
    metrics = []
    for _ in range(TRAIN_STEPS):
        w0 = time.perf_counter()
        batch = next(it)
        wait_s += time.perf_counter() - w0
        metrics.append(step(state, batch))
    end.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launches, backward_launches = gru_seq.LAUNCHES, gru_seq.BACKWARD_LAUNCHES
    event_s = start.elapsed_time(end) / 1e3
    check(all(np.isfinite(float(v)) for m in metrics for v in m.values()), "non-finite LMDB-fed train loss")
    want = 2 * N_SRB * TRAIN_STEPS
    check(launches == want, f"K1 forward launched {launches} times in LMDB-fed training, expected {want}")
    check(backward_launches == want, f"K1 backward launched {backward_launches} times in LMDB-fed training, "
          f"expected {want}")
    out = {"wire": name, "batch": BATCH, "steps": TRAIN_STEPS, "images_per_s": BATCH * TRAIN_STEPS / event_s,
           "ms_per_step": event_s * 1e3 / TRAIN_STEPS, "event_s": event_s, "host_s": host_s,
           "loader_wait_s": wait_s, "k1_launches": launches, "k1_backward_launches": backward_launches,
           "loss_first": float(metrics[0]["loss_total"]), "loss_last": float(metrics[-1]["loss_total"])}
    print("lmdb train " + json.dumps(out), flush=True)
    return out


def timed_eval(step, models, splits):
    """(images/s by CUDA events, host s, metric dicts) of ``evaluate`` over
    each split's batches in turn."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    per_split = [evaluate(step, models, batches) for batches in splits]
    end.record()
    torch.cuda.synchronize()
    return sum(VAL_PAIRS) / (start.elapsed_time(end) / 1e3), time.perf_counter() - t0, per_split


def phase_lmdb_eval(val_dirs):
    """(d) ``evaluate`` over the three ``val_loaders`` (one worker each, the
    short last batches unpadded): a first pass starts the workers and fills
    the caches, the second is timed by CUDA events with K1's launches
    counted.  Then the same batches, preloaded: the twin with the same
    shapes, which tells the loader's share from the short batches'."""
    models, step = entry.flagship(device="cuda", seed=0)
    loaders = trainer.val_loaders(val_dirs, "tsrn_tl_cascade", mask=True, **loader_kw(BATCH, "cuda"))
    for loader in loaders:
        evaluate(step, models, loader)
    gru_seq.LAUNCHES = 0
    images_per_s, host_s, per_split = timed_eval(step, models, loaders)
    launches = gru_seq.LAUNCHES
    preloaded_ips, _, preloaded = timed_eval(step, models, [list(loader) for loader in loaders])
    for got, want in zip(preloaded, per_split):
        check(all(got[k] == want[k] if k.startswith(("accuracy", "images")) else np.isclose(got[k], want[k], rtol=1e-5)
                  for k in want), f"preloaded val batches: {got} against the loaders' {want}")
    n_images = sum(VAL_PAIRS)
    n_batches = sum(-(-n // BATCH) for n in VAL_PAIRS)
    for n, m in zip(VAL_PAIRS, per_split):
        print("lmdb eval metrics " + json.dumps(m), flush=True)
        check(m["images"] == n, f"val split: {m['images']} images, expected {n}")
        check(all(np.isfinite(v) for v in m.values()), "non-finite eval metric")
        check(all(0.0 <= m[k] <= 1.0 for k in m if k.startswith("accuracy")), "accuracy outside [0, 1]")
    want = 2 * N_SRB * n_batches
    check(launches == want, f"K1 launched {launches} times in LMDB-fed eval, expected {want}")
    out = {"splits": list(VAL_PAIRS), "batches": n_batches, "images": n_images, "images_per_s": images_per_s,
           "preloaded_images_per_s": preloaded_ips, "host_s": host_s, "k1_launches": launches}
    print("lmdb eval " + json.dumps(out), flush=True)
    del loaders
    return out


def phase_data(serve_ips: float, train_ips: float):
    """Phase 9 in a temporary directory, removed at the end."""
    with tempfile.TemporaryDirectory(prefix="textzoom-") as root:
        t0 = time.perf_counter()
        half = TRAIN_PAIRS // 2
        train_dirs = [make_textzoom_lmdb(f"{root}/train{i}", n, seed=i + 1)
                      for i, n in enumerate((half, TRAIN_PAIRS - half))]
        val_dirs = [make_textzoom_lmdb(f"{root}/{name}", n, seed=10 + i)
                    for i, (name, n) in enumerate(zip(("easy", "medium", "hard"), VAL_PAIRS))]
        check(len(ConcatDataset([TextZoomDataset(d) for d in train_dirs])) == TRAIN_PAIRS, "train pairs")
        print(f"data: wrote {TRAIN_PAIRS} train pairs in 2 LMDBs and val splits {VAL_PAIRS} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        phase_data_card_vs_cpu(train_dirs, val_dirs)
        loader = phase_loader_only("port", port_loader(train_dirs))
        tensor_wire = phase_loader_only("torch tensors", tensor_wire_loader(train_dirs))
        train = phase_lmdb_train("port", port_loader(train_dirs))
        ev = phase_lmdb_eval(val_dirs)
        tensor_wire_train = phase_lmdb_train("torch tensors", tensor_wire_loader(train_dirs))
    summary = {"loader_epoch1_pairs_per_s": loader["epoch1_pairs_per_s"],
               "loader_epoch2_pairs_per_s": loader["epoch2_pairs_per_s"],
               "tensor_wire_epoch1_pairs_per_s": tensor_wire["epoch1_pairs_per_s"],
               "tensor_wire_epoch2_pairs_per_s": tensor_wire["epoch2_pairs_per_s"],
               "lmdb_train_images_per_s": train["images_per_s"], "phase8_train_images_per_s": train_ips,
               "tensor_wire_train_images_per_s": tensor_wire_train["images_per_s"],
               "lmdb_eval_images_per_s": ev["images_per_s"],
               "lmdb_eval_preloaded_images_per_s": ev["preloaded_images_per_s"], "phase5_eval_images_per_s": serve_ips}
    print("data " + json.dumps(summary), flush=True)
    return train, ev


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs an NVIDIA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    logs = _build.build(_build.all_sources())
    print(f"build: {len(logs)} kernel source(s) compiled in {time.perf_counter() - t0:.1f} s", flush=True)
    ptxas = ptxas_report(_build.build_log("bigru_seq"))
    for r in ptxas:
        print("nvcc bigru_seq " + json.dumps(r), flush=True)
    check(len(ptxas) == len(gru_seq.SUPPORTED_HIDDEN) * len(gru_seq.RPTS),
          f"ptxas reported {len(ptxas)} K1 instantiations")
    check(all(r["spill_bytes"] == 0 and r["stack_bytes"] == 0 for r in ptxas),
          "a K1 instantiation spills registers or keeps a stack frame")
    bwd_ptxas = ptxas_report(_build.build_log("bigru_seq_bwd"), backward=True)
    for r in bwd_ptxas:
        print("nvcc bigru_seq_bwd " + json.dumps(r), flush=True)
    check(len(bwd_ptxas) == len(gru_seq.SUPPORTED_HIDDEN) * len(gru_seq.RPTS),
          f"ptxas reported {len(bwd_ptxas)} K1 backward instantiations")
    check(all(r["spill_bytes"] == 0 and r["stack_bytes"] == 0 for r in bwd_ptxas),
          "a K1 backward instantiation spills registers or keeps a stack frame")

    # 3. K1 against its plain version
    max_err, shapes = phase_k1()

    # 4. card vs CPU, 5. serve
    models, step = phase_card_vs_cpu()
    launches, serve_ips = phase_serve(models, step)
    del models, step

    # 6. K1's backward against its plain version, 7. train step card vs CPU, 8. train
    bwd_err, bwd_shapes = phase_k1_backward()
    phase_train_card_vs_cpu()
    train_launches, backward_launches, train_ips = phase_train()

    # 9. the TextZoom data path
    lmdb_train, lmdb_eval = phase_data(serve_ips, train_ips)

    # per SR forward at B=48: N_SRB sweeps of each shape
    per_forward = {k: N_SRB * sum(row[k] for row in shapes)
                   for k in ("ms", "plain_ms", "library_ms", "bytes_ms", "operations_ms",
                             "kernel_only_ms", "kernel_only_bound_ms", "device_ms",
                             "library_device_ms", "kernel_only_device_ms")}
    bound = bound_fields(per_forward["bytes_ms"], per_forward["operations_ms"])
    kernels = [{
        "name": "K1 bigru_seq",
        "route": "cuda",
        "source": "tpgsr_tpu_torch/csrc/bigru_seq.cu",
        "replaces": "tpgsr_tpu/ops/pallas_gru.py:95",
        "launches": launches,
        "max_abs_err": max_err,
        "unit": f"one flagship SR forward at batch {BATCH}: {N_SRB} sweeps over W and {N_SRB} over H",
        "ms": per_forward["ms"],
        "kernel_ms": per_forward["ms"],
        "plain_ms": per_forward["plain_ms"],
        "bound_ms": bound["bound_ms"],
        "bound_by": bound["bound_by"],
        "library_ms": per_forward["library_ms"],
        "kernel_only_ms": per_forward["kernel_only_ms"],
        "kernel_only_bound_ms": per_forward["kernel_only_bound_ms"],
        "device_ms": per_forward["device_ms"],
        "library_device_ms": per_forward["library_device_ms"],
        "kernel_only_device_ms": per_forward["kernel_only_device_ms"],
        "shapes": shapes,
        "ptxas": ptxas,
        "train_launches": train_launches,
        "lmdb_train_launches": lmdb_train["k1_launches"],
        "lmdb_eval_launches": lmdb_eval["k1_launches"],
    }]
    per_backward = {k: N_SRB * sum(row[k] for row in bwd_shapes)
                    for k in ("ms", "kernel_only_ms", "fwd_bwd_ms", "library_ms", "plain_ms", "bytes_ms",
                              "operations_ms")}
    kernels.append({
        "name": "K1 bigru_seq backward",
        "route": "cuda",
        "source": "tpgsr_tpu_torch/csrc/bigru_seq_bwd.cu",
        "replaces": "tpgsr_tpu/ops/pallas_gru.py:34 (backward of)",
        "launches": backward_launches,
        "max_abs_err": bwd_err,
        "unit": (f"one flagship SR backward at batch {BATCH}: {N_SRB} sweeps over W and {N_SRB} over H; "
                 "ms: the recurrence's backward (the kernel, then the dW_hh GEMM and sums); kernel_only_ms: "
                 "the kernel alone; fwd_bwd_ms: the wrapper's forward and backward; library_ms: nn.GRU "
                 "forward and backward; plain_ms: the plain BPTT"),
        "ms": per_backward["ms"],
        "kernel_only_ms": per_backward["kernel_only_ms"],
        "fwd_bwd_ms": per_backward["fwd_bwd_ms"],
        "plain_ms": per_backward["plain_ms"],
        **bound_fields(per_backward["bytes_ms"], per_backward["operations_ms"]),
        "library_ms": per_backward["library_ms"],
        "shapes": bwd_shapes,
        "ptxas": bwd_ptxas,
        "lmdb_train_launches": lmdb_train["k1_backward_launches"],
    })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
