#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tpgsr_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout; needs one card

Phases, in order; any failure ends the run with a non-zero exit and no
result line (so does a missing card, or a missing ``tpgsr_tpu_torch``
package beside this script):

1. device: requires CUDA, prints the card's name and power limit;
2. build: compiles every kernel under tpgsr_tpu_torch/csrc with nvcc and
   checks that no instantiation of K1's forward or backward, fp32
   (csrc/bigru_seq.cu, csrc/bigru_seq_bwd.cu) or bf16 on the tensor cores
   (csrc/bigru_seq_bf16.cu, csrc/bigru_seq_bwd_bf16.cu), spills;
3. K1 (the BiGRU recurrence) against its plain PyTorch version on the card,
   in fp32 and in bf16, at the flagship's two sweep shapes (in bf16 also at
   batch 512), at edge cases and at every compiled instantiation (hidden
   size x rows a thread in fp32, x rows an m-tile in bf16), with times
   beside the plain version, ``nn.GRU`` (in the same dtype) and the card's
   bound, and the launch configuration of each timed shape;
4. the flagship eval path on the card against the same path on the CPU;
5. serving: ``evaluate`` over 4 batches of 48 at full width, with K1's
   launches counted on that run alone;
6. K1's backward kernel (with the GEMM for dW_hh) against the plain BPTT on
   the card, in fp32 and in bf16, at the flagship's two sweeps (in bf16 also
   at batch 512), edge cases and every compiled instantiation, with times
   beside the plain version, ``nn.GRU`` forward + backward and the card's
   bound, and the launch configuration of each case;
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
   workers, pinned by the ``DataLoader``) for comparison;
10. the trainer and the CLI: ``tpgsr_tpu_torch.cli.main`` in-process over
   phase 9's TextZoom and two more train LMDBs (an epoch of 44 batches of
   48), in the same temporary directory, from a config with
   ``compute_dtype: fp32``: one epoch with val and saves at 22 and 44, its
   files and scalar log, its first two iterations against a CPU ``TextSR``,
   ``--resume`` for a second epoch (step 88, global epoch 2's first batch),
   then ``--go_test``, ``--test --rec crnn`` and ``--demo`` from the
   checkpoint against the same commands on the CPU; the ``trainer`` line
   has the loop's images/s between the vals, the first iteration, a val, a
   save, ``--test``'s fps and K1's launches in the train window;
11. the bf16 train step (TRAIN.compute_dtype 'bf16', the packaged YAML's
   default): (a) one flagship step at batch 8 on the card against the card's
   fp32 step and the CPU's bf16 step from the same weights and batch, and
   the same with ``--use_label``, whose CTC term gives the student a
   gradient that bf16 does not swamp; (b) 20
   bf16 steps at batch 48 after 2 warm-up steps, K1's launches counted, with
   phase 8's fp32 images/s beside them;
12. the packaged YAML unchanged (bf16) through ``cli.main`` over phase 9's
   TextZoom, TF32 on first: 22 iterations with a val and a save at the
   end, the first iteration's losses against a CPU ``TextSR``, the val's
   metric dicts against the fp32 eval step on the saved weights, and the
   loop's images/s between the first iteration and the val.
13. the SR zoo of the repo's other train scripts (``train_TSRN.sh``,
   ``train_SRCNN.sh``, ``train_TPGSR-SRCNN.sh``, ``train_SRResNet.sh``,
   ``train_TPGSR-SRResNet.sh``, ``train_RDN.sh``, ``train_TPGSR-RDN.sh``),
   each with its flags at batch 48 and full width, TF32 off: (a) the eval
   step and one fp32 train step on the card against the CPU from the same
   weights and batch; (b) 10 train steps after 2 warm-up steps in fp32 and
   in bf16 (images/s, peak memory, K1's launches: 10 + 10 a step for
   ``tsrn``, none for the others), then ``evaluate`` over 4 batches; a
   ``{"zoo": ...}`` line each; (c) ``cli.main`` with each script's flags,
   on the packaged YAML (bf16) and with ``compute_dtype: fp32``, over phase
   9's TextZoom (22 iterations, a val and a save), then ``--go_test`` from
   the checkpoint against the val; a ``{"zoo_cli": ...}`` line each.

14. ASTER and MORAN as the eval recognizer: (a) the flagship's eval step
   at batch 8 with each (and ``srcnn``'s with ASTER), card against CPU
   from the same weights and batch, the recognizers' draws sharpened so
   that their decisions clear their noise: SR, then on the same inputs
   ASTER's rectified image, encoder features, best beam score and ids, and
   MORAN's L2R logits and ids; (b) ``evaluate`` over 4 batches of 48 with
   each (the CLI's draw, ``max_len`` 100, beam 5): images/s beside phase
   5's CRNN figure, K1's launches, kernels a batch and the card's busy
   share; (c) ``cli.main`` with ``--test --rec aster`` and ``--rec moran``
   from phase 10's checkpoint over the smallest val split, its fps, and its
   metric dict against ``evaluate`` in-process; a ``{"rec_eval": ...}``
   line each; then each of phase 13's seven scripts through ``cli.main``
   with ``--test`` from its fp32 checkpoint, ASTER and MORAN in turn (a
   ``{"rec_eval_zoo_cli": ...}`` line).
15. the rest of the single-model zoo (``tsrn_tl_wmask``, ``tsrn_tl``,
   ``textzoom_net``, ``vdsr``, ``vdsr_tl``, ``edsr``, ``lapsrn``,
   ``esrgan``, ``esrgan_tl``, ``bicubic``), each with the flags it reads of
   ``--STN`` and ``--mask``: (a) one ``tsrn_tl_cascade --stu_iter 2`` step
   whose stages are recomputed in the backward, card against CPU at batch
   8, K1 launched 20 + 20 times forward (the second 20 the recompute) and 20
   backward; then each arch's eval step and one fp32 train step at batch 8,
   card against CPU (phase 13's bounds); (b) each arch's 10 fp32 and 10
   bf16 train steps at batch 48 and ``evaluate`` over 4 batches (a
   ``{"zoo_rest": ...}`` line each, the host's load beside them), then
   ``srresnet_tl --stu_iter=3 --sr_share`` (recomputed) at batch 48 and one
   step at the YAML's batch 512, with peak memory; (c) ``cli.main`` with no
   ``--arch`` (``tsrn_tl_wmask``) on the packaged YAML (bf16) over phase 9's
   first train LMDB with a val, ``--test --rec crnn`` from its checkpoint,
   then the flagship's flags with ``--ssim_loss``.
16. the last two archs and the last two flags: ``tsrn_c2f --STN --mask``,
   ``sem_tsrn --mask`` and the flagship with ``--tpg OPT`` (clova's
   None-ResNet-None-CTC as teacher and student, a CRNN of its own scoring
   val), at full width: (a) each one's eval step and one fp32 train step at
   batch 8, card against CPU (phase 13's bounds), K1 launched 10 + 10 a
   step by ``tsrn_c2f`` and the OPT flagship and not by ``sem_tsrn``; the
   flagship's eval step scored by SEED (sharpened; phase 14's bounds, and
   its first decoder state at 2e-3); (b) 10 fp32 and 10 bf16 train steps at
   batch 48 and ``evaluate`` over 4 batches for each (a ``{"zoo_last":
   ...}`` line each), ``sem_tsrn`` at batch 512 where its batch-48 peak
   scaled to 512 stays under 70 GiB, the flagship's ``evaluate`` scored by
   SEED (a ``{"rec_eval": ...}`` line); (c) ``cli.main`` with each one's
   flags on the packaged YAML over phase 9's first train LMDB with a val,
   then ``--go_test --test_model SEED`` from the ``tsrn_c2f`` checkpoint,
   its metric dict against ``evaluate`` in-process (``{"zoo_last_cli":
   ...}``).  Phase 13(a) also measures ``srres``'s PReLU slopes' gradient
   gap with cuDNN off (a ``{"srres_prelu_gap": ...}`` line).

The third line from the end is ``{"phase_seconds": {...}}``, each phase's
seconds; the line before the last is ``{"kernels": [...]}``: K1's forward and
backward in fp32 and in bf16 (``zoo_launches``: ``tsrn``'s in phase
13(b); ``rec_eval_launches``: phase 14(b)'s; ``tl_simple_launches``:
``tsrn_tl_wmask``'s in phase 15(b); ``remat_launches``: phase 15(a)'s
recomputed step; ``c2f_launches``, ``opt_launches``, ``sem_launches``: phase
16(b)'s; ``seed_eval_launches``: its SEED-scored eval); the last is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from PIL import Image, ImageDraw

from tpgsr_tpu_torch import cli, entry
from tpgsr_tpu_torch.charset import CTC_CHAR_TO_ID
from tpgsr_tpu_torch.bench_k1 import device_ms, ptxas_report
from tpgsr_tpu_torch.config import AttrDict, build_arg_parser, load_config, script_argv
from tpgsr_tpu_torch.data.datasets import ConcatDataset, TextZoomDataset
from tpgsr_tpu_torch.data.lmdb import write_lmdb
from tpgsr_tpu_torch.data.loader import EpochBatchSampler
from tpgsr_tpu_torch.ops import _build, gru_seq, rnn
from tpgsr_tpu_torch.ops.ctc import decode_crnn
from tpgsr_tpu_torch.ops.image import append_contour_mask_u8
from tpgsr_tpu_torch.profile_eval import trace
from tpgsr_tpu_torch.profile_zoo import ARCH_FLAGS, argv_of
from tpgsr_tpu_torch.profile_zoo import mission as zoo_mission
from tpgsr_tpu_torch.train import step as port_step
from tpgsr_tpu_torch.train import trainer
from tpgsr_tpu_torch.train.evaluate import evaluate
from tpgsr_tpu_torch.train.step import EvalModels, make_eval_step, make_train_step, rec_decoder, recognizer_input

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, fp32 outside the tensor
# cores and dense bf16 on them; the comparisons run with TF32 off.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
PEAK_BF16_FLOP_PER_S = 989e12
DTYPE_NAMES = {torch.float32: "fp32", torch.bfloat16: "bf16"}

BATCH = 48
SERVE_BATCHES = 4
TRAIN_STEPS = 20
# timed train steps an arch in phases 13, 15 and 16 (the flagship's phases 8
# and 11 time TRAIN_STEPS): cut from 20 to keep the run inside its limit
ZOO_TRAIN_STEPS = 10
TRAIN_WARMUP = 2
CARD_VS_CPU_TRAIN_BATCH = 8
N_SRB = 5  # flagship SRBs; each runs K1 once over W and once over H
# the synthetic TextZoom: train pairs in two LMDBs, and a tenth of TextZoom's
# easy / medium / hard val splits (1,619 / 1,411 / 1,343), each ending short
TRAIN_PAIRS = (TRAIN_WARMUP + TRAIN_STEPS) * BATCH
VAL_PAIRS = (162, 141, 134)


# conv biases that a BatchNorm follows in train mode: zero gradient in exact
# arithmetic (block7.0: the trunk's last conv at 5 SRBs and in SRResNet;
# block8.0: at textzoom_net's 6)
PRE_BN_BIAS = re.compile(r"(block\d+\.conv[12]|block[78]\.0|stn_convnet\.\d+\.0|stn_fc1\.0|cnn\.conv[246])\.bias$")


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


# the bf16 kernels' recurrent products: each fp32 operand (the forward's h,
# the backward's dhp_t) split into three bf16 terms (ops/rnn.py::bf16_split3)
BF16_SPLIT_TERMS = 3


def recurrent_product_s(n: int, t: int, h: int, elem: int, terms: int = BF16_SPLIT_TERMS) -> float:
    """Seconds of one recurrent product over N*T row-steps, both directions
    (2 N T 2 3H H flops): at the fp32 rate in fp32; in bf16 on the tensor
    cores, ``terms`` products at the bf16 rate."""
    flops = 2 * n * t * 2 * 3 * h * h
    return flops / PEAK_FP32_FLOP_PER_S if elem == 4 else terms * flops / PEAK_BF16_FLOP_PER_S


def bigru_bound_ms(n: int, t: int, c: int, h: int, projection: bool, elem: int = 4):
    """(ms for the bytes at HBM bandwidth, ms for the products at their
    type's rate) of the BiGRU; the least time is the larger.  With
    ``projection`` the function is x [N,T,C] -> [N,T,2H] (as nn.GRU);
    without, K1 alone, xp [N,T,6H] -> [N,T,2H].  Activations of ``elem``
    bytes (4 fp32, 2 bf16), fp32 weights; the projection's products at the
    fp32 rate in fp32 and the bf16 tensor-core rate in bf16, the recurrent
    ones by ``recurrent_product_s`` (in bf16 the tensor-core kernel's three
    terms of h)."""
    weights = 2 * 3 * h * h + 2 * 3 * h
    recurrent = recurrent_product_s(n, t, h, elem)
    if projection:
        weights += 6 * h * c + 6 * h
        bytes_moved = elem * (n * t * c + n * t * 2 * h) + 4 * weights
        ops_s = 2 * n * t * c * 6 * h / (PEAK_BF16_FLOP_PER_S if elem == 2 else PEAK_FP32_FLOP_PER_S) + recurrent
    else:
        bytes_moved = elem * (n * t * 6 * h + n * t * 2 * h) + 4 * weights
        ops_s = recurrent
    return bytes_moved / PEAK_BYTES_PER_S * 1e3, ops_s * 1e3


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


def bf16_excess(got: torch.Tensor, ref: torch.Tensor, atol: float) -> float:
    """The largest amount by which a bf16 ``got`` lies beyond one bf16 ulp of
    ``ref`` plus ``atol``; at most 0 where they agree so.  The fp32 states of
    kernel and plain version differ by the order of their sums (``atol``,
    the fp32 tolerance), which can move the rounding to bf16 by one ulp."""
    mag = ref.float().abs().clamp_min(2.0**-126)
    ulp = torch.finfo(torch.bfloat16).eps * torch.exp2(torch.floor(torch.log2(mag)))
    return float(((got.float() - ref.float()).abs() - ulp - atol).max())


def agrees(got: torch.Tensor, ref: torch.Tensor, atol: float) -> bool:
    """fp32: within ``atol``; bf16: within one bf16 ulp plus ``atol``."""
    if got.dtype == torch.bfloat16:
        return bf16_excess(got, ref, atol) <= 0.0
    return float((got - ref).abs().max()) <= atol


def library_gru(c: int, h: int, fw, bw, dtype: torch.dtype):
    """``nn.GRU`` on the card with K1's weights, in ``dtype``."""
    lib = torch.nn.GRU(c, h, bidirectional=True, batch_first=True).cuda()
    with torch.no_grad():
        for sfx, d in (("", fw), ("_reverse", bw)):
            for ours, theirs in (("w_ih", "weight_ih_l0"), ("w_hh", "weight_hh_l0"),
                                 ("b_ih", "bias_ih_l0"), ("b_hh", "bias_hh_l0")):
                getattr(lib, theirs + sfx).copy_(d[ours])
    return lib.to(dtype)


def library_time(fn, timer):
    """(ms of the library call ``fn`` by ``timer``, None); (None, why) where
    cuDNN refuses the call; where ``timer`` is ``device_ms`` and the host
    cannot queue the calls ahead of the card (cuDNN cannot keep bf16 RNN
    weights in one block, so ``nn.GRU`` in bf16 copies them at every call),
    the median of per-call CUDA events instead, with that noted.  The
    yardstick is recorded, never replaced."""
    try:
        fn()
        torch.cuda.synchronize()
    except RuntimeError as e:
        return None, "refused: " + str(e).splitlines()[0][:200]
    try:
        return timer(fn), None
    except RuntimeError as e:
        return median_ms(fn, 20), "median of per-call CUDA events (" + str(e) + ")"


def phase_k1(dtype: torch.dtype = torch.float32):
    """K1 against the plain version in ``dtype`` (fp32, or bf16 x with fp32
    parameters); times at the two flagship sweep shapes."""
    name = DTYPE_NAMES[dtype]
    tag = "K1" if dtype == torch.float32 else f"K1 {name}"
    elem = torch.finfo(dtype).bits // 8
    # (label, N, T, C, H, atol).  1e-5 is fp32 noise for a few steps; at T = 64
    # the kernel's and cuBLAS's differently ordered sums compound over 64
    # dependent steps, so 2e-5 there.  bf16 outputs within one bf16 ulp of
    # the plain version's plus the same atol (``agrees``).
    # the first ``timed`` cases are timed: the flagship's sweeps, in bf16 also
    # at batch 512
    cases = [
        ("sweep over W, B=48", BATCH * 16, 64, 64, 32, 2e-5),
        ("sweep over H, B=48", BATCH * 64, 16, 64, 32, 1e-5),
        *([("sweep over W, B=512", 512 * 16, 64, 64, 32, 2e-5), ("sweep over H, B=512", 512 * 64, 16, 64, 32, 1e-5)]
          if dtype == torch.bfloat16 else []),
        ("ragged N", 771, 64, 64, 32, 2e-5),
        ("T=1", 37, 1, 64, 32, 1e-5),
        ("H=8", 100, 20, 16, 8, 1e-5),
        ("H=16", 100, 20, 32, 16, 1e-5),
        ("2 rows a thread, ragged", 1500, 16, 64, 32, 1e-5),
        ("4 rows a thread, ragged", 3070, 16, 64, 32, 1e-5),
        ("T=3 < S", 37, 3, 64, 32, 1e-5),
        ("T=13, not a multiple of S", 45, 13, 64, 32, 1e-5),
    ]
    timed = 4 if dtype == torch.bfloat16 else 2
    stages = gru_seq.BF16_RING_STAGES if dtype == torch.bfloat16 else gru_seq.RING_STAGES
    max_err, shapes = 0.0, []
    for i, (label, n, t, c, h, tol) in enumerate(cases):
        x, fw, bw = gru_case(i, n, t, c, h)
        x = x.to(dtype)
        got = gru_seq.bigru(x, fw, bw)
        torch.cuda.synchronize()
        ref = rnn.bigru(x, fw, bw)
        err = float((got.float() - ref.float()).abs().max())
        check(got.dtype == dtype and torch.isfinite(got).all().item(), f"{tag} {label}: non-finite output")
        check(agrees(got, ref, tol), f"{tag} {label}: max abs err {err:.3g} beyond the tolerance ({tol})")
        cfg = gru_seq.config_for(n, h, x.device, dtype=dtype)
        print(f"{tag} {label}: N={n} T={t} C={c} H={h} {cfg} S={stages} "
              f"max_abs_err={err:.3g} (tol {tol}{' + 1 bf16 ulp' if elem == 2 else ''})", flush=True)
        max_err = max(max_err, err)
        if i >= timed:
            continue
        lib = library_gru(c, h, fw, bw, dtype)
        with torch.no_grad():
            xp = rnn.input_projection(x, fw, bw).contiguous()
            w_hh = torch.stack([fw["w_hh"], bw["w_hh"]]).contiguous()
            b_hh = torch.stack([fw["b_hh"], bw["b_hh"]]).contiguous()
            kernel_args = (xp, *gru_seq._kernel_weights(xp, w_hh, b_hh))  # the kernel alone, weights prepared
            library_ms, library_note = library_time(lambda: lib(x), lambda fn: median_ms(fn, 50))
            library_device_ms, library_device_note = library_time(lambda: lib(x), device_ms)
            row = {
                "label": label, "dtype": name, "N": n, "T": t, "C": c, "H": h, "max_abs_err": err,
                **cfg._asdict(), "stages": stages,
                "ms": median_ms(lambda: gru_seq.bigru(x, fw, bw), 50),
                "plain_ms": median_ms(lambda: rnn.bigru(x, fw, bw), 5, warmup=1),
                "library_ms": library_ms,
                "kernel_only_ms": median_ms(lambda: gru_seq._recurrence(*kernel_args), 50),
                "device_ms": device_ms(lambda: gru_seq.bigru(x, fw, bw)),
                "library_device_ms": library_device_ms,
                "kernel_only_device_ms": device_ms(lambda: gru_seq._recurrence(*kernel_args)),
                "library_max_abs_err": (None if library_ms is None
                                        else float((lib(x)[0].float() - ref.float()).abs().max())),
            }
            row.update({k: v for k, v in (("library_note", library_note), ("library_device_note", library_device_note))
                        if v})
        row["bytes_ms"], row["operations_ms"] = bigru_bound_ms(n, t, c, h, projection=True, elem=elem)
        row.update(bound_fields(row["bytes_ms"], row["operations_ms"]))
        row.update(bound_fields(*bigru_bound_ms(n, t, c, h, projection=False, elem=elem), prefix="kernel_only_"))
        print(f"{tag} timing " + json.dumps(row), flush=True)
        shapes.append(row)

    # every compiled instantiation, forced, on a ragged N at T = 13 and T = 3
    for h in gru_seq.SUPPORTED_HIDDEN:
        x, fw, bw = gru_case(100 + h, 3 * gru_seq.THREADS // h * 4 + 5, 13, 16, h)
        x = x.to(dtype)
        w_hh = torch.stack([fw["w_hh"], bw["w_hh"]])
        b_hh = torch.stack([fw["b_hh"], bw["b_hh"]])
        for t in (13, 3):
            xp = rnn.input_projection(x[:, :t].contiguous(), fw, bw).contiguous()
            ref = rnn.bigru_recurrence(xp, w_hh, b_hh)
            for forced in instantiations(dtype):
                got = gru_seq._recurrence(xp, *gru_seq._kernel_weights(xp, w_hh, b_hh), config=forced)
                torch.cuda.synchronize()
                err = float((got.float() - ref.float()).abs().max())
                check(agrees(got, ref, 1e-5), f"{tag} H={h} {forced} T={t}: max abs err {err:.3g} beyond 1e-5")
                max_err = max(max_err, err)
        print(f"{tag} H={h}: {[f[0] for f in instantiations(dtype)]} at N={x.shape[0]}, T=13 and T=3 agree (1e-5)",
              flush=True)
    return max_err, shapes


def instantiations(dtype: torch.dtype, backward: bool = False):
    """Launch configurations that force each compiled instantiation of K1's
    forward (or backward) in ``dtype`` (a hidden size apart): rows a thread
    in fp32, rows an m-tile in bf16 (the bf16 backward's 8 only)."""
    if dtype == torch.bfloat16:
        return [gru_seq.TileConfig(rows, 0, 0, 0) for rows in gru_seq.TILE_ROWS[:1 if backward else None]]
    return [gru_seq.LaunchConfig(rpt, 0, 0, 0) for rpt in gru_seq.RPTS]


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


def bigru_backward_bound_ms(n: int, t: int, h: int, elem: int = 4, kernel_only: bool = False):
    """(ms for the bytes, ms for the products) of the recurrence's backward,
    (xp, W_hh, b_hh, out, grad_out) -> (dxp, dW_hh, db_hh): reads xp, out and
    grad_out and writes dxp once, each of ``elem`` bytes (4 fp32, 2 bf16),
    with fp32 weights and their gradients; per row-step and direction it runs
    the recompute W_hh h, the product W_hh^T dhp (in fp32, or in bf16 on the
    tensor cores: one term of the bf16 h_{t-1}, three of dhp) and, in fp32,
    dhp^T h for dW_hh.  With ``kernel_only``, the kernel alone: it writes the
    fp32 dhp and h_{t-1} for the GEMM in place of dW_hh and db_hh, and runs
    the first two products."""
    io = elem * n * t * (6 * h + 2 * h + 2 * h + 6 * h)
    gemm = 0.0 if kernel_only else 2 * n * t * 2 * 3 * h * h / PEAK_FP32_FLOP_PER_S
    if kernel_only:
        bytes_moved = io + 4 * n * t * 2 * (3 * h + h) + 4 * 2 * (3 * h * h + 3 * h)
    else:
        bytes_moved = io + 4 * 2 * (2 * 3 * h * h + 2 * 3 * h)
    ops_s = recurrent_product_s(n, t, h, elem, terms=1) + recurrent_product_s(n, t, h, elem) + gemm
    return bytes_moved / PEAK_BYTES_PER_S * 1e3, ops_s * 1e3


def backward_case(seed: int, n: int, t: int, c: int, h: int, dtype: torch.dtype = torch.float32):
    """(x, fw, bw, xp, w_hh, b_hh, out, grad_out) on the card, x, xp, out and
    grad_out in ``dtype``, the weights in fp32."""
    x, fw, bw = gru_case(seed, n, t, c, h)
    x = x.to(dtype)
    xp = rnn.input_projection(x, fw, bw).contiguous()
    w_hh = torch.stack([fw["w_hh"], bw["w_hh"]]).contiguous()
    b_hh = torch.stack([fw["b_hh"], bw["b_hh"]]).contiguous()
    out = gru_seq._launch(xp, w_hh, b_hh)
    grad_out = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal((n, t, 2 * h)).astype(np.float32))
    return x, fw, bw, xp, w_hh, b_hh, out, grad_out.to("cuda", dtype)


def backward_agrees(got, want, atol: float, w_rtol: float):
    """(dxp agrees by ``agrees``, relative errors of dW_hh and db_hh to their
    largest entry, each within ``w_rtol``)."""
    rel = [float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30) for g, w in zip(got[1:], want[1:])]
    return agrees(got[0], want[0], atol) and max(rel) <= w_rtol, rel


def phase_k1_backward(dtype: torch.dtype = torch.float32):
    """K1's backward against the plain BPTT in ``dtype``; times at the two
    flagship sweeps."""
    name = DTYPE_NAMES[dtype]
    tag = "K1 backward" if dtype == torch.float32 else f"K1 backward {name}"
    elem = torch.finfo(dtype).bits // 8
    # dW_hh and db_hh, fp32 sums over N * T row-steps of fp32 terms, at 1e-5
    # of their largest entry in fp32, 1e-4 in bf16 (the terms' inputs are
    # the bf16 dxp's fp32 twins, whose noise compounds as in fp32 but whose
    # h_{t-1} are bf16 values)
    w_rtol = 1e-5 if dtype == torch.float32 else 1e-4
    # (label, N, T, C, H).  dxp at 2e-5, 5e-5 at T = 64 (a reverse chain of 64
    # dependent steps compounds differently ordered fp32 sums); in bf16,
    # within one bf16 ulp of the plain version's plus the same atol
    # the first ``timed`` cases are timed: the flagship's sweeps, in bf16 also
    # at batch 512
    cases = [
        ("sweep over W, B=48", BATCH * 16, 64, 64, 32),
        ("sweep over H, B=48", BATCH * 64, 16, 64, 32),
        *([("sweep over W, B=512", 512 * 16, 64, 64, 32), ("sweep over H, B=512", 512 * 64, 16, 64, 32)]
          if dtype == torch.bfloat16 else []),
        ("ragged N", 771, 64, 64, 32),
        ("T=1", 37, 1, 64, 32),
        ("T=3", 37, 3, 64, 32),
        ("H=8", 100, 20, 16, 8),
        ("H=16", 100, 20, 32, 16),
    ]
    timed = 4 if dtype == torch.bfloat16 else 2
    max_err, shapes = 0.0, []
    for i, (label, n, t, c, h) in enumerate(cases):
        x, fw, bw, xp, w_hh, b_hh, out, grad_out = backward_case(200 + i, n, t, c, h, dtype)
        got = gru_seq.recurrence_backward(xp, w_hh, b_hh, out, grad_out)
        torch.cuda.synchronize()
        want = rnn.bigru_recurrence_backward(xp, w_hh, b_hh, out, grad_out)
        tol = 5e-5 if t >= 64 else 2e-5
        err = float((got[0].float() - want[0].float()).abs().max())
        check(all(torch.isfinite(g).all().item() for g in got), f"{tag} {label}: non-finite output")
        ok, rel = backward_agrees(got, want, tol, w_rtol)
        check(ok, f"{tag} {label}: dxp max abs err {err:.3g} (tol {tol}), dW_hh / db_hh rel err {rel} (tol {w_rtol})")
        print(f"{tag} {label}: N={n} T={t} H={h} dxp max_abs_err={err:.3g} (tol {tol}"
              f"{' + 1 bf16 ulp' if elem == 2 else ''}) dW_hh, db_hh rel_err={rel[0]:.3g}, {rel[1]:.3g} "
              f"(tol {w_rtol})", flush=True)
        max_err = max(max_err, err)
        cfg = gru_seq.config_for(n, h, x.device, backward=True, dtype=dtype)
        print(f"{tag} {label}: launch {cfg}", flush=True)
        if i >= timed:
            continue
        w_t, b_k = gru_seq._kernel_weights(xp, w_hh, b_hh)  # the kernel alone, weights prepared
        leaves = [x.clone().requires_grad_(True), *({k: v.clone().requires_grad_(True) for k, v in d.items()}
                                                    for d in (fw, bw))]

        def fwd_bwd():
            gru_seq.bigru(*leaves).backward(grad_out)

        lib = library_gru(c, h, fw, bw, dtype)
        x_lib = x.clone().requires_grad_(True)

        def lib_fwd_bwd():
            lib(x_lib)[0].backward(grad_out)

        library_ms, library_note = library_time(lib_fwd_bwd, device_ms)
        row = {
            "label": label, "dtype": name, "N": n, "T": t, "C": c, "H": h, "max_abs_err": err,
            "w_b_rel_err": max(rel), **cfg._asdict(),
            "ms": device_ms(lambda: gru_seq.recurrence_backward(xp, w_hh, b_hh, out, grad_out)),
            "kernel_only_ms": device_ms(lambda: gru_seq._backward_kernel(xp, w_t, b_k, out, grad_out)),
            "fwd_bwd_ms": device_ms(fwd_bwd),
            "library_ms": library_ms,
            "plain_ms": median_ms(lambda: rnn.bigru_recurrence_backward(xp, w_hh, b_hh, out, grad_out), 5, warmup=1),
        }
        if library_note:
            row["library_note"] = library_note
        row["bytes_ms"], row["operations_ms"] = bigru_backward_bound_ms(n, t, h, elem)
        row.update(bound_fields(row["bytes_ms"], row["operations_ms"]))
        row.update(bound_fields(*bigru_backward_bound_ms(n, t, h, elem, kernel_only=True), prefix="kernel_only_"))
        print(f"{tag} timing " + json.dumps(row), flush=True)
        shapes.append(row)

    # every compiled instantiation, forced, on a ragged N at T = 13 and T = 3
    for h in gru_seq.SUPPORTED_HIDDEN:
        n = 3 * gru_seq.THREADS // h * 4 + 5
        for t in (13, 3):
            _, _, _, xp, w_hh, b_hh, out, grad_out = backward_case(300 + h + t, n, t, 16, h, dtype)
            kernel_weights = gru_seq._kernel_weights(xp, w_hh, b_hh)
            want = rnn.bigru_recurrence_backward(xp, w_hh, b_hh, out, grad_out)
            for forced in instantiations(dtype, backward=True):
                dxp, dhp, h_prev = gru_seq._backward_kernel(xp, *kernel_weights, out, grad_out, config=forced)
                got = (dxp, *gru_seq.recurrent_weight_grads(dhp, h_prev))
                torch.cuda.synchronize()
                err = float((got[0].float() - want[0].float()).abs().max())
                ok, rel = backward_agrees(got, want, 2e-5, w_rtol)
                check(ok, f"{tag} H={h} {forced} T={t}: dxp max abs err {err:.3g} (tol 2e-5), "
                      f"dW_hh / db_hh rel err {rel} (tol {w_rtol})")
                max_err = max(max_err, err)
        print(f"{tag} H={h}: {[f[0] for f in instantiations(dtype, backward=True)]} at N={n}, T=13 and T=3 agree "
              f"(dxp 2e-5, dW_hh/db_hh {w_rtol})", flush=True)
    return max_err, shapes


def grads_of(module: torch.nn.Module):
    return {k: p.grad.detach().cpu() for k, p in module.named_parameters() if p.grad is not None}


def check_card_grads(name: str, card: torch.nn.Module, cpu: torch.nn.Module, tol: float, floor: float = 0.0,
                     no_grad=(), tensor_tol=None):
    """One model's gradients and BatchNorm statistics after a step, card
    against CPU: the model's gradient (the pre-BN biases apart) at ``tol`` of
    its norm; each pre-BN bias's at 1e-4 of the model's norm (zero in exact
    arithmetic); each other gradient at ``tensor_tol`` (``tol`` unless
    given) of its own norm plus ``floor`` of the model's; each running
    statistic at rtol 1e-4, atol 1e-5.  Every parameter has a gradient on both devices but those whose names
    hold a part of ``no_grad`` (reaching no loss), which have none on either.
    Returns {name: the model's relative error, name.key: each tensor's}."""
    ga, gb = grads_of(card), grads_of(cpu)
    want = sorted(k for k, _ in cpu.named_parameters() if not any(part in k for part in no_grad))
    check(sorted(ga) == sorted(gb) == want, f"{name}: gradients missing or unexpected")
    total = float(torch.sqrt(sum(g.pow(2).sum() for g in gb.values())))
    diff = float(torch.sqrt(sum((ga[k] - gb[k]).pow(2).sum() for k in gb if not PRE_BN_BIAS.search(k))))
    check(diff <= tol * total, f"train {name}: gradient rel err {diff / total:.3g} > {tol}")
    errs = {name: diff / total}
    for k in gb:
        if PRE_BN_BIAS.search(k):
            check(float(ga[k].norm()) <= 1e-4 * total, f"train {name}.{k}: pre-BN bias gradient not ~0")
            continue
        err, own = float((ga[k] - gb[k]).norm()), float(gb[k].norm())
        t = tol if tensor_tol is None else tensor_tol
        check(err <= t * own + floor * total, f"train {name}.{k}: gradient err {err:.3g} > {t} x its norm "
              f"{own:.3g} + {floor} x the model's {total:.3g}")
        errs[f"{name}.{k}"] = err / max(own, 1e-30)
    sa, sb = card.state_dict(), cpu.state_dict()
    for k in sb:
        if "running" in k:
            check(torch.allclose(sa[k].cpu(), sb[k], rtol=1e-4, atol=1e-5), f"train {name}.{k}: BN statistic")
    return errs


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
    worst = {**check_card_grads("sr", card.sr[0], cpu.sr[0], 5e-3),
             **check_card_grads("stu", card.stu[0], cpu.stu[0], 3e-2)}
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:5]
    print(f"train card vs CPU (batch {CARD_VS_CPU_TRAIN_BATCH}): losses "
          f"{ {k: float(v) for k, v in m_card.items()} }; worst gradient rel errs {top}", flush=True)


def phase_train(compute_dtype: str = "fp32"):
    """20 flagship train steps at batch 48 on synthetic batches, the models
    in ``compute_dtype``."""
    rng = np.random.default_rng(4)
    batches = [synthetic_batch(rng, BATCH, labels=False) for _ in range(TRAIN_WARMUP + TRAIN_STEPS)]
    state, step = entry.flagship_train(device="cuda", seed=0, compute_dtype=compute_dtype)
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
    train = {"compute_dtype": compute_dtype, "batch": BATCH, "steps": TRAIN_STEPS,
             "images_per_s": BATCH * TRAIN_STEPS / event_s,
             "ms_per_step": event_s * 1e3 / TRAIN_STEPS, "event_s": event_s, "host_s": host_s,
             "k1_launches": launches, "k1_backward_launches": backward_launches,
             "loss_first": losses[0], "loss_last": losses[-1],
             "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    print("train " + json.dumps(train), flush=True)
    return launches, backward_launches, train


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


def phase_data(root: str, serve_ips: float, train_ips: float):
    """Phase 9 under ``root``; returns (train, eval, train dirs, val dirs)."""
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
    return train, ev, train_dirs, val_dirs


# phase 10: an epoch of 22 batches (phase 9's train LMDBs), val and a save
# every 11 iterations
TRAINER_PAIRS = TRAIN_PAIRS
TRAINER_EPOCH = TRAINER_PAIRS // BATCH
TRAINER_INTERVAL = TRAINER_EPOCH // 2
TRAINER_FLAGS = ["--arch", "tsrn_tl_cascade", "--STN", "--mask", "--use_distill", "--gradient", "--sr_share",
                 "--stu_iter=1", "--vis_dir", "smoke"]
DEMO_WORDS = ("scene", "Text", "zoom42", "prior")
SAVE_FILES = ("checkpoint_0.pth", "recognizer_0.pth", "opt_state.pth", "info.json")


class TrainerProbe:
    """What phases 10 and 12 read of a ``TextSR`` run, by wrappers installed
    for one run: the first two train steps' metrics, the first batch, the
    end of the first step with K1's counts there, each step's compute dtype,
    and each val's and save's start and end (the card synchronized at both)
    with K1's counts there and the val's metric dicts."""

    def __init__(self):
        self.metrics, self.first_batch, self.first_step_end, self.events = [], None, None, []
        self.first_step_counts, self.compute_dtypes = None, []

    @contextlib.contextmanager
    def installed(self):
        make, run_val, save = trainer.make_train_step, trainer.TextSR._run_val, trainer.TextSR._save

        def make_train_step(*a, **k):
            step = make(*a, **k)
            self.compute_dtypes.append(k.get("compute_dtype", "fp32"))

            def recorded(state, batch):
                metrics = step(state, batch)
                if not self.metrics:
                    torch.cuda.synchronize()
                    self.first_step_end = time.perf_counter()
                    self.first_step_counts = (gru_seq.LAUNCHES, gru_seq.BACKWARD_LAUNCHES)
                    self.first_batch = {"labels": list(batch["labels"]), "hr": batch["hr"].clone()}
                if len(self.metrics) < 2:
                    self.metrics.append(metrics)
                return metrics

            return recorded

        def timed(name, method):
            def run(mission, *a, **k):
                torch.cuda.synchronize()
                t0, counts0 = time.perf_counter(), (gru_seq.LAUNCHES, gru_seq.BACKWARD_LAUNCHES)
                out = method(mission, *a, **k)
                torch.cuda.synchronize()
                self.events.append({"name": name, "t0": t0, "t1": time.perf_counter(), "counts0": counts0,
                                    "counts1": (gru_seq.LAUNCHES, gru_seq.BACKWARD_LAUNCHES), "out": out})
                return out

            return run

        trainer.make_train_step = make_train_step
        trainer.TextSR._run_val, trainer.TextSR._save = timed("val", run_val), timed("save", save)
        try:
            yield self
        finally:
            trainer.make_train_step, trainer.TextSR._run_val, trainer.TextSR._save = make, run_val, save

    def window(self):
        """(seconds, K1 forward and backward launches) of the train iterations
        between the end of the first val's saves and the start of the second
        val."""
        second_val = [e for e in self.events if e["name"] == "val"][1]
        last = max((e for e in self.events if e["t1"] <= second_val["t0"]), key=lambda e: e["t1"])
        launches = [b - a for a, b in zip(last["counts1"], second_val["counts0"])]
        return second_val["t0"] - last["t1"], launches


def check_metric_dicts(got, want, what):
    """PSNR and SSIM at phase 4's rtol (1e-4), everything else equal."""
    check(sorted(got) == sorted(want), f"{what}: keys {sorted(got)} vs {sorted(want)}")
    for k, v in want.items():
        if k in ("psnr_avg", "ssim_avg"):
            ok = np.isfinite(got[k]) and abs(got[k] - v) <= 1e-4 * abs(v)
        else:
            ok = k == "fps" or got[k] == v
        check(ok, f"{what} {k}: card {got[k]} vs CPU {v}")


def phase_trainer(root: str, train_dirs, val_dirs, lmdb_train_ips: float):
    """Phase 10: ``python -m tpgsr_tpu_torch.cli`` in-process on the card, at
    the flagship's full width, batch 48, fp32, in ``root``, over phase 9's
    train LMDBs:

    1. one epoch (22 iterations, val and a save at 11 and 22) from a config
       with ``compute_dtype: fp32``, started with TF32 on for cuBLAS and
       cuDNN: the entry point turns both off; the files it writes, the first two
       iterations' losses against a CPU ``TextSR`` from the same seed and
       batches (1e-5, then 1e-4: one Adam update apart, the bound the CPU
       tests hold the port's second step to against JAX);
    2. ``--resume`` for one more epoch: the step reaches 44 and the first
       batch is global epoch 2's;
    3. ``--go_test``, ``--test --rec crnn`` over the easy split and ``--demo``
       over four PNGs, each from the checkpoint, against the same command on
       the CPU;
    4. the ``trainer`` line: images/s between the first val and the end
       (synchronized wall time, val and save excluded), the first
       iteration, a val, a save and its bytes, ``--test``'s fps, K1's
       launches in that window."""
    t0 = time.perf_counter()
    check(len(ConcatDataset([TextZoomDataset(d) for d in train_dirs])) == TRAINER_PAIRS, "trainer pairs")
    demo_dir = f"{root}/demo_imgs"
    os.makedirs(demo_dir)
    for i, word in enumerate(DEMO_WORDS):
        render_word(word, (96 + 16 * i, 28 + 2 * i), seed=50 + i).save(f"{demo_dir}/{i}_{word}.png")
    cfg = load_config()
    t = cfg.TRAIN
    t.update(train_data_dir=train_dirs, batch_size=BATCH, compute_dtype="fp32", epochs=1,
             saveInterval=TRAINER_INTERVAL, displayInterval=TRAINER_INTERVAL // 2, workers=1,
             ckpt_dir=f"{root}/ckpt")
    t.VAL.update(val_data_dir=list(val_dirs), valInterval=TRAINER_INTERVAL)
    config_path = f"{root}/trainer.yaml"
    with open(config_path, "w") as f:
        json.dump(cfg, f)  # JSON is YAML
    argv = TRAINER_FLAGS + ["--config", config_path]
    ckpt_dir = f"{root}/ckpt/smoke"
    print(f"trainer: wrote the config and {len(DEMO_WORDS)} demo images in {time.perf_counter() - t0:.1f} s",
          flush=True)
    cwd = os.getcwd()
    os.chdir(root)
    try:
        return trainer_runs(argv, ckpt_dir, train_dirs, val_dirs, demo_dir, lmdb_train_ips)
    finally:
        os.chdir(cwd)


def trainer_runs(argv, ckpt_dir, train_dirs, val_dirs, demo_dir, lmdb_train_ips: float):
    n_val_batches = sum(-(-n // BATCH) for n in VAL_PAIRS)
    # 1. one epoch through the CLI
    probe = TrainerProbe()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    gru_seq.LAUNCHES = 0
    gru_seq.BACKWARD_LAUNCHES = 0
    start = time.perf_counter()
    with probe.installed():
        state = cli.main(argv)
    torch.cuda.synchronize()
    check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32,
          "the trainer left TF32 on")
    run_launches = (gru_seq.LAUNCHES, gru_seq.BACKWARD_LAUNCHES)
    check(state.step == TRAINER_EPOCH, f"trainer at step {state.step}, expected {TRAINER_EPOCH}")
    want = (2 * N_SRB * (TRAINER_EPOCH + 2 * n_val_batches), 2 * N_SRB * TRAINER_EPOCH)
    check(run_launches == want, f"K1 launched {run_launches} times (forward, backward) in the trainer, expected {want}")
    for name in SAVE_FILES:
        check(os.path.exists(f"{ckpt_dir}/{name}"), f"trainer wrote no {name}")
    with open(f"{ckpt_dir}/info.json") as f:
        info = json.load(f)
    check(info["step"] == TRAINER_EPOCH and info["arch"] == "tsrn_tl_cascade"
          and {"easy", "medium", "hard"} <= set(info["best_history_res"]), f"info.json: {info}")
    with open("tensorboard/smoke/scalars.jsonl") as f:
        records = [json.loads(line) for line in f]
    tags = {r["tag"] for r in records}
    want_tags = {"loss/total", "loss/SR", "loss/distill"} | {f"eval/{k}_{s}" for k in ("psnr_avg", "ssim_avg", "accuracy")
                                                              for s in ("easy", "medium", "hard")}
    check(tags == want_tags, f"scalar tags {sorted(tags)}")
    check(all(np.isfinite(r["value"]) for r in records), "a non-finite logged scalar")
    window_s, window_launches = probe.window()
    want = 2 * N_SRB * (TRAINER_EPOCH - TRAINER_INTERVAL)
    check(window_launches == [want, want], f"K1 launched {window_launches} times in the train window, expected {want}")
    vals = [e for e in probe.events if e["name"] == "val"]
    saves = [e for e in probe.events if e["name"] == "save"]
    card = [{k: float(v) for k, v in m.items()} for m in probe.metrics]
    first_batch = probe.first_batch
    out = {"batch": BATCH, "epoch_iterations": TRAINER_EPOCH,
           "window_iterations": TRAINER_EPOCH - TRAINER_INTERVAL, "window_s": window_s,
           "images_per_s": BATCH * (TRAINER_EPOCH - TRAINER_INTERVAL) / window_s,
           "lmdb_train_images_per_s": lmdb_train_ips,
           "first_iteration_s": probe.first_step_end - start, "run_s": time.perf_counter() - start,
           "val_s": vals[-1]["t1"] - vals[-1]["t0"], "first_val_s": vals[0]["t1"] - vals[0]["t0"],
           "save_s": saves[-1]["t1"] - saves[-1]["t0"],
           "save_bytes": sum(os.path.getsize(f"{ckpt_dir}/{name}") for name in SAVE_FILES),
           "k1_launches": window_launches[0], "k1_backward_launches": window_launches[1],
           "run_k1_launches": run_launches[0], "run_k1_backward_launches": run_launches[1]}
    del state

    # the first two iterations on the CPU, from the same seed and batches
    args = AttrDict(vars(build_arg_parser().parse_args(argv)))
    cpu_cfg = load_config(argv[-1])
    cpu_cfg.TRAIN.workers = 0
    cpu = trainer.TextSR(cpu_cfg, args, device="cpu")
    cpu_state = cpu.init_state()
    cpu._build_steps()
    loader = cpu.get_train_data()
    loader.batch_sampler.epoch = 0
    batches = iter(loader)
    cpu_losses = [{k: float(v) for k, v in cpu._train_step(cpu_state, next(batches)).items()} for _ in range(2)]
    del batches, loader, cpu, cpu_state
    for i, rtol in enumerate((1e-5, 1e-4)):
        for k, v in cpu_losses[i].items():
            check(np.isfinite(card[i][k]) and abs(card[i][k] - v) <= rtol * abs(v),
                  f"trainer iteration {i + 1} {k}: card {card[i][k]} vs CPU {v} (rtol {rtol})")
    out["card_losses"], out["cpu_losses"] = card, cpu_losses
    print(f"trainer card vs CPU: iterations 1-2 losses card {card} CPU {cpu_losses}", flush=True)

    # 2. resume for one more epoch
    probe = TrainerProbe()
    with probe.installed():
        state = cli.main(argv + ["--resume", ckpt_dir])
    check(state.step == 2 * TRAINER_EPOCH, f"resumed trainer at step {state.step}")
    with open(f"{ckpt_dir}/info.json") as f:
        check(json.load(f)["step"] == 2 * TRAINER_EPOCH, "info.json after the resume")
    ref_loader = trainer.train_loader(train_dirs, "tsrn_tl_cascade", mask=True, **loader_kw(BATCH, "cpu", workers=0))
    ref_loader.batch_sampler.epoch = 1
    ref = next(iter(ref_loader))
    check(probe.first_batch["labels"] == list(ref["labels"]) and torch.equal(probe.first_batch["hr"], ref["hr"]),
          "the first resumed batch is not global epoch 2's")
    print(f"trainer resumed to step {state.step}; first batch is global epoch 2's", flush=True)
    del state

    # 3. the eval-only modes from the checkpoint, card against CPU
    eval_argv = argv + ["--resume", ckpt_dir]
    modes = {}
    for dev in ("cuda", "cpu"):
        go = cli.main(eval_argv + ["--go_test", "--vis_dir", f"go_{dev}"], device=dev)
        test = cli.main(eval_argv + ["--test", "--rec", "crnn", "--test_data_dir", val_dirs[0]], device=dev)
        demo = cli.main(eval_argv + ["--demo", "--demo_dir", demo_dir], device=dev)
        modes[dev] = (go, test, demo, sorted(os.listdir(f"demo/go_{dev}/1")))
    (go, test, demo, vis), (cpu_go, cpu_test, cpu_demo, cpu_vis) = modes["cuda"], modes["cpu"]
    check(list(go) == ["easy", "medium", "hard"], f"--go_test splits {list(go)}")
    for name in go:
        check_metric_dicts(go[name], cpu_go[name], f"--go_test {name}")
    check_metric_dicts(test, cpu_test, "--test")
    check(test["images"] == VAL_PAIRS[0] and test["fps"] > 0, f"--test: {test}")
    check(demo == cpu_demo and len(demo) == len(DEMO_WORDS), f"--demo card {demo} vs CPU {cpu_demo}")
    check(vis and vis == cpu_vis, "--go_test visualizations differ")
    print(f"trainer modes: --go_test {json.dumps(go)}; --test {json.dumps(test)}; --demo {demo}; card equals CPU",
          flush=True)
    out["test_fps"] = test["fps"]
    print(json.dumps({"trainer": out}), flush=True)
    return out


def grad_rel(got, want, keys) -> float:
    """Relative L2 error of the gradients ``keys`` of ``got`` against ``want``."""
    num = sum(float((got[k] - want[k]).pow(2).sum()) for k in keys)
    return (num / max(sum(float(want[k].pow(2).sum()) for k in keys), 1e-30)) ** 0.5


def grad_cos(got, want, keys) -> float:
    a = torch.cat([got[k].flatten() for k in keys])
    b = torch.cat([want[k].flatten() for k in keys])
    return float(torch.nn.functional.cosine_similarity(a, b, dim=0))


# card bf16 against CPU bf16 (the same arithmetic, rounded at other places by
# cuDNN and oneDNN): loss_img and loss_total at 1e-3 (measured 1e-4),
# loss_distill, without labels 0.07 % of the total and a sum of
# |teacher - student| terms that bf16 flips in sign where the two nearly tie,
# at 1e-2 (measured 2e-3)
BF16_LOSS_RTOL = {"loss_img_0": 1e-3, "loss_img": 1e-3, "loss_total": 1e-3, "loss_distill": 1e-2}
CTC_LABEL_LEN = 15  # collate_real_wtl_amask's max_label_len


def with_ctc_labels(batch):
    """``batch`` with its words encoded as ``--use_label``'s keys, as
    collate_real_wtl_amask encodes them (every synthetic word has a label)."""
    words = batch["labels"]
    ids = [[CTC_CHAR_TO_ID[ch] for ch in w] for w in words]
    return {"hr": batch["hr"], "lr": batch["lr"],
            "ctc_labels": np.array([x + [0] * (CTC_LABEL_LEN - len(x)) for x in ids], np.int32),
            "ctc_lengths": np.array([len(x) for x in ids], np.int32),
            "weighted_tics": np.ones(len(words), np.float32)}


def bf16_step_runs(args, batch):
    """{card_fp32, card_bf16, cpu_bf16: (losses, gradients, K1 launches)} of
    one step of ``args`` from the flagship's seeded state."""
    runs = {}
    for name, dev, dtype in (("card_fp32", "cuda", "fp32"), ("card_bf16", "cuda", "bf16"), ("cpu_bf16", "cpu", "bf16")):
        state, _ = entry.flagship_train(device=dev, seed=0, compute_dtype=dtype)
        step = make_train_step(args, entry.TRAIN_WIDTH, device=dev, compute_dtype=dtype)
        gru_seq.LAUNCHES = gru_seq.BACKWARD_LAUNCHES = 0
        losses = {k: float(v) for k, v in step(state, batch).items()}
        grads = {f"{m}.{k}": g for m, model in (("sr", state.sr[0]), ("stu", state.stu[0]))
                 for k, g in grads_of(model).items()}
        runs[name] = (losses, grads, (gru_seq.LAUNCHES, gru_seq.BACKWARD_LAUNCHES))
        del state, step
    return runs


def phase_train_bf16_card_vs_cpu():
    """(a) One bf16 train step at batch 8 on the card, from the same seeded
    weights and batch as the card's fp32 step and the CPU's bf16 step, with
    the flagship's arguments and with ``--use_label`` added:

    * the bf16 losses within 5 % of fp32 (as tests/test_train.py holds the
      JAX package's bf16 step), and at ``BF16_LOSS_RTOL`` of the CPU's bf16;
    * every gradient finite and fp32, K1 launched 10 times each way;
    * each model's gradient (the pre-BN biases apart, whose exact value is
      zero) as close to fp32 as the CPU's bf16 step is, which
      tests/test_torch_bf16.py holds to the JAX package's bf16 step:
      relative L2 errors E_card <= 2 E_cpu + 1e-2 against fp32; closer to
      the CPU's bf16 gradient than bf16 is to fp32 (the relative L2 error
      between card and CPU at most E_cpu / 2 + 1e-2 with the flagship's
      arguments, E_cpu + 1e-2 with ``--use_label``); and a cosine to fp32 of
      at least half the CPU's, so a zeroed or negated gradient fails.
    * With ``--use_label`` the CTC term sets the student's gradient, which
      bf16 then moves about 0.22 from fp32 on either device, so the bound
      2 E_cpu + 1e-2 must stay below 1 for both models: a zeroed, negated or
      random gradient fails it.  Card and CPU round the student's seven
      convolutions differently (cuDNN against oneDNN) and the backward
      carries that through the trunk: they lie 0.16 apart, most of it in
      the conv weights' gradients, while each lies 0.22 from fp32 with a
      cosine of 0.976; independent roundings would lie ~0.31 apart, so the
      pair bound there is E_cpu + 1e-2.  Without labels the student's gradient is
      the distillation's |teacher - student| signs, which bf16 flips where
      the two nearly tie (relative error 1.1, cosine 0.3 on the CPU: the JAX
      package's bf16 step gives the same, ``python -m tests.test_torch_bf16``),
      and only the cosine and the card-to-CPU bound can fail there.  No
      gradient is held to a cosine of 0.99 against fp32: bf16 itself moves
      the SR model's to 0.95 in both packages (the backward of the final
      tanh reads 1 - y^2 of a bf16 y near 1)."""
    base = synthetic_batch(np.random.default_rng(3), CARD_VS_CPU_TRAIN_BATCH)
    out = {"batch": CARD_VS_CPU_TRAIN_BATCH}
    for case, args, batch, pair in (("flagship", entry.FLAGSHIP_ARGS, {"hr": base["hr"], "lr": base["lr"]}, 0.5),
                                    ("use_label", {**entry.FLAGSHIP_ARGS, "use_label": True}, with_ctc_labels(base),
                                     1.0)):
        runs = bf16_step_runs(args, batch)
        (l32, g32, _), (l16, g16, launched), (lcpu, gcpu, _) = runs["card_fp32"], runs["card_bf16"], runs["cpu_bf16"]
        check(launched == (2 * N_SRB, 2 * N_SRB), f"{case} bf16 train step launched K1 {launched} times, expected 10 "
              "each way")
        for k, v in l16.items():
            check(np.isfinite(v) and abs(v - l32[k]) <= 0.05 * abs(l32[k]), f"{case} bf16 {k} {v} vs fp32 {l32[k]}: "
                  "beyond 5 %")
            check(abs(v - lcpu[k]) <= BF16_LOSS_RTOL[k] * abs(lcpu[k]),
                  f"{case} bf16 {k}: card {v} vs CPU {lcpu[k]} beyond rtol {BF16_LOSS_RTOL[k]}")
        check(sorted(g16) == sorted(g32) == sorted(gcpu), f"{case} bf16 train step: gradients missing")
        check(all(g.dtype == torch.float32 and torch.isfinite(g).all().item() for g in g16.values()),
              f"{case} bf16 train step: a gradient is not finite fp32")
        out[case] = {"card_bf16": l16, "card_fp32": l32, "cpu_bf16": lcpu}
        for model in ("sr", "stu"):
            keys = [k for k in g32 if k.startswith(model + ".") and not PRE_BN_BIAS.search(k.split(".", 1)[1])]
            e_card, e_cpu, e_pair = grad_rel(g16, g32, keys), grad_rel(gcpu, g32, keys), grad_rel(g16, gcpu, keys)
            cos_card, cos_cpu = grad_cos(g16, g32, keys), grad_cos(gcpu, g32, keys)
            check(e_card <= 2 * e_cpu + 1e-2, f"{case} bf16 {model} gradients: card rel err {e_card:.3g} against fp32, "
                  f"CPU bf16's {e_cpu:.3g}")
            check(e_pair <= pair * e_cpu + 1e-2, f"{case} bf16 {model} gradients: card rel err {e_pair:.3g} against the "
                  f"CPU's bf16, which lies {e_cpu:.3g} from fp32")
            check(cos_card >= cos_cpu / 2, f"{case} bf16 {model} gradients: cosine {cos_card:.3g} to fp32, the CPU's "
                  f"bf16 {cos_cpu:.3g}")
            if case == "use_label":
                check(2 * e_cpu + 1e-2 < 1, f"{case} bf16 {model} gradients: the CPU's bf16 lies {e_cpu:.3g} from "
                      "fp32, so the bound 2 E_cpu + 1e-2 would pass a zeroed gradient")
            out[case][model] = {"rel_err_vs_fp32": e_card, "cpu_rel_err_vs_fp32": e_cpu, "rel_err_vs_cpu_bf16": e_pair,
                                "cos_vs_fp32": cos_card, "cpu_cos_vs_fp32": cos_cpu,
                                "cos_vs_cpu_bf16": grad_cos(g16, gcpu, keys)}
    print("bf16 train card vs CPU " + json.dumps(out), flush=True)


def phase_train_bf16(fp32_train):
    """Phase 11: (a) the bf16 step against fp32 and the CPU; (b) 20 bf16 train
    steps at batch 48, with phase 8's fp32 run beside them."""
    phase_train_bf16_card_vs_cpu()
    launches, backward_launches, train = phase_train("bf16")
    out = {"bf16_images_per_s": train["images_per_s"], "fp32_images_per_s": fp32_train["images_per_s"],
           "bf16_ms_per_step": train["ms_per_step"], "fp32_ms_per_step": fp32_train["ms_per_step"],
           "bf16_peak_mem_gib": train["peak_mem_gib"], "fp32_peak_mem_gib": fp32_train["peak_mem_gib"],
           "k1_launches": launches, "k1_backward_launches": backward_launches}
    print("train bf16 " + json.dumps(out), flush=True)
    return launches, backward_launches, out


def phase_packaged_yaml(root: str, train_dirs, val_dirs):
    """Phase 12: the packaged YAML as it is (compute_dtype 'bf16') through
    ``cli.main`` in ``root`` over phase 9's TextZoom (22 batches of 48), TF32
    on first: the entry point turns it off; a val and a save at iteration
    22; the first iteration's losses against a CPU ``TextSR`` on the same
    YAML at ``BF16_LOSS_RTOL``; the val's metric dicts equal the fp32 eval
    step's on the saved weights (PSNR and SSIM at 1e-4); the loop's images/s
    and K1's launches between the end of the first iteration and the val."""
    cfg = load_config()
    check(cfg.TRAIN.compute_dtype == "bf16", f"the packaged YAML says compute_dtype {cfg.TRAIN.compute_dtype}")
    iterations = TRAIN_PAIRS // BATCH
    cfg.TRAIN.update(train_data_dir=list(train_dirs), batch_size=BATCH, epochs=1, saveInterval=iterations,
                     displayInterval=iterations // 2, workers=1, ckpt_dir=f"{root}/ckpt_packaged")
    cfg.TRAIN.VAL.update(val_data_dir=list(val_dirs), valInterval=iterations)
    config_path = f"{root}/packaged.yaml"
    with open(config_path, "w") as f:
        json.dump(cfg, f)  # JSON is YAML
    argv = TRAINER_FLAGS[:-1] + ["smoke_packaged", "--config", config_path]
    ckpt_dir = f"{root}/ckpt_packaged/smoke_packaged"
    n_val_batches = sum(-(-n // BATCH) for n in VAL_PAIRS)
    cwd = os.getcwd()
    os.chdir(root)
    try:
        probe = TrainerProbe()
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        gru_seq.LAUNCHES = 0
        gru_seq.BACKWARD_LAUNCHES = 0
        start = time.perf_counter()
        with probe.installed():
            state = cli.main(argv)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - start
        check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32,
              "the trainer left TF32 on under the packaged YAML")
        check(probe.compute_dtypes == ["bf16"], f"the train step ran in {probe.compute_dtypes}")
        check(state.step == iterations, f"packaged YAML: trainer at step {state.step}, expected {iterations}")
        run_launches = (gru_seq.LAUNCHES, gru_seq.BACKWARD_LAUNCHES)
        want = (2 * N_SRB * (iterations + n_val_batches), 2 * N_SRB * iterations)
        check(run_launches == want, f"packaged YAML: K1 launched {run_launches} times, expected {want}")
        (val,) = [e for e in probe.events if e["name"] == "val"]
        window_s = val["t0"] - probe.first_step_end
        window = [b - a for a, b in zip(probe.first_step_counts, val["counts0"])]
        want = 2 * N_SRB * (iterations - 1)
        check(window == [want, want], f"packaged YAML: K1 launched {window} times in the window, expected {want}")
        card = {k: float(v) for k, v in probe.metrics[0].items()}
        del state

        # the first iteration on the CPU, from the same seed and batch
        args = AttrDict(vars(build_arg_parser().parse_args(argv)))
        cpu_cfg = load_config(config_path)
        cpu_cfg.TRAIN.workers = 0
        cpu = trainer.TextSR(cpu_cfg, args, device="cpu")
        cpu_state = cpu.init_state()
        cpu._build_steps()
        loader = cpu.get_train_data()
        loader.batch_sampler.epoch = 0
        cpu_losses = {k: float(v) for k, v in cpu._train_step(cpu_state, next(iter(loader))).items()}
        del loader, cpu, cpu_state
        for k, v in cpu_losses.items():
            check(np.isfinite(card[k]) and abs(card[k] - v) <= BF16_LOSS_RTOL[k] * abs(v),
                  f"packaged YAML iteration 1 {k}: card {card[k]} vs CPU {v} (rtol {BF16_LOSS_RTOL[k]})")

        # the val against the fp32 eval step on the saved weights
        mission = trainer.TextSR(load_config(config_path), AttrDict(vars(build_arg_parser().parse_args(
            argv + ["--resume", ckpt_dir]))))
        saved = mission.init_state()
        mission._build_steps(with_train=False)
        models = mission._eval_models(saved)
        for d, loader in zip(val_dirs, mission.get_val_data()):
            name = trainer.split_name(d)
            check_metric_dicts(evaluate(mission._eval_step, models, loader), val["out"][name],
                               f"packaged YAML val {name} against the fp32 eval step on the saved weights")
        del mission, saved, models
    finally:
        os.chdir(cwd)
    out = {"compute_dtype": "bf16", "batch": BATCH, "iterations": iterations, "window_iterations": iterations - 1,
           "window_s": window_s, "images_per_s": BATCH * (iterations - 1) / window_s,
           "first_iteration_s": probe.first_step_end - start, "run_s": run_s, "val_s": val["t1"] - val["t0"],
           "k1_launches": window[0], "k1_backward_launches": window[1], "card_losses": card, "cpu_losses": cpu_losses}
    print(json.dumps({"packaged_yaml": out}), flush=True)
    return out


# phase 13: the SR zoo of the repo's other train scripts, with each script's
# flags (its --vis_dir aside)
ZOO_SCRIPTS = ("train_TSRN.sh", "train_SRCNN.sh", "train_TPGSR-SRCNN.sh", "train_SRResNet.sh",
               "train_TPGSR-SRResNet.sh", "train_RDN.sh", "train_TPGSR-RDN.sh")
ZOO_EVAL_BATCHES = 4


def zoo_argv(name: str):
    """The flags of the checkout's script ``name``, without its ``--vis_dir``."""
    argv = script_argv(os.path.join(os.path.dirname(os.path.abspath(__file__)), name))
    return [a for a in argv if not a.startswith("--vis_dir")]


def zoo_card_vs_cpu(argv, batch):
    """(a) The eval step, then one fp32 train step, on the card and on the CPU
    from the same weights and batch: ``sr`` at 5e-4, ``mse`` and ``ssim`` at
    1e-4, logits at 2e-4 and their strings equal (phase 4's bounds); the
    losses at rtol 1e-5, each model's gradient at 5e-3 of its norm (3e-2 in
    a student), the pre-BN biases at 1e-4 of their model's norm, the
    BatchNorm statistics at rtol 1e-4 (phase 7's bounds); each other
    gradient at 5e-3 (3e-2) of its own norm plus 1e-6 of its model's.  The
    floor is for the few tensors whose gradient is a sum that cancels to a
    sliver of the model's: SRResNet's PReLU slopes after BatchNorm come to
    under 2e-5 of the model's norm (``python -m tests.torch_fp64_noise``),
    so a relative noise of 1e-6 in the convolutions that feed those sums
    (cuDNN runs them through its FFT path here) can part card and CPU by
    a few hundredths of the slopes' own norm while the models' gradients
    agree to 1e-5.  ``sem_tsrn``'s word-vector projections reach no loss and
    have no gradient on either device.  The line reports the PReLU slopes'
    largest error, relative to their own norm."""
    card, card_state, card_models = zoo_mission(argv, device="cuda")
    cpu, cpu_state, cpu_models = zoo_mission(argv, device="cpu")
    out = {}
    (sr_g, outs_g), (sr_c, outs_c) = card._eval_step(card_models, batch), cpu._eval_step(cpu_models, batch)
    check(sr_g.shape == sr_c.shape and torch.isfinite(sr_g).all().item(), f"eval sr {tuple(sr_g.shape)} not finite")
    out["eval_sr_max_abs_err"] = float((sr_g.cpu() - sr_c).abs().max())
    check(out["eval_sr_max_abs_err"] <= 5e-4, f"eval sr card vs CPU: {out['eval_sr_max_abs_err']:.3g} > 5e-4")
    check(sorted(outs_g) == sorted(outs_c), "eval outputs differ in keys")
    for k in outs_c:
        if k.startswith("logits_"):
            err = float((outs_g[k].cpu() - outs_c[k]).abs().max())
            check(err <= 2e-4 and decode_crnn(outs_g[k]) == decode_crnn(outs_c[k]), f"eval {k} card vs CPU: {err:.3g}")
            out["eval_logits_max_abs_err"] = max(out.get("eval_logits_max_abs_err", 0.0), err)
        else:
            check(torch.allclose(outs_g[k].cpu(), outs_c[k], rtol=1e-4, atol=1e-4), f"eval {k} card vs CPU")
    gru_seq.LAUNCHES = gru_seq.BACKWARD_LAUNCHES = 0
    m_card = card._train_step(card_state, batch)
    out["k1_train_step_launches"] = (gru_seq.LAUNCHES, gru_seq.BACKWARD_LAUNCHES)
    m_cpu = cpu._train_step(cpu_state, batch)
    for k in m_cpu:
        got, want = float(m_card[k]), float(m_cpu[k])
        check(np.isfinite(got) and abs(got - want) <= 1e-5 * abs(want), f"train {k}: card {got} vs CPU {want}")
    out["losses"] = {k: float(v) for k, v in m_card.items()}
    opt = card.tpg == "OPT"
    pairs = [(f"sr{i}", a, b, 5e-3, OPT_SR_TENSOR_TOL if opt else None)
             for i, (a, b) in enumerate(zip(card_state.sr, cpu_state.sr)) if list(b.parameters())]  # bicubic has none
    pairs += [(f"stu{i}", a, b, OPT_STUDENT_GRAD_TOL if opt else 3e-2, None)
              for i, (a, b) in enumerate(zip(card_state.stu, cpu_state.stu))]
    for name, a, b, tol, tensor_tol in pairs:
        errs = check_card_grads(name, a, b, tol, floor=1e-6, no_grad=NO_GRAD.get(card.arch, ()), tensor_tol=tensor_tol)
        out[f"{name}_grad_rel_err"] = errs.pop(name)
        out[f"{name}_worst_tensor_rel_err"] = max(errs.values())
        prelu = [e for k, e in errs.items() if k.endswith(PRELU_KEYS)]
        if prelu:
            out[f"{name}_prelu_rel_err"] = max(prelu)
    return out


# The OPT flagship's gradients (phase 16): fp32 lies 2.2e-2 from fp64 in the
# OPT student on the CPU at phase 16(a)'s size, weights and batch, the worst
# tensor 3.1e-2, and its prior carries that noise into the SR model's
# InfoGen, whose worst tensor lies 6.0e-3 away (the CRNN flagship's SR
# model: 3.5e-3) while the SR model's whole gradient lies 6.5e-4 away
# (``python -m tests.torch_fp64_noise``, ``opt_student_full_width``).  The
# student's train-mode BatchNorms' backward cancels.  About three times
# that, as phase 7 holds the CRNN flagship's: the student's gradient at
# OPT_STUDENT_GRAD_TOL, each SR tensor at OPT_SR_TENSOR_TOL, the SR model's
# whole gradient at phase 13's 5e-3.
OPT_STUDENT_GRAD_TOL = 1e-1
OPT_SR_TENSOR_TOL = 2e-2
# the parameters of an arch that reach no loss (sem_tsrn's word-vector
# projections), and the names of the PReLU slopes
NO_GRAD = {"sem_tsrn": ("w2v_proj.",)}
PRELU_KEYS = ("prelu.weight", "block1.1.weight")


def prelu_gap_without_cudnn(argv, batch):
    """``zoo_card_vs_cpu``'s train step of ``argv`` again with cuDNN off on the
    card (PyTorch's own convolutions, no FFT path), TF32 off: the PReLU
    slopes' gradient errors against the CPU relative to their own norm, and
    the model's, with no bound (a measurement beside the checked run's)."""
    card, card_state, _ = zoo_mission(argv, device="cuda")
    cpu, cpu_state, _ = zoo_mission(argv, device="cpu")
    torch.backends.cudnn.enabled = False
    try:
        card._train_step(card_state, batch)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.enabled = True
    cpu._train_step(cpu_state, batch)
    return prelu_gap(grads_of(card_state.sr[0]), grads_of(cpu_state.sr[0]))


def prelu_gap(got, want):
    """The PReLU slopes' gradient errors of ``got`` against ``want`` relative
    to their own norm, and the model's (the pre-BN biases apart) relative to
    its norm."""
    want = {k: g.double() for k, g in want.items()}
    total = float(torch.sqrt(sum(g.pow(2).sum() for g in want.values())))
    prelu = {k: float((got[k].double() - want[k]).norm() / want[k].norm()) for k in want if k.endswith(PRELU_KEYS)}
    model = float(torch.sqrt(sum((got[k].double() - want[k]).pow(2).sum() for k in want
                                 if not PRE_BN_BIAS.search(k)))) / total
    return {"prelu_rel_err": max(prelu.values()), "prelu_rel_errs": prelu, "sr0_grad_rel_err": model}


def prelu_gap_fp64(argv, batch):
    """``zoo_card_vs_cpu``'s train step of ``argv`` in fp32 and in fp64 (the
    models cast to fp64 after the same seeded draw, autocast off), on the
    card and on the CPU, TF32 off: ``prelu_gap`` of the card's fp32 against
    its fp64, of the CPU's fp32 against its fp64 (``python -m
    tests.torch_fp64_noise``'s measurement, on this step), and of the
    card's fp64 against the CPU's.  Where the first is about the card's
    fp32 gap to the CPU, the gap is fp32's rounding under the slopes'
    cancellation.  A measurement, with no bound."""
    grads, dtypes = {}, dict(port_step.COMPUTE_DTYPES)
    port_step.COMPUTE_DTYPES["fp64"] = torch.float64
    try:
        for device in ("cuda", "cpu"):
            for name in ("fp32", "fp64"):
                mission, state, _ = zoo_mission(argv, name, device=device)
                if name == "fp64":
                    for m in (*state.sr, *state.stu):
                        m.double()
                mission._train_step(state, batch)
                grads[device, name] = grads_of(state.sr[0])
    finally:
        port_step.COMPUTE_DTYPES.clear()
        port_step.COMPUTE_DTYPES.update(dtypes)
    return {"card_fp32_vs_card_fp64": prelu_gap(grads["cuda", "fp32"], grads["cuda", "fp64"]),
            "cpu_fp32_vs_cpu_fp64": prelu_gap(grads["cpu", "fp32"], grads["cpu", "fp64"]),
            "card_fp64_vs_cpu_fp64": prelu_gap(grads["cuda", "fp64"], grads["cpu", "fp64"])}


def zoo_train(argv, compute_dtype: str, batches):
    """(b) 2 warm-up and ``len(batches) - 2`` timed train steps at batch 48 in
    ``compute_dtype``: images/s by CUDA events, peak memory, K1's launches."""
    mission, state, _ = zoo_mission(argv, compute_dtype, device="cuda")
    for b in batches[:TRAIN_WARMUP]:
        mission._train_step(state, b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    gru_seq.LAUNCHES = gru_seq.BACKWARD_LAUNCHES = 0
    start.record()
    metrics = [mission._train_step(state, b) for b in batches[TRAIN_WARMUP:]]
    end.record()
    torch.cuda.synchronize()
    event_s = start.elapsed_time(end) / 1e3
    check(all(np.isfinite(float(v)) for m in metrics for v in m.values()), f"{compute_dtype}: non-finite loss")
    steps = len(batches) - TRAIN_WARMUP
    return {"images_per_s": BATCH * steps / event_s, "ms_per_step": event_s * 1e3 / steps,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "k1_launches": gru_seq.LAUNCHES,
            "k1_backward_launches": gru_seq.BACKWARD_LAUNCHES, "loss_first": float(metrics[0]["loss_total"]),
            "loss_last": float(metrics[-1]["loss_total"])}


def zoo_eval(argv, batches):
    """(b) ``evaluate`` over 4 batches of 48 after a warm one: images/s by
    CUDA events, K1's launches."""
    mission, _, models = zoo_mission(argv, device="cuda")
    evaluate(mission._eval_step, models, batches[:1])
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    gru_seq.LAUNCHES = 0
    start.record()
    metrics = evaluate(mission._eval_step, models, batches[1:])
    end.record()
    torch.cuda.synchronize()
    check(metrics["images"] == BATCH * ZOO_EVAL_BATCHES and all(np.isfinite(v) for v in metrics.values()),
          f"zoo eval metrics {metrics}")
    return {"images_per_s": metrics["images"] / (start.elapsed_time(end) / 1e3), "k1_launches": gru_seq.LAUNCHES,
            "metrics": metrics}


def zoo_cli(root: str, script: str, train_dirs, val_dirs, compute_dtype: str):
    """(c) ``cli.main`` with ``script``'s flags and the packaged YAML (bf16),
    or the same with ``compute_dtype: fp32``, over phase 9's TextZoom (the
    first of its train LMDBs in bf16), TF32 on first: one epoch of 22
    iterations (11 in bf16) with a val and a save at its end,
    then ``--go_test`` from that checkpoint, whose metric dicts equal the
    val's (the same weights, PSNR and SSIM at 1e-4); K1's launches over both
    runs."""
    name = f"{script[len('train_'):-len('.sh')]}_{compute_dtype}"
    if compute_dtype == "bf16":  # the first train LMDB only: half the depth of the fp32 run
        train_dirs = train_dirs[:1]
    iterations = len(ConcatDataset([TextZoomDataset(d) for d in train_dirs])) // BATCH
    cfg = load_config()
    check(cfg.TRAIN.compute_dtype == "bf16", f"the packaged YAML says compute_dtype {cfg.TRAIN.compute_dtype}")
    cfg.TRAIN.update(train_data_dir=list(train_dirs), batch_size=BATCH, epochs=1, saveInterval=iterations,
                     displayInterval=iterations, workers=0, ckpt_dir=f"{root}/ckpt_zoo", compute_dtype=compute_dtype)
    cfg.TRAIN.VAL.update(val_data_dir=list(val_dirs), valInterval=iterations)
    config_path = f"{root}/zoo_{name}.yaml"
    with open(config_path, "w") as f:
        json.dump(cfg, f)  # JSON is YAML
    argv = zoo_argv(script) + ["--vis_dir", f"zoo_{name}", "--config", config_path]
    ckpt_dir = f"{root}/ckpt_zoo/zoo_{name}"
    cwd = os.getcwd()
    os.chdir(root)
    try:
        probe = TrainerProbe()
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        gru_seq.LAUNCHES = gru_seq.BACKWARD_LAUNCHES = 0
        start = time.perf_counter()
        with probe.installed():
            state = cli.main(argv)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - start
        check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32,
              f"{name}: the trainer left TF32 on")
        check(probe.compute_dtypes == [compute_dtype], f"{name}: the train step ran in {probe.compute_dtypes}")
        check(state.step == iterations, f"{name}: trainer at step {state.step}, expected {iterations}")
        (val,) = [e for e in probe.events if e["name"] == "val"]
        files = set(os.listdir(ckpt_dir))
        want_files = {"checkpoint_0.pth", "opt_state.pth", "info.json"} | {f"recognizer_{i}.pth"
                                                                          for i in range(len(state.stu))}
        check(want_files <= files and not any(f.startswith("recognizer_") for f in files - want_files
                                               if "best" not in f), f"{name}: checkpoint files {sorted(files)}")
        del state
        go_test = cli.main(argv + ["--go_test", "--resume", ckpt_dir])
        torch.cuda.synchronize()
        for split, md in val["out"].items():
            check_metric_dicts(go_test[split], md, f"{name} --go_test {split} against the val on the same weights")
    finally:
        os.chdir(cwd)
    return {"script": script, "compute_dtype": compute_dtype, "iterations": iterations, "run_s": run_s, "val_s": val["t1"] - val["t0"],
            "first_iteration_s": probe.first_step_end - start, "losses_first": {k: float(v) for k, v in
                                                                                probe.metrics[0].items()},
            "val": val["out"], "k1_launches": gru_seq.LAUNCHES, "k1_backward_launches": gru_seq.BACKWARD_LAUNCHES}


def host_load():
    """The host's 1-minute load average and this process's live children
    (loader workers of earlier phases): what competes with the steps' host
    work."""
    children = 0
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                children += int(f.read().rsplit(")", 1)[1].split()[1]) == os.getpid()
        except (OSError, IndexError, ValueError):
            continue
    return {"loadavg_1min": os.getloadavg()[0], "children": children, "cpus": os.cpu_count()}


def phase_zoo(root: str, train_dirs, val_dirs):
    """Phase 13: for each of the seven scripts, (a) card against CPU, (b) fp32
    and bf16 training and eval on the card, (c) the script through the CLI
    on the packaged YAML (bf16) and in fp32.
    Returns ``tsrn``'s K1 launches in (b): fp32 and bf16, each (forward,
    backward)."""
    t0 = time.perf_counter()
    print(json.dumps({"zoo_host": host_load()}), flush=True)
    rng = np.random.default_rng(13)
    check_batch = synthetic_batch(rng, BATCH, labels=False)
    train_batches = [synthetic_batch(rng, BATCH, labels=False) for _ in range(TRAIN_WARMUP + ZOO_TRAIN_STEPS)]
    eval_batches = [synthetic_batch(rng, BATCH) for _ in range(1 + ZOO_EVAL_BATCHES)]
    launches = {}
    for script in ZOO_SCRIPTS:
        argv = zoo_argv(script)
        arch = build_arg_parser().parse_args(argv).arch
        s0 = time.perf_counter()
        out = {"script": script, "arch": arch, "batch": BATCH, "card_vs_cpu": zoo_card_vs_cpu(argv, check_batch)}
        if arch == "srres":  # ROADMAP.md queue 3 item 1: the PReLU slopes' gap with and without cuDNN, and fp64
            out["card_vs_cpu_without_cudnn"] = prelu_gap_without_cudnn(argv, check_batch)
            out["fp32_vs_fp64"] = prelu_gap_fp64(argv, check_batch)
            print(json.dumps({"srres_prelu_gap": {
                "with_cudnn": out["card_vs_cpu"].get("sr0_prelu_rel_err"),
                "without_cudnn": out["card_vs_cpu_without_cudnn"]["prelu_rel_err"],
                **{k: v["prelu_rel_err"] for k, v in out["fp32_vs_fp64"].items()}}}), flush=True)
        for dtype in ("fp32", "bf16"):
            out[dtype] = zoo_train(argv, dtype, train_batches)
        out["eval"] = zoo_eval(argv, eval_batches)
        runs_k1 = arch == "tsrn"  # the only one of the seven with recurrent blocks
        for dtype in ("fp32", "bf16"):
            want = 2 * N_SRB * ZOO_TRAIN_STEPS if runs_k1 else 0
            got = (out[dtype]["k1_launches"], out[dtype]["k1_backward_launches"])
            check(got == (want, want),
                  f"{arch} {dtype}: K1 launched {got} times in {ZOO_TRAIN_STEPS} steps, expected {want} each way")
            if runs_k1:
                launches[dtype] = got
        want = 2 * N_SRB * ZOO_EVAL_BATCHES if runs_k1 else 0
        check(out["eval"]["k1_launches"] == want, f"{arch} eval: K1 launched {out['eval']['k1_launches']} times")
        out["s"] = time.perf_counter() - s0
        print(json.dumps({"zoo": out}), flush=True)
    n_val = sum(-(-n // BATCH) for n in VAL_PAIRS)
    for script in ZOO_SCRIPTS:
        for dtype in ("bf16", "fp32"):
            cli_out = zoo_cli(root, script, train_dirs, val_dirs, dtype)
            iters = cli_out["iterations"]
            k1 = script == "train_TSRN.sh"
            want = (2 * N_SRB * (iters + 2 * n_val) if k1 else 0, 2 * N_SRB * iters if k1 else 0)
            got = (cli_out["k1_launches"], cli_out["k1_backward_launches"])
            check(got == want, f"{script} ({dtype}) through the CLI: K1 launched {got} times, expected {want}")
            print(json.dumps({"zoo_cli": cli_out}), flush=True)
    print(f"zoo: phase 13 took {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


# phase 15: the rest of the single-model zoo, each arch with its flags of
# ``profile_zoo.ARCH_FLAGS``; the SRBs of those that run K1 (each runs it
# once over W and once over H)
ZOO_REST_SRB = {"tsrn_tl_wmask": N_SRB, "tsrn_tl": N_SRB, "textzoom_net": 6}
REMAT_FLAGS = ["--arch", "tsrn_tl_cascade", "--STN", "--mask", "--use_distill", "--gradient", "--stu_iter=2"]
SRRESNET3_SCRIPT = "train_TPGSR-SRResNet.sh"  # --stu_iter=3 --sr_share
BIG_BATCH = 512  # the packaged YAML's TRAIN.batch_size


def remat_big_batch(rng):
    """(b) ``srresnet_tl --stu_iter=3 --sr_share`` with each stage recomputed
    in its backward: one fp32 step at the YAML's batch 512 after a warm one,
    its time and peak memory."""
    mission, state, _ = zoo_mission(zoo_argv(SRRESNET3_SCRIPT), "fp32", device="cuda")
    batch = synthetic_batch(rng, BIG_BATCH, labels=False)
    mission._train_step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    metrics = mission._train_step(state, batch)
    end.record()
    torch.cuda.synchronize()
    check(all(np.isfinite(float(v)) for v in metrics.values()), "srresnet_tl at batch 512: non-finite loss")
    ms = start.elapsed_time(end)
    return {"batch": BIG_BATCH, "ms_per_step": ms, "images_per_s": BIG_BATCH / (ms / 1e3),
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}


def zoo_rest_cli(root: str, train_dirs, val_dirs):
    """(c) ``cli.main`` with no ``--arch`` (so ``tsrn_tl_wmask``) on the
    packaged YAML (bf16) over phase 9's first train LMDB (an epoch of 11
    iterations, a val and a save at its end), then ``--test --rec crnn`` from
    its checkpoint over the smallest val split; then the flagship's flags
    with ``--ssim_loss`` the same way.  Finite losses; K1's launches in each
    run."""
    iterations = TRAIN_PAIRS // BATCH // len(train_dirs)
    cfg = load_config()
    cfg.TRAIN.update(train_data_dir=list(train_dirs[:1]), batch_size=BATCH, epochs=1, saveInterval=iterations,
                     displayInterval=iterations, workers=0, ckpt_dir=f"{root}/ckpt_rest")
    cfg.TRAIN.VAL.update(val_data_dir=list(val_dirs), valInterval=iterations)
    cfg.TEST.test_data_dir = val_dirs[int(np.argmin(VAL_PAIRS))]
    config_path = f"{root}/zoo_rest.yaml"
    with open(config_path, "w") as f:
        json.dump(cfg, f)  # JSON is YAML
    out = {}
    cwd = os.getcwd()
    os.chdir(root)
    try:
        for name, argv in (("default_arch", []), ("flagship_ssim_loss", TRAINER_FLAGS + ["--ssim_loss"])):
            argv = argv + ["--vis_dir", f"rest_{name}", "--config", config_path]
            args = build_arg_parser().parse_args(argv)
            probe = TrainerProbe()
            gru_seq.LAUNCHES = gru_seq.BACKWARD_LAUNCHES = 0
            start = time.perf_counter()
            with probe.installed():
                state = cli.main(argv)
            torch.cuda.synchronize()
            run = {"arch": args.arch, "ssim_loss": args.ssim_loss, "run_s": time.perf_counter() - start,
                   "iterations": state.step, "compute_dtypes": probe.compute_dtypes,
                   "losses_first": {k: float(v) for k, v in probe.metrics[0].items()},
                   "losses_second": {k: float(v) for k, v in probe.metrics[1].items()},
                   "val": [e["out"] for e in probe.events if e["name"] == "val"],
                   "k1_launches": (gru_seq.LAUNCHES, gru_seq.BACKWARD_LAUNCHES)}
            check(state.step == iterations and probe.compute_dtypes == ["bf16"], f"{name}: {run}")
            check(all(np.isfinite(v) for m in (run["losses_first"], run["losses_second"]) for v in m.values()),
                  f"{name}: non-finite losses {run['losses_first']} {run['losses_second']}")
            check(len(state.sr) == 1 and len(state.stu) == 1 and len(run["val"]) == 1, f"{name}: state or val")
            del state
            if name == "default_arch":
                check(args.arch == "tsrn_tl_wmask", f"the CLI's default arch is {args.arch}")
                md = cli.main(argv + ["--test", "--rec", "crnn", "--resume", f"{root}/ckpt_rest/rest_{name}"])
                check(md["images"] == min(VAL_PAIRS) and all(np.isfinite(v) for v in md.values()), f"--test: {md}")
                run["test"] = md
            out[name] = run
    finally:
        os.chdir(cwd)
    return out


def phase_zoo_rest(root: str, train_dirs, val_dirs):
    """Phase 15: the other ten archs of the JAX package but two.  (a) Each at
    batch 8 and full width with its flags, card against CPU (phase 13's
    bounds), and one ``tsrn_tl_cascade --stu_iter 2`` step whose stages are
    recomputed in the backward, its K1 launches counted; (b) each arch's fp32
    and bf16 training (``ZOO_TRAIN_STEPS`` at batch 48) and eval (4 batches), then
    ``srresnet_tl --stu_iter=3 --sr_share`` at batch 48 and one step at batch
    512, with peak memory; (c) the CLI with no ``--arch``, ``--test``, and
    ``--ssim_loss``.  Returns K1's launches: (a)'s recomputed step, and the
    ``tsrn_tl_wmask`` fp32 and bf16 runs of (b), each (forward, backward)."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(15)
    small = synthetic_batch(rng, CARD_VS_CPU_TRAIN_BATCH, labels=False)
    train_batches = [synthetic_batch(rng, BATCH, labels=False) for _ in range(TRAIN_WARMUP + ZOO_TRAIN_STEPS)]
    eval_batches = [synthetic_batch(rng, BATCH) for _ in range(1 + ZOO_EVAL_BATCHES)]
    launches = {}
    # (a) the recompute: 2 stages of 5 SRBs, K1 forward 20 + 20 (the
    # recompute) and backward 20
    remat = zoo_card_vs_cpu(REMAT_FLAGS, small)
    want = (2 * 2 * 2 * N_SRB, 2 * 2 * N_SRB)
    check(remat["k1_train_step_launches"] == want,
          f"recomputed cascade: K1 launched {remat['k1_train_step_launches']}, expected {want}")
    launches["remat"] = remat["k1_train_step_launches"]
    print(json.dumps({"zoo_rest_remat": {"flags": REMAT_FLAGS, "batch": CARD_VS_CPU_TRAIN_BATCH,
                                         "card_vs_cpu": remat}}), flush=True)
    print(json.dumps({"zoo_host": host_load()}), flush=True)
    for arch in ARCH_FLAGS:
        argv = argv_of(arch)
        s0 = time.perf_counter()
        out = {"arch": arch, "flags": ARCH_FLAGS[arch], "card_vs_cpu": zoo_card_vs_cpu(argv, small)}
        srb = ZOO_REST_SRB.get(arch, 0)
        step_want = (2 * srb, 2 * srb)
        check(out["card_vs_cpu"]["k1_train_step_launches"] == step_want,
              f"{arch}: K1 launched {out['card_vs_cpu']['k1_train_step_launches']} in a step, expected {step_want}")
        for dtype in ("fp32", "bf16"):
            out[dtype] = zoo_train(argv, dtype, train_batches)
            got = (out[dtype]["k1_launches"], out[dtype]["k1_backward_launches"])
            check(got == (2 * srb * ZOO_TRAIN_STEPS,) * 2,
                  f"{arch} {dtype}: K1 launched {got} times in {ZOO_TRAIN_STEPS} steps")
            if arch == "tsrn_tl_wmask":
                launches[dtype] = got
        out["eval"] = zoo_eval(argv, eval_batches)
        check(out["eval"]["k1_launches"] == 2 * srb * ZOO_EVAL_BATCHES, f"{arch} eval: K1 launches")
        out["s"] = time.perf_counter() - s0
        print(json.dumps({"zoo_rest": out}), flush=True)
    print(json.dumps({"zoo_host": host_load()}), flush=True)
    srres3 = {"script": SRRESNET3_SCRIPT, "batch_48_fp32": zoo_train(zoo_argv(SRRESNET3_SCRIPT), "fp32", train_batches),
              "batch_512_fp32": remat_big_batch(rng)}
    print(json.dumps({"zoo_rest_srresnet_tl_remat": srres3}), flush=True)
    print(json.dumps({"zoo_rest_cli": zoo_rest_cli(root, train_dirs, val_dirs)}), flush=True)
    print(f"zoo_rest: phase 15 took {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


# phase 14: ASTER and MORAN as the eval recognizer (--test_model, --rec)
REC_KINDS = ("ASTER", "MORAN")
REC_CHECK_BATCH = 8
# card against CPU, each module fed the CPU's input: the rectified image
# (ASTER's a TPS sample of a 128-wide image in [-1, 1]) at 1e-3, ASTER's
# encoder features at 5e-4 (measured 1.35e-4: cuDNN's sums against the
# CPU's through 45 convolutions and two LSTM layers), its best beam's score
# at 1e-3, MORAN's logits at 1e-3.  The decoder's ids are compared exactly
# in the rows where every decision (a beam's selection, a greedy argmax) is
# REC_MARGIN_FACTOR times the decoder's measured error clear of the next
# candidate; at least half the rows must be.
REC_RECTIFY_ATOL = 1e-3
REC_FEATURE_ATOL = 5e-4
REC_SCORE_ATOL = 1e-3
REC_LOGIT_ATOL = 1e-3
REC_MARGIN_FACTOR = 10.0
# SEED's first decoder state: its encoder features' noise (REC_FEATURE_ATOL)
# through the 12,800-wide eEmbed and embed_fc
REC_STATE_ATOL = 2e-3


def sharpen_recognizer_(rec: torch.nn.Module, kind: str, seed: int = 3) -> torch.nn.Module:
    """The recognizer's draw rescaled as tests/torch_recognizers.py rescales
    the JAX package's, so that its decisions depend on the image, as a
    trained model's do: BatchNorm statistics and affines drawn around their
    defaults; ASTER's encoder convolutions scaled by sqrt(6) and MORAN's
    ASRN's by sqrt(3); ASTER's STN fc1 and fc2 drawn at N(0, 0.01) and
    N(0, 0.1); the decoders' GRU weights on the attention context and their
    output layers scaled by 10; ASTER's EOS logit raised by 1.5.  SEED (no
    STN) as ASTER otherwise.  In place, on the CPU; returns ``rec``."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in rec.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.running_mean.normal_(0.0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
                m.weight.uniform_(0.8, 1.2, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
        if kind in ("ASTER", "SEED"):
            for m in rec.encoder.modules():
                if isinstance(m, torch.nn.Conv2d):
                    m.weight.mul_(6.0 ** 0.5)
            if kind == "ASTER":
                rec.stn_head.stn_fc1[0].weight.normal_(0.0, 0.01, generator=gen)
                rec.stn_head.stn_fc2.weight.normal_(0.0, 0.1, generator=gen)
            dec = rec.decoder.decoder
            dec.gru.weight_ih_l0[:, dec.tgt_embedding.embedding_dim:].mul_(10.0)
            dec.fc.weight.mul_(10.0)
            dec.fc.bias[rec.eos_id] += 1.5
        else:
            for m in rec.ASRN.cnn.modules():
                if isinstance(m, torch.nn.Conv2d):
                    m.weight.mul_(3.0 ** 0.5)
            for att in (rec.ASRN.attentionL2R, rec.ASRN.attentionR2L):
                att.attention_cell.rnn.weight_ih[:, :att.hidden].mul_(10.0)
                att.generator.weight.mul_(10.0)
    return rec


def rec_reads(kind: str, card, cpu, x):
    """What the card-against-CPU check compares on the recognizer input
    ``x``, module by module, each module fed the CPU's output of the one
    before: {name: (card, CPU)}, with the decoder's ``staged_ids`` (ASTER's
    beam search, MORAN's L2R argmax) and the CPU's ``margins`` (per row, of
    the decisions that produced them); and the whole chain's ``ids`` and
    ``chain_score`` (ASTER's and SEED's best beam's score, MORAN's L2R
    logits).  SEED's decoder starts from its embedding-seeded state, which is
    compared too."""
    xg = x.cuda()
    if kind == "SEED":
        feats, state0 = cpu.encode(x)
        beam = cpu.decoder.beam_search(feats, cpu.beam_width, cpu.eos_id, state0=state0)
        staged = card.decoder.beam_search(feats.cuda(), card.beam_width, card.eos_id, state0=state0.cuda())
        chain = card.beam_search(xg)
        card_feats, card_state0 = card.encode(xg)
        return {"features": (card_feats, feats), "state0": (card_state0, state0),
                "beam_score": (staged.scores, beam.scores), "staged_ids": (staged.ids, beam.ids),
                "margins": beam.margins, "chain_score": (chain.scores, beam.scores), "ids": (chain.ids, beam.ids)}
    if kind == "ASTER":
        rect = cpu.rectify(x)
        feats = cpu.encoder(rect)
        beam = cpu.decoder.beam_search(feats, cpu.beam_width, cpu.eos_id)
        staged = card.decoder.beam_search(feats.cuda(), card.beam_width, card.eos_id)
        chain = card.decoder.beam_search(card.encoder(card.rectify(xg)), card.beam_width, card.eos_id)
        return {"rectified": (card.rectify(xg), rect), "features": (card.encoder(rect.cuda()), feats),
                "beam_score": (staged.scores, beam.scores), "staged_ids": (staged.ids, beam.ids),
                "margins": beam.margins, "chain_score": (chain.scores, beam.scores), "ids": (chain.ids, beam.ids)}
    rect = cpu.MORN(x)
    logits = cpu.ASRN(rect)[0]
    staged = card.ASRN(rect.cuda())[0]
    chain = card(xg)[0]
    top2 = torch.topk(logits, 2, dim=-1).values
    return {"rectified": (card.MORN(xg), rect), "logits": (staged, logits),
            "staged_ids": (staged.argmax(-1), logits.argmax(-1)), "margins": (top2[..., 0] - top2[..., 1]).amin(dim=-1),
            "chain_score": (chain, logits), "ids": (chain.argmax(-1), logits.argmax(-1))}


def rec_card_vs_cpu(argv, kind: str, batch):
    """(a) The eval step with ``kind`` scoring, card against CPU from the same
    weights (the CLI's draw, sharpened) and batch: SR at phase 4's 5e-4;
    then on the CPU's SR, LR and HR, each module on the CPU's input
    (``rec_reads``): the decoder's ids equal the CPU's in every row whose
    decisions clear ``REC_MARGIN_FACTOR`` times the decoder's measured
    error, at least half the rows.  The whole chain, where the upstream
    errors add up over the decode, and the step's own reads of LR and HR:
    the line reports the rows whose ids agree, and a row may differ only
    where a decision is within ``REC_MARGIN_FACTOR`` times the chain's
    noise (its error on the rows that agree)."""
    flags = argv + ["--test_model", kind]
    card_mission, _, card = zoo_mission(flags, device="cuda")
    cpu_mission, _, cpu = zoo_mission(flags, device="cpu")
    sharpen_recognizer_(cpu.rec, kind)
    card.rec.load_state_dict(cpu.rec.state_dict())
    (sr_g, outs_g), (sr_c, outs_c) = card_mission._eval_step(card, batch), cpu_mission._eval_step(cpu, batch)
    out = {"sr_max_abs_err": float((sr_g.cpu() - sr_c).abs().max())}
    check(torch.isfinite(sr_g).all().item() and out["sr_max_abs_err"] <= 5e-4,
          f"{kind} eval sr card vs CPU: {out['sr_max_abs_err']:.3g} > 5e-4")
    check(sorted(outs_g) == sorted(outs_c), f"{kind} eval outputs differ in keys")
    images = {"sr": sr_c, "lr": torch.as_tensor(batch["lr"]), "hr": torch.as_tensor(batch["hr"])}
    with torch.no_grad():
        reads = {name: rec_reads(kind, card.rec, cpu.rec, recognizer_input(kind, img)) for name, img in images.items()}
    bounds = {"rectified": REC_RECTIFY_ATOL, "features": REC_FEATURE_ATOL, "state0": REC_STATE_ATOL,
              "beam_score": REC_SCORE_ATOL, "logits": REC_LOGIT_ATOL, "chain_score": None}
    errs = {what: max(float((r[what][0].cpu() - r[what][1]).abs().max()) for r in reads.values())
            for what in bounds if what in reads["sr"]}
    print(f"rec_eval {kind} card vs CPU: {json.dumps(errs)}", flush=True)
    for what, err in errs.items():
        out[f"{what}_max_abs_err"] = err
        check(bounds[what] is None or err <= bounds[what], f"{kind} {what} card vs CPU: {err:.3g} > {bounds[what]}")
    threshold = REC_MARGIN_FACTOR * max(errs["logits" if kind == "MORAN" else "beam_score"], 1e-7)
    compared, rows = 0, 0
    for name, r in reads.items():
        clear = r["margins"] > threshold
        ids_g, ids_c = r["staged_ids"]
        check(torch.equal(ids_g.cpu()[clear], ids_c[clear]), f"{kind} decoder ids on {name}: card vs CPU")
        compared, rows = compared + int(clear.sum()), rows + len(clear)
    out.update(min_margin=min(float(r["margins"].min()) for r in reads.values()), margin_threshold=threshold,
               rows_compared=compared, rows=rows)
    check(2 * compared >= rows, f"{kind}: decoder ids comparable in {compared} of {rows} rows only: {out}")

    def agreeing(ids_g, ids_c):
        return (ids_g.cpu() == ids_c).reshape(len(ids_c), -1).all(dim=1)

    noise = 0.0
    for r in reads.values():
        agree = agreeing(*r["ids"])
        if agree.any():
            noise = max(noise, float((r["chain_score"][0].cpu() - r["chain_score"][1])[agree].abs().max()))
    chain_threshold = REC_MARGIN_FACTOR * max(noise, 1e-7)
    chain_rows, chain_agree = 0, 0
    for name, r in reads.items():
        pairs = [r["ids"]]
        if name != "sr":  # the step read the same LR and HR
            step_ids = outs_g[f"logits_{name}"] if kind != "MORAN" else outs_g[f"logits_{name}"].argmax(-1)
            pairs.append((step_ids, r["ids"][1]))
        for ids_g, ids_c in pairs:
            agree = agreeing(ids_g, ids_c)
            check(bool((agree | (r["margins"] <= chain_threshold)).all()),
                  f"{kind} chain ids on {name}: a row differs beyond its margin")
            chain_rows, chain_agree = chain_rows + len(agree), chain_agree + int(agree.sum())
    out.update(chain_noise=noise, chain_rows_agreeing=chain_agree, chain_rows=chain_rows)
    return out


def rec_serve(kind: str, warm, batches, crnn_ips: float):
    """(b) The flagship's ``evaluate`` over 4 batches of 48 with ``kind``
    scoring (the CLI's draw from seed 7, ``max_len`` 100, beam 5, the YAML's
    voc_type) after a warm batch: images/s by CUDA events beside phase 5's
    CRNN figure, K1's launches on that run alone; then 3 eval steps traced
    (``profile_eval.trace``): kernels a batch and the card's busy share."""
    cfg = load_config()
    models, step = entry.flagship(device="cuda", seed=0)
    rec = trainer.eval_recognizer(kind, cfg, "cuda")
    models = EvalModels(sr=models.sr, stu=models.stu, teacher=models.teacher, rec=rec).eval()
    decoder = rec_decoder(kind, cfg.TRAIN.voc_type)
    evaluate(step, models, [warm], decoder=decoder)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    gru_seq.LAUNCHES = 0
    start.record()
    metrics = evaluate(step, models, batches, decoder=decoder)
    end.record()
    torch.cuda.synchronize()
    launches = gru_seq.LAUNCHES
    n_images = BATCH * SERVE_BATCHES
    check(metrics["images"] == n_images and all(np.isfinite(v) for v in metrics.values()),
          f"{kind} serve metrics {metrics}")
    want = 2 * N_SRB * SERVE_BATCHES
    check(launches == want, f"K1 launched {launches} times in the {kind} eval, expected {want}")
    summary, top = trace(models, step, batches[0], steps=3)
    return {"batch": BATCH, "batches": SERVE_BATCHES, "images_per_s": n_images / (start.elapsed_time(end) / 1e3),
            "phase5_crnn_images_per_s": crnn_ips, "k1_launches": launches,
            "kernels_per_batch": summary["kernels_per_step"], "device_busy_share": summary["device_busy_share"],
            "device_ms_per_batch": summary["device_ms_per_step"], "wall_ms_per_batch": summary["wall_ms_per_step"],
            "top_kernels": top[:5], "metrics": metrics}


def rec_cli(root: str, val_dirs, kind: str):
    """(c) ``cli.main`` with ``--test --rec <kind>`` from phase 10's checkpoint
    over phase 9's smallest val split, then ``evaluate`` in-process on the
    same weights and the loader's batches: the same metric dict."""
    split = val_dirs[int(np.argmin(VAL_PAIRS))]
    config_path = f"{root}/trainer.yaml"
    argv = TRAINER_FLAGS + ["--config", config_path, "--resume", f"{root}/ckpt/smoke", "--test", "--rec",
                            kind.lower(), "--test_data_dir", split]
    cwd = os.getcwd()
    os.chdir(root)
    try:
        md = cli.main(argv)
        cfg = load_config(config_path)
        args = AttrDict(vars(build_arg_parser().parse_args(argv)))
        mission = trainer.TextSR(cfg, args, device="cuda")
        state = mission.init_state()
        rec = trainer.eval_recognizer(kind, mission.config, "cuda")
        models = EvalModels(sr=state.sr, stu=state.stu, teacher=state.teacher, rec=rec).eval()
        step = make_eval_step(args, int(mission.config.TRAIN.width), device="cuda")
        (loader,) = mission.get_val_data([split])
        want = evaluate(step, models, list(loader), decoder=rec_decoder(kind, mission.config.TRAIN.voc_type))
    finally:
        os.chdir(cwd)
    check_metric_dicts({k: v for k, v in md.items() if k != "fps"}, want,
                       f"--test --rec {kind.lower()} against evaluate in-process")
    check(md["images"] == min(VAL_PAIRS) and md["fps"] > 0, f"--test --rec {kind.lower()}: {md}")
    return {"split_images": md["images"], "fps": md["fps"], "metrics": md}


def rec_zoo_cli(root: str, val_dirs):
    """(c) for the zoo: ``cli.main`` with each of the seven scripts' flags and
    ``--test --rec aster`` or ``--rec moran`` in turn (each recognizer on a
    plain and on a cascade arch), from its fp32 checkpoint of phase 13(c),
    over the smallest val split: the images all read, finite metrics, fps."""
    split = val_dirs[int(np.argmin(VAL_PAIRS))]
    rows = []
    cwd = os.getcwd()
    os.chdir(root)
    try:
        for i, script in enumerate(ZOO_SCRIPTS):
            kind = REC_KINDS[i % len(REC_KINDS)]
            name = f"{script[len('train_'):-len('.sh')]}_fp32"
            argv = zoo_argv(script) + ["--vis_dir", f"zoo_{name}", "--config", f"{root}/zoo_{name}.yaml", "--resume",
                                       f"{root}/ckpt_zoo/zoo_{name}", "--test", "--rec", kind.lower(),
                                       "--test_data_dir", split]
            md = cli.main(argv)
            check(md["images"] == min(VAL_PAIRS) and md["fps"] > 0 and all(np.isfinite(v) for v in md.values()),
                  f"{script} --test --rec {kind.lower()}: {md}")
            rows.append({"script": script, "rec": kind, "fps": md["fps"], "accuracy": md["accuracy"],
                         "psnr_avg": md["psnr_avg"]})
    finally:
        os.chdir(cwd)
    return rows


def phase_rec_eval(root: str, val_dirs, crnn_ips: float):
    """Phase 14: ASTER and MORAN score the flagship (and ``srcnn``, with
    ASTER) on the card; a ``{"rec_eval": ...}`` line each.  Returns K1's
    launches in each recognizer's (b)."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(14)
    check_batch = synthetic_batch(rng, REC_CHECK_BATCH, labels=False)
    warm = synthetic_batch(rng, BATCH)
    batches = [synthetic_batch(rng, BATCH) for _ in range(SERVE_BATCHES)]
    launches = {}
    for kind in REC_KINDS:
        s0 = time.perf_counter()
        out = {"recognizer": kind,
               "card_vs_cpu": {"tsrn_tl_cascade": rec_card_vs_cpu(TRAINER_FLAGS, kind, check_batch)}}
        if kind == "ASTER":
            out["card_vs_cpu"]["srcnn"] = rec_card_vs_cpu(zoo_argv("train_SRCNN.sh"), kind, check_batch)
        out["serve"] = rec_serve(kind, warm, batches, crnn_ips)
        out["cli_test"] = rec_cli(root, val_dirs, kind)
        out["s"] = time.perf_counter() - s0
        launches[kind] = out["serve"]["k1_launches"]
        print(json.dumps({"rec_eval": out}), flush=True)
    print(json.dumps({"rec_eval_zoo_cli": rec_zoo_cli(root, val_dirs)}), flush=True)
    print(f"rec_eval: phase 14 took {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


# phase 16: the last two archs, --tpg OPT and SEED.  Each training path with
# the flags it reads, and its K1 sweeps a forward (SRBs x 2; sem_tsrn's
# blocks are attention, not GRUs)
LAST_PATHS = {
    "tsrn_c2f": ["--arch", "tsrn_c2f", "--STN", "--mask"],
    "sem_tsrn": ["--arch", "sem_tsrn", "--mask"],
    "opt": TRAINER_FLAGS[:-2] + ["--tpg", "OPT"],
}
LAST_SRB = {"tsrn_c2f": N_SRB, "sem_tsrn": 0, "opt": N_SRB}
# a batch-512 sem_tsrn step runs only where the batch-48 peak scaled to 512 stays under this
SEM_BIG_BATCH_GIB = 70.0


def with_aux(batch):
    """``batch`` with the keys of ``tsrn_c2f``'s and ``sem_tsrn``'s collates:
    ``coarse``, the mean of the HR's 2x2 average and the LR (mask channel
    included), and zero ``w2v`` vectors."""
    n = batch["lr"].shape[0]
    hr_small = batch["hr"].reshape(n, 16, 2, 64, 2, 4).mean(axis=(2, 4))
    return {**batch, "coarse": ((hr_small + batch["lr"]) / 2).astype(np.float32),
            "w2v": np.zeros((n, 300), np.float32)}


def sem_big_batch(rng, peak_48_gib: float):
    """One fp32 ``sem_tsrn`` step at the YAML's batch 512 after a warm one, its
    time and peak memory, where the batch-48 peak times 512 / 48 stays under
    ``SEM_BIG_BATCH_GIB``; otherwise that reckoning alone."""
    reckoned = peak_48_gib * BIG_BATCH / BATCH
    out = {"batch": BIG_BATCH, "reckoned_peak_gib": reckoned, "limit_gib": SEM_BIG_BATCH_GIB}
    if reckoned >= SEM_BIG_BATCH_GIB:
        return {**out, "ran": False}
    mission, state, _ = zoo_mission(LAST_PATHS["sem_tsrn"], "fp32", device="cuda")
    batch = with_aux(synthetic_batch(rng, BIG_BATCH, labels=False))
    mission._train_step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    metrics = mission._train_step(state, batch)
    end.record()
    torch.cuda.synchronize()
    check(all(np.isfinite(float(v)) for v in metrics.values()), "sem_tsrn at batch 512: non-finite loss")
    ms = start.elapsed_time(end)
    return {**out, "ran": True, "ms_per_step": ms, "images_per_s": BIG_BATCH / (ms / 1e3),
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}


def last_cli(root: str, train_dirs, val_dirs):
    """(c) ``cli.main`` with each training path's flags on the packaged YAML
    (bf16) over phase 9's first train LMDB (an epoch of 11 iterations, a val
    over the three splits and a save at its end), finite losses and K1's
    launches; then ``--go_test --test_model SEED`` from the ``tsrn_c2f``
    checkpoint over the smallest val split, its metric dict against
    ``evaluate`` in-process with the same SEED (seed 7) and weights."""
    iterations = TRAIN_PAIRS // BATCH // len(train_dirs)
    n_val = sum(-(-n // BATCH) for n in VAL_PAIRS)
    cfg = load_config()
    check(cfg.TRAIN.compute_dtype == "bf16", f"the packaged YAML says compute_dtype {cfg.TRAIN.compute_dtype}")
    cfg.TRAIN.update(train_data_dir=list(train_dirs[:1]), batch_size=BATCH, epochs=1, saveInterval=iterations,
                     displayInterval=iterations, workers=0, ckpt_dir=f"{root}/ckpt_last")
    cfg.TRAIN.VAL.update(val_data_dir=list(val_dirs), valInterval=iterations)
    config_path = f"{root}/last.yaml"
    with open(config_path, "w") as f:
        json.dump(cfg, f)  # JSON is YAML
    split = val_dirs[int(np.argmin(VAL_PAIRS))]
    cfg.TRAIN.VAL.val_data_dir = [split]
    seed_config_path = f"{root}/last_seed.yaml"
    with open(seed_config_path, "w") as f:
        json.dump(cfg, f)
    out = {}
    cwd = os.getcwd()
    os.chdir(root)
    try:
        for path, flags in LAST_PATHS.items():
            argv = flags + ["--vis_dir", f"last_{path}", "--config", config_path]
            probe = TrainerProbe()
            gru_seq.LAUNCHES = gru_seq.BACKWARD_LAUNCHES = 0
            start = time.perf_counter()
            with probe.installed():
                state = cli.main(argv)
            torch.cuda.synchronize()
            run = {"flags": flags, "run_s": time.perf_counter() - start, "iterations": state.step,
                   "compute_dtypes": probe.compute_dtypes,
                   "losses_first": {k: float(v) for k, v in probe.metrics[0].items()},
                   "losses_second": {k: float(v) for k, v in probe.metrics[1].items()},
                   "val": [e["out"] for e in probe.events if e["name"] == "val"],
                   "k1_launches": (gru_seq.LAUNCHES, gru_seq.BACKWARD_LAUNCHES)}
            srb = LAST_SRB[path]
            want = (2 * srb * (iterations + n_val), 2 * srb * iterations)
            check(state.step == iterations and probe.compute_dtypes == ["bf16"] and len(run["val"]) == 1,
                  f"{path} through the CLI: {run}")
            check(run["k1_launches"] == want, f"{path} through the CLI: K1 launched {run['k1_launches']}, expected {want}")
            check(all(np.isfinite(v) for m in (run["losses_first"], run["losses_second"]) for v in m.values()),
                  f"{path}: non-finite losses {run['losses_first']} {run['losses_second']}")
            del state
            out[path] = run
        argv = LAST_PATHS["tsrn_c2f"] + ["--vis_dir", "last_tsrn_c2f", "--config", seed_config_path, "--go_test",
                                         "--test_model", "SEED", "--resume", f"{root}/ckpt_last/last_tsrn_c2f"]
        start = time.perf_counter()
        md = cli.main(argv)
        torch.cuda.synchronize()
        go_s = time.perf_counter() - start
        args = AttrDict(vars(build_arg_parser().parse_args(argv)))
        mission = trainer.TextSR(load_config(seed_config_path), args, device="cuda")
        state = mission.init_state()
        rec = trainer.eval_recognizer("SEED", mission.config, "cuda")
        models = EvalModels(sr=state.sr, stu=state.stu, teacher=state.teacher, rec=rec).eval()
        step = make_eval_step(args, int(mission.config.TRAIN.width), device="cuda")
        (loader,) = mission.get_val_data()
        want = evaluate(step, models, list(loader), decoder=rec_decoder("SEED", mission.config.TRAIN.voc_type))
    finally:
        os.chdir(cwd)
    name = os.path.basename(split)
    check(list(md) == [name], f"--go_test --test_model SEED splits {list(md)}")
    check_metric_dicts(md[name], want, "--go_test --test_model SEED against evaluate in-process")
    check(md[name]["images"] == min(VAL_PAIRS), f"--go_test --test_model SEED: {md}")
    out["go_test_seed"] = {"split": name, "s": go_s, "metrics": md[name]}
    return out


def phase_last(root: str, train_dirs, val_dirs, crnn_ips: float):
    """Phase 16: ``tsrn_c2f --STN --mask``, ``sem_tsrn --mask`` and the
    flagship with ``--tpg OPT``, at full width, TF32 off.  (a) Each path's
    eval step and one fp32 train step at batch 8, card against CPU from the
    same weights and batch (phase 13's bounds), K1's launches in the step;
    then the flagship's eval step scored by SEED, its draw sharpened as phase
    14 sharpens ASTER's (phase 14's bounds).  (b) Each path's 10 fp32 and 10
    bf16 train steps at batch 48 and ``evaluate`` over 4 batches (a
    ``{"zoo_last": ...}`` line each, the host's load beside them);
    ``sem_tsrn`` at batch 512 where its batch-48 peak allows; the flagship's
    ``evaluate`` scored by SEED (phase 14's serving: images/s, kernels a
    batch, busy share).  (c) ``last_cli``.  Returns K1's launches: each
    path's fp32 and bf16 train runs of (b), each (forward, backward), and the
    SEED-scored eval's."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(16)
    small = with_aux(synthetic_batch(rng, CARD_VS_CPU_TRAIN_BATCH, labels=False))
    train_batches = [with_aux(synthetic_batch(rng, BATCH, labels=False)) for _ in range(TRAIN_WARMUP + ZOO_TRAIN_STEPS)]
    eval_batches = [synthetic_batch(rng, BATCH) for _ in range(1 + ZOO_EVAL_BATCHES)]
    launches = {}
    print(json.dumps({"zoo_host": host_load()}), flush=True)
    for path, argv in LAST_PATHS.items():
        s0 = time.perf_counter()
        srb = LAST_SRB[path]
        out = {"path": path, "flags": argv, "card_vs_cpu": zoo_card_vs_cpu(argv, small)}
        check(out["card_vs_cpu"]["k1_train_step_launches"] == (2 * srb, 2 * srb),
              f"{path}: K1 launched {out['card_vs_cpu']['k1_train_step_launches']} in a step")
        for dtype in ("fp32", "bf16"):
            out[dtype] = zoo_train(argv, dtype, train_batches)
            got = (out[dtype]["k1_launches"], out[dtype]["k1_backward_launches"])
            check(got == (2 * srb * ZOO_TRAIN_STEPS,) * 2,
                  f"{path} {dtype}: K1 launched {got} times in {ZOO_TRAIN_STEPS} steps")
            launches[(path, dtype)] = got
        out["eval"] = zoo_eval(argv, eval_batches)
        check(out["eval"]["k1_launches"] == 2 * srb * ZOO_EVAL_BATCHES, f"{path} eval: K1 launches")
        if path == "sem_tsrn":
            out["batch_512_fp32"] = sem_big_batch(rng, out["fp32"]["peak_mem_gib"])
        out["s"] = time.perf_counter() - s0
        print(json.dumps({"zoo_last": out}), flush=True)
    print(json.dumps({"zoo_host": host_load()}), flush=True)
    s0 = time.perf_counter()
    seed = {"recognizer": "SEED",
            "card_vs_cpu": {"tsrn_tl_cascade": rec_card_vs_cpu(TRAINER_FLAGS, "SEED",
                                                               synthetic_batch(rng, REC_CHECK_BATCH, labels=False))},
            "serve": rec_serve("SEED", eval_batches[0], eval_batches[1:], crnn_ips)}
    seed["s"] = time.perf_counter() - s0
    launches["seed_eval"] = seed["serve"]["k1_launches"]
    print(json.dumps({"rec_eval": seed}), flush=True)
    print(json.dumps({"zoo_last_cli": last_cli(root, train_dirs, val_dirs)}), flush=True)
    print(f"zoo_last: phase 16 took {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


def per_sr(rows, keys):
    """Each key summed over the two sweep rows at batch 48, times N_SRB: one
    SR forward (or backward) at batch 48; None where a row has none (a
    library call cuDNN refused)."""
    rows = [row for row in rows if row["label"].endswith(f"B={BATCH}")]
    return {k: None if any(row[k] is None for row in rows) else N_SRB * sum(row[k] for row in rows) for k in keys}


def forward_entry(dtype, shapes, ptxas, launches, max_err, **extra):
    """K1 forward's entry of the kernels line, in ``dtype``."""
    name = DTYPE_NAMES[dtype]
    per = per_sr(shapes, ("ms", "plain_ms", "library_ms", "bytes_ms", "operations_ms", "kernel_only_ms",
                          "kernel_only_bound_ms", "device_ms", "library_device_ms", "kernel_only_device_ms"))
    return {
        "name": "K1 bigru_seq" + ("" if dtype == torch.float32 else f" ({name}, tensor cores)"),
        "route": "cuda",
        "source": f"tpgsr_tpu_torch/csrc/{K1_SOURCES[dtype][0]}.cu",
        "replaces": "tpgsr_tpu/ops/pallas_gru.py:95",
        "dtype": name,
        "launches": launches,
        "max_abs_err": max_err,
        "unit": f"one flagship SR forward at batch {BATCH} in {name}: {N_SRB} sweeps over W and {N_SRB} over H",
        "ms": per["ms"],
        "kernel_ms": per["ms"],
        "plain_ms": per["plain_ms"],
        **bound_fields(per["bytes_ms"], per["operations_ms"]),
        "library_ms": per["library_ms"],
        "kernel_only_ms": per["kernel_only_ms"],
        "kernel_only_bound_ms": per["kernel_only_bound_ms"],
        "device_ms": per["device_ms"],
        "library_device_ms": per["library_device_ms"],
        "kernel_only_device_ms": per["kernel_only_device_ms"],
        "shapes": shapes,
        "ptxas": ptxas[dtype],
        **extra,
    }


def backward_entry(dtype, shapes, ptxas, launches, max_err, **extra):
    """K1 backward's entry of the kernels line, in ``dtype``."""
    name = DTYPE_NAMES[dtype]
    per = per_sr(shapes, ("ms", "kernel_only_ms", "fwd_bwd_ms", "library_ms", "plain_ms", "bytes_ms",
                          "operations_ms", "kernel_only_bound_ms"))
    return {
        "name": "K1 bigru_seq backward" + ("" if dtype == torch.float32 else f" ({name}, tensor cores)"),
        "route": "cuda",
        "source": f"tpgsr_tpu_torch/csrc/{K1_SOURCES[dtype][1]}.cu",
        "replaces": "tpgsr_tpu/ops/pallas_gru.py:34 (backward of)",
        "dtype": name,
        "launches": launches,
        "max_abs_err": max_err,
        "unit": (f"one flagship SR backward at batch {BATCH} in {name}: {N_SRB} sweeps over W and {N_SRB} over H; "
                 "ms: the recurrence's backward (the kernel, then the dW_hh GEMM and sums); kernel_only_ms: "
                 "the kernel alone; fwd_bwd_ms: the wrapper's forward and backward; library_ms: nn.GRU "
                 f"forward and backward in {name}; plain_ms: the plain BPTT"),
        "ms": per["ms"],
        "kernel_only_ms": per["kernel_only_ms"],
        "fwd_bwd_ms": per["fwd_bwd_ms"],
        "plain_ms": per["plain_ms"],
        **bound_fields(per["bytes_ms"], per["operations_ms"]),
        "kernel_only_bound_ms": per["kernel_only_bound_ms"],
        "library_ms": per["library_ms"],
        "shapes": shapes,
        "ptxas": ptxas[dtype],
        **extra,
    }


# K1's sources by storage type: (forward, backward)
K1_SOURCES = {torch.float32: ("bigru_seq", "bigru_seq_bwd"), torch.bfloat16: ("bigru_seq_bf16", "bigru_seq_bwd_bf16")}


def check_ptxas(name: str, backward: bool):
    """Phase 2's rows for one source: every instantiation (hidden size x
    ``instantiations``) reported, none spilling or keeping a stack frame."""
    rows = ptxas_report(_build.build_log(name), backward=backward)
    for r in rows:
        print(f"nvcc {name} " + json.dumps(r), flush=True)
    dtype = torch.bfloat16 if name.endswith("_bf16") else torch.float32
    want = len(gru_seq.SUPPORTED_HIDDEN) * len(instantiations(dtype, backward))
    check(len(rows) == want, f"ptxas reported {len(rows)} instantiations of {name}, expected {want}")
    check(all(r["spill_bytes"] == 0 and r["stack_bytes"] == 0 for r in rows),
          f"an instantiation of {name} spills registers or keeps a stack frame")
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs an NVIDIA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # seconds of each phase (or group), for the line before the kernels line
    seconds, last = {}, [time.perf_counter()]

    def lap(name: str) -> None:
        now = time.perf_counter()
        seconds[name], last[0] = now - last[0], now

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    logs = _build.build(_build.all_sources())
    print(f"build: {len(logs)} kernel source(s) compiled in {time.perf_counter() - t0:.1f} s", flush=True)
    ptxas = {dtype: check_ptxas(fwd, backward=False) for dtype, (fwd, _) in K1_SOURCES.items()}
    bwd_ptxas = {dtype: check_ptxas(bwd, backward=True) for dtype, (_, bwd) in K1_SOURCES.items()}
    lap("1-2 device, build")

    # 3. K1 against its plain version, fp32 and bf16
    max_err, shapes = phase_k1()
    bf16_err, bf16_shapes = phase_k1(torch.bfloat16)
    lap("3 K1")

    # 4. card vs CPU, 5. serve
    models, step = phase_card_vs_cpu()
    launches, serve_ips = phase_serve(models, step)
    del models, step
    lap("4-5 eval")

    # 6. K1's backward against its plain version, 7. train step card vs CPU, 8. train
    bwd_err, bwd_shapes = phase_k1_backward()
    bf16_bwd_err, bf16_bwd_shapes = phase_k1_backward(torch.bfloat16)
    lap("6 K1 backward")
    phase_train_card_vs_cpu()
    train_launches, backward_launches, train = phase_train()
    train_ips = train["images_per_s"]
    lap("7-8 train")

    # 9. the TextZoom data path, 10. the trainer and the CLI, 11. the bf16
    # train step, 12. the packaged YAML (bf16) through the CLI, 13. the SR
    # zoo, in one temporary directory
    with tempfile.TemporaryDirectory(prefix="textzoom-") as root:
        lmdb_train, lmdb_eval, train_dirs, val_dirs = phase_data(root, serve_ips, train_ips)
        lap("9 data")
        trainer_run = phase_trainer(root, train_dirs, val_dirs, lmdb_train["images_per_s"])
        lap("10 trainer")
        bf16_launches, bf16_backward_launches, bf16_train = phase_train_bf16(train)
        lap("11 bf16")
        packaged = phase_packaged_yaml(root, train_dirs, val_dirs)
        lap("12 packaged YAML")
        # 13. the SR zoo of the repo's other train scripts
        zoo = phase_zoo(root, train_dirs, val_dirs)
        lap("13 zoo")
        # 14. ASTER and MORAN as the eval recognizer
        rec_launches = phase_rec_eval(root, val_dirs, serve_ips)
        lap("14 eval recognizers")
        # 15. the rest of the single-model zoo
        rest = phase_zoo_rest(root, train_dirs, val_dirs)
        lap("15 rest of the zoo")
        # 16. the last two archs, --tpg OPT and SEED
        newest = phase_last(root, train_dirs, val_dirs, serve_ips)
        lap("16 last archs, OPT, SEED")

    kernels = [
        forward_entry(torch.float32, shapes, ptxas, launches, max_err, train_launches=train_launches,
                      lmdb_train_launches=lmdb_train["k1_launches"], lmdb_eval_launches=lmdb_eval["k1_launches"],
                      trainer_launches=trainer_run["k1_launches"], zoo_launches=zoo["fp32"][0],
                      rec_eval_launches=rec_launches, tl_simple_launches=rest["fp32"][0],
                      remat_launches=rest["remat"][0], c2f_launches=newest[("tsrn_c2f", "fp32")][0],
                      opt_launches=newest[("opt", "fp32")][0], sem_launches=newest[("sem_tsrn", "fp32")][0],
                      seed_eval_launches=newest["seed_eval"]),
        backward_entry(torch.float32, bwd_shapes, bwd_ptxas, backward_launches, bwd_err,
                       lmdb_train_launches=lmdb_train["k1_backward_launches"],
                       trainer_launches=trainer_run["k1_backward_launches"], zoo_launches=zoo["fp32"][1],
                       tl_simple_launches=rest["fp32"][1], remat_launches=rest["remat"][1],
                       c2f_launches=newest[("tsrn_c2f", "fp32")][1], opt_launches=newest[("opt", "fp32")][1]),
        forward_entry(torch.bfloat16, bf16_shapes, ptxas, bf16_launches, bf16_err,
                      train_images_per_s=bf16_train["bf16_images_per_s"],
                      packaged_yaml_launches=packaged["k1_launches"], zoo_launches=zoo["bf16"][0],
                      tl_simple_launches=rest["bf16"][0], c2f_launches=newest[("tsrn_c2f", "bf16")][0],
                      opt_launches=newest[("opt", "bf16")][0]),
        backward_entry(torch.bfloat16, bf16_bwd_shapes, bwd_ptxas, bf16_backward_launches, bf16_bwd_err,
                       packaged_yaml_launches=packaged["k1_backward_launches"], zoo_launches=zoo["bf16"][1],
                       tl_simple_launches=rest["bf16"][1], c2f_launches=newest[("tsrn_c2f", "bf16")][1],
                       opt_launches=newest[("opt", "bf16")][1]),
    ]
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} was not launched on its main path")
    print(json.dumps({"phase_seconds": seconds}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
