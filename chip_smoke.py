#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tpgsr_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout; needs one card

Phases, in order; any failure ends the run with a non-zero exit and no
result line (so does a missing card, or a missing ``tpgsr_tpu_torch``
package beside this script):

1. device: requires CUDA, prints the card's name and power limit;
2. build: compiles every kernel under tpgsr_tpu_torch/csrc with nvcc and
   checks that no instantiation of K1's forward or backward, fp32
   (csrc/bigru_seq.cu, csrc/bigru_seq_bwd.cu), bf16 on the tensor cores
   (csrc/bigru_seq_bf16.cu, csrc/bigru_seq_bwd_bf16.cu) or wide (H = 64
   and 128, both ways, both storage types: csrc/bigru_seq_wide.cu), spills;
3. K1 (the BiGRU recurrence) against its plain PyTorch version on the card,
   in fp32 and in bf16, at the flagship's two sweep shapes at batch 48 and
   at the packaged YAML's 512, at edge cases and at every compiled instantiation (hidden
   size x rows a thread in fp32, x rows an m-tile in bf16), with times
   beside the plain version, ``nn.GRU`` (in the same dtype) and the card's
   bound, and the launch configuration of each timed shape; then the wide
   kernels and the padded sizes (``phase_k1_wide``): the flagship's sweeps
   at ``--hd_u`` 64 and 128 (C = 2H, batch 48; timed the same way), a
   ragged N and T = 1 at each, H = 1, 12, 20, 40 and 100 padded to an
   instantiated size, and every wide instantiation forced; the wrapper's
   output the kernel's sliced back bit for bit, the padded units 0, the
   kernel held in fp32 to an fp64 recurrence on the same projection (at
   most twice the plain fp32 version's gap plus 1e-6) and in bf16 within
   one bf16 ulp of the plain version;
4. the flagship eval path on the card against the same path on the CPU;
5. serving: ``evaluate`` over 4 batches of 48 at full width, with K1's
   launches counted on that run alone;
6. K1's backward kernel (with the GEMM for dW_hh) against the plain BPTT on
   the card, in fp32 and in bf16, at the flagship's two sweeps at batch 48
   and 512, edge cases and every compiled instantiation, with times
   beside the plain version, ``nn.GRU`` forward + backward and the card's
   bound, and the launch configuration of each case; then phase 3's wide
   and padded cases backward (``phase_k1_wide_backward``): the padded
   units' gradients 0, dxp, dW_hh and db_hh by phase 3's rules, and the
   wrapper's gradients through the padding against its own on the CPU;
7. one flagship train step on the card against the same step on the CPU,
   from the same weights and batch: losses, every gradient, BN statistics
   (phases 5 and 8 also check that the flagship launches no wide kernel);
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
   preloaded, for the twin of the same shapes;
10. the trainer and the CLI: ``tpgsr_tpu_torch.cli.main`` in-process over
   phase 9's TextZoom (an epoch of 22 batches of 48), in the same
   temporary directory, from a config with ``compute_dtype: fp32``: one
   epoch with vals and saves at 11 and 22, its files and scalar log, its
   first two iterations against a CPU ``TextSR``, ``--resume`` into the
   second epoch for 3 iterations, loading in the calling process (step 25,
   global epoch 2's first batch),
   then ``--go_test`` over the three splits, and ``--go_test`` and ``--test
   --rec crnn`` over the smallest and ``--demo`` from the checkpoint against
   the same commands on the CPU; the ``trainer`` line
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
   end, finite first-iteration losses, the val's metric dicts against the
   fp32 eval step on the saved weights, and the loop's images/s between the
   first iteration and the val.
13. the SR zoo of the repo's other train scripts (``train_TSRN.sh``,
   ``train_SRCNN.sh``, ``train_TPGSR-SRCNN.sh``, ``train_SRResNet.sh``,
   ``train_TPGSR-SRResNet.sh``, ``train_RDN.sh``, ``train_TPGSR-RDN.sh``),
   each with its flags at batch 48 and full width, TF32 off: (a) the eval
   step and one fp32 train step on the card against the CPU from the same
   weights and batch; (b) 10 train steps after 2 warm-up steps in fp32 and
   in bf16 (images/s, peak memory, K1's launches: 10 + 10 a step for
   ``tsrn``, none for the others), then ``evaluate`` over 4 batches; a
   ``{"zoo": ...}`` line each; (c) ``cli.main`` with each script's flags
   and the packaged YAML in fp32 (``compute_dtype: fp32``), over phase 9's
   TextZoom (22 iterations, a val and a save), then ``--go_test`` from the
   checkpoint against the val; a ``{"zoo_cli": ...}`` line each.

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
   line each; then two of phase 13's plain archs' scripts through
   ``cli.main`` with ``--test`` from its fp32 checkpoint, ``srcnn`` with ASTER
   and ``tsrn`` with MORAN (a ``{"rec_eval_zoo_cli": ...}`` line).
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
17. the flags that choose the data, at full width: (a) phase 3's fp32
   forward also at batch-1 native sweeps (N=12, T=300; N=300, T=48; ...),
   each against the plain version and both recurrences against an fp64
   one; (b) ``--syn --random_reso --go_test`` through ``cli.main`` over 384
   words rendered at native sizes (heights 12-48, widths 24-320), each SR'd
   at its own size behind the confidence gate of a sharpened CRNN: the
   metric dict, images/s, ms an image and K1's launches (10 an image sent to
   SR); the first 16 words card against CPU (the gate's confidences and
   decisions, the metric dicts); (c) ``--random_reso --go_test`` over phase
   9's easy split, its first 16 pairs card against CPU; (d) ``--syn`` and
   ``--mixed`` over phase 9's train LMDBs and ``--ic15sr`` over a PGM tree
   at 128x32 / 64x16, each through ``cli.main`` in fp32 and on the packaged
   YAML (bf16), loading in the calling process: images/s over 10
   iterations with the host's load, K1's launches, the val and the save,
   ``--syn``'s first two fp32 iterations against the CPU.
18. data parallelism (``tpgsr_tpu_torch.parallel``) on the card: (a) two
   ranks sharing the card over gloo (``parallel.spawn(2, ...,
   device="cuda:0", backend="gloo")``) and one process run the flagship's
   fp32 step at global batch 48 (24 rows a rank, BatchNorm over the global
   batch, the gradients averaged) for 22 steps from the same weights and
   batches, the last 5 timed; one process runs them twice.  The first step
   at phase 7's bounds (K1 10 + 10 a rank); after the last, two ranks no
   farther from one process than twice the median of three one-process
   reruns' distances from it (the drift); ``evaluate`` over 4 val batches (the last of 29 rows) against
   the one-process metric dict; one bf16 step at phase 11's bounds of one
   process's.  (b) In the same group ``TextSR`` with TRAIN.n_devices 2
   through ``cli.run_rank`` (the CLI's per-rank function): phase 12's run
   (the packaged YAML, bf16, 22 iterations over phase 9's TextZoom, a val
   and a save) on two ranks: rank 0 alone writes, the checkpoint's keys
   and first losses are phase 12's, the val's metric dicts those of
   ``--go_test`` on rank 0's saved weights, the saved parameters no farther
   from phase 12's than twice the median of phase 12's command run again
   three times in one process;
   (c) one NCCL rank: three steps and an all-reduce.  A ``{"ddp": ...}``
   line with both images/s (two ranks sharing one card: not a scaling
   figure), each rank's K1 launches, the drifts with the vals beside them,
   and the card's name and power limit.
19. the dataset writers of ``data.create_lmdb``, the acceptance run and the
   packaged YAML's batch 512: (a) three splits of words rendered with PIL at phase 9's val sizes
   (HR 24-48 pixels high) written by ``data.create_lmdb.create_paired_dataset``,
   40 more pairs appended to the last by ``append_paired_dataset``
   (``append_lmdb``), every pair read back through ``TextZoomDataset`` as it
   was written and the first commit's snapshot by its meta slot; (b)
   ``python -m tpgsr_tpu_torch.accept_real --recognizers crnn,aster,moran``
   in-process over those splits at batch 48 with files in the original's
   layout written from seeded weights (``crnn.pth``, ``aster_demo.pth.tar``,
   ``moran_demo.pth``, a generator ``model_best_0.pth``), a third of the
   words relabelled with what each recognizer reads on their HR: every file
   ``[ok]``, each pass's images/s and K1's launches, each accuracy recounted
   by ``utils.metrics.accuracy`` from the decoded strings, every
   recognizer's HR accuracy above 0, and against the same passes over the
   first split on the CPU, the decoded SR, LR and HR strings one for one
   (ASTER's beam may differ only at the CPU's near ties) and the metric
   dicts; (c) the
   flagship's fp32 eval at batch 512, flat and in tiles of 64: SR at 2e-6
   and every output at 2e-5 apart, images/s and peak memory of each; (d)
   ``cli.main`` with no flags (``tsrn_tl_wmask``) on the packaged YAML at
   its batch 512 in bf16 for 20 iterations, a val over 528 pairs (flat: the YAML's
   ``eval_tile`` is 0) and a save: images/s, peak memory, K1's launches.  Phases 3 and 6 hold K1's
   fp32 kernels at batch 512's sweeps too.
20. ``--hd_u`` beyond 32 on the flagship: (a) one fp32 train step at batch 8
   on the card against the CPU at ``--hd_u`` 64 (the wide kernels) and 20
   (padded to 32), phase 7's bounds, K1 launched 10 + 10, on the wide
   kernels at 64 and not at 20; (b) ``cli.main`` at ``--hd_u 64`` on phase
   12's config (the packaged YAML, bf16, batch 48, 22 iterations, a val and
   a save), every K1 launch on the wide kernels, then ``--go_test`` from
   its checkpoint with the val's metric dicts; a ``{"hd_u": ...}`` line
   with images/s and peak memory beside phase 12's at ``--hd_u 32``.

The third line from the end is ``{"phase_seconds": {...}}``, each phase's
seconds; the line before the last is ``{"kernels": [...]}``: K1's forward and
backward in fp32 and in bf16 (``zoo_launches``: ``tsrn``'s in phase
13(b); ``rec_eval_launches``: phase 14(b)'s; ``tl_simple_launches``:
``tsrn_tl_wmask``'s in phase 15(b); ``remat_launches``: phase 15(a)'s
recomputed step; ``c2f_launches``, ``opt_launches``, ``sem_launches``: phase
16(b)'s; ``seed_eval_launches``: its SEED-scored eval; ``random_reso_launches``:
phase 17(b)'s; ``syn_launches``, ``mixed_launches``, ``ic15sr_launches``:
17(d)'s; ``ddp_launches``: each rank's in phase 18, the fp32 entries (a)'s
step, the bf16 ones (b)'s training; ``accept_launches``: phase 19(b)'s;
``b512_launches``: phase 19(c)'s and (d)'s val's in fp32, (d)'s training's
in bf16), and the wide kernel's four (launches: phase 20(a)'s ``--hd_u 64``
step in fp32, 20(b)'s train window in bf16); the last is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import itertools
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
from PIL import Image

from tpgsr_tpu_torch import accept_real, cli, entry, parallel
from tpgsr_tpu_torch.charset import AsterInfo, encode_ctc_padded, str_filt
from tpgsr_tpu_torch.bench_k1 import device_ms, ptxas_report
from tpgsr_tpu_torch.config import AttrDict, build_arg_parser, load_config, registry_dicts, script_argv
from tpgsr_tpu_torch.data.collate import CollateConfig, collate_syn_random_reso
from tpgsr_tpu_torch.data.create_lmdb import append_paired_dataset, create_paired_dataset, render_word
from tpgsr_tpu_torch.data.datasets import ConcatDataset, SingleImageLMDB, TextZoomDataset
from tpgsr_tpu_torch.data.lmdb import LMDBReader, write_lmdb
from tpgsr_tpu_torch.models import aster, moran
from tpgsr_tpu_torch.models.layers import BiGRUParams, init_torch_defaults_
from tpgsr_tpu_torch.models.registry import build_model
from tpgsr_tpu_torch.ops import _build, gru_seq, rnn, tiling
from tpgsr_tpu_torch.ops.ctc import decode_crnn
from tpgsr_tpu_torch.ops.image import append_contour_mask_u8
from tpgsr_tpu_torch.profile_eval import trace
from tpgsr_tpu_torch.profile_zoo import ARCH_FLAGS, argv_of
from tpgsr_tpu_torch.profile_zoo import mission as zoo_mission
from tpgsr_tpu_torch.train import random_reso
from tpgsr_tpu_torch.train import step as port_step
from tpgsr_tpu_torch.train import trainer
from tpgsr_tpu_torch.train.priors import parse_crnn_data
from tpgsr_tpu_torch.train.state import LR as TRAIN_LR
from tpgsr_tpu_torch.train.trainer import load_crnn
from tpgsr_tpu_torch.train.evaluate import evaluate
from tpgsr_tpu_torch.train.step import EvalModels, make_eval_step, make_train_step, rec_decoder, recognizer_input
from tpgsr_tpu_torch.utils import metrics

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, fp32 outside the tensor
# cores and dense bf16 on them; the comparisons run with TF32 off.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
PEAK_BF16_FLOP_PER_S = 989e12
DTYPE_NAMES = {torch.float32: "fp32", torch.bfloat16: "bf16"}

BATCH = 48
BIG_BATCH = 512  # the packaged YAML's TRAIN.batch_size
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
    # the first four cases are timed: the flagship's sweeps at batch 48 and at
    # the packaged YAML's 512
    cases = [
        ("sweep over W, B=48", BATCH * 16, 64, 64, 32, 2e-5),
        ("sweep over H, B=48", BATCH * 64, 16, 64, 32, 1e-5),
        ("sweep over W, B=512", BIG_BATCH * 16, 64, 64, 32, 2e-5),
        ("sweep over H, B=512", BIG_BATCH * 64, 16, 64, 32, 1e-5),
        ("ragged N", 771, 64, 64, 32, 2e-5),
        ("T=1", 37, 1, 64, 32, 1e-5),
        ("H=8", 100, 20, 16, 8, 1e-5),
        ("H=16", 100, 20, 32, 16, 1e-5),
        ("2 rows a thread, ragged", 1500, 16, 64, 32, 1e-5),
        ("4 rows a thread, ragged", 3070, 16, 64, 32, 1e-5),
        ("T=3 < S", 37, 3, 64, 32, 1e-5),
        ("T=13, not a multiple of S", 45, 13, 64, 32, 1e-5),
    ]
    timed = 4
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

    if dtype == torch.float32:
        native = native_k1_cases()
        shapes += native
        max_err = max([max_err] + [r["max_abs_err"] for r in native])

    # every compiled instantiation, forced, on a ragged N at T = 13 and T = 3
    # (the wide kernels': phase_k1_wide)
    for h in gru_seq.NARROW_HIDDEN:
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


# Phase 17's --random_reso runs the SR at batch 1 and each image's own size:
# over W, T = the LR's width and N = its height; over H, T = its height and
# N = its width (phase 17's words: heights 12-48, widths 24-320).  K1's fp32
# forward at such shapes lies 1.9e-7 from an fp64 recurrence on the same
# fp32 xp, the plain fp32 one 2.5e-7, the two 2.7e-7 apart (three seeds at
# these shapes and at N=24..320, T=12..320, on an H100 80GB HBM3 at 700 W):
# the recurrence contracts, and its rounding does not grow over 300 steps.
# Held at 1e-6, about twice the two gaps summed.
NATIVE_K1_CASES = (("native over W, 12x300", 12, 300), ("native over H, 300x48", 300, 48),
                   ("native 17x83", 17, 83), ("native over W, 48x320", 48, 320),
                   ("native over H, 320x48", 320, 48), ("native over W, 13x257", 13, 257))
NATIVE_K1_ATOL = 1e-6


def native_k1_cases():
    """Phase 3's fp32 forward at batch-1 native sweeps (C=64, H=32): the
    wrapper against the plain version at ``NATIVE_K1_ATOL``, and the
    recurrence of each (kernel, plain fp32) against an fp64 one on the same
    fp32 projection; device and plain times."""
    rows = []
    for i, (label, n, t) in enumerate(NATIVE_K1_CASES):
        x, fw, bw = gru_case(200 + i, n, t, 64, 32)
        with torch.no_grad():
            got = gru_seq.bigru(x, fw, bw)
            torch.cuda.synchronize()
            ref = rnn.bigru(x, fw, bw)
            err = float((got - ref).abs().max())
            check(torch.isfinite(got).all().item() and err <= NATIVE_K1_ATOL,
                  f"K1 {label}: max abs err {err:.3g} beyond {NATIVE_K1_ATOL}")
            xp = rnn.input_projection(x, fw, bw).contiguous()
            w_hh = torch.stack([fw["w_hh"], bw["w_hh"]]).contiguous()
            b_hh = torch.stack([fw["b_hh"], bw["b_hh"]]).contiguous()
            fp64 = rnn._recurrence(xp.double(), w_hh.double(), b_hh.double(), torch.float64)
            kernel = gru_seq._recurrence(xp, *gru_seq._kernel_weights(xp, w_hh, b_hh))
            plain = rnn.bigru_recurrence(xp, w_hh, b_hh)
            row = {"label": label, "dtype": "fp32", "N": n, "T": t, "C": 64, "H": 32, "max_abs_err": err,
                   "tol": NATIVE_K1_ATOL, "kernel_vs_fp64": float((kernel.double() - fp64).abs().max()),
                   "plain_vs_fp64": float((plain.double() - fp64).abs().max()),
                   **gru_seq.config_for(n, 32, x.device)._asdict(),
                   "device_ms": device_ms(lambda: gru_seq.bigru(x, fw, bw)),
                   "plain_ms": median_ms(lambda: rnn.bigru(x, fw, bw), 3, warmup=1)}
        print("K1 native " + json.dumps(row), flush=True)
        rows.append(row)
    return rows


def instantiations(dtype: torch.dtype, backward: bool = False, hidden: int = 32):
    """Launch configurations that force each compiled instantiation of K1's
    forward (or backward) in ``dtype`` at ``hidden``: rows a thread in fp32
    and in the wide kernels, rows an m-tile in the bf16 tensor-core ones
    (the bf16 backward's 8 only)."""
    if dtype == torch.bfloat16 and hidden in gru_seq.NARROW_HIDDEN:
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
    gru_seq.WIDE_LAUNCHES = 0
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
    check(gru_seq.WIDE_LAUNCHES == 0, f"the flagship (--hd_u 32) launched a wide kernel {gru_seq.WIDE_LAUNCHES} times")
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
    # the first four cases are timed: the flagship's sweeps at batch 48 and at
    # the packaged YAML's 512
    cases = [
        ("sweep over W, B=48", BATCH * 16, 64, 64, 32),
        ("sweep over H, B=48", BATCH * 64, 16, 64, 32),
        ("sweep over W, B=512", BIG_BATCH * 16, 64, 64, 32),
        ("sweep over H, B=512", BIG_BATCH * 64, 16, 64, 32),
        ("ragged N", 771, 64, 64, 32),
        ("T=1", 37, 1, 64, 32),
        ("T=3", 37, 3, 64, 32),
        ("H=8", 100, 20, 16, 8),
        ("H=16", 100, 20, 32, 16),
    ]
    timed = 4
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
    # (the wide kernels': phase_k1_wide_backward)
    for h in gru_seq.NARROW_HIDDEN:
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


# phases 3 and 6 beyond the flagship's H = 32: the wide kernels
# (csrc/bigru_seq_wide.cu) at --hd_u 64 and 128 and the sizes padded to an
# instantiated one (ops/gru_seq.py::padded_hidden).  The flagship's two
# sweeps at batch 48 with C = 2H are timed at each wide size.
WIDE_SWEEP_HIDDEN = (64, 128)
PADDED_HIDDEN = (1, 12, 20, 40, 100)
# fp32: the kernel's gap to an fp64 recurrence on the same projection is at
# most WIDE_FP64_FACTOR times the plain fp32 version's gap plus
# WIDE_FP64_ATOL (``fp64_rule``): a fixed atol does not scale to sums of
# up to 3 x 128 terms.  bf16: within one bf16 ulp of the plain version's
# plus phase 3's (6's) atol, as ``agrees`` holds the tensor-core kernels.
WIDE_FP64_FACTOR = 2.0
WIDE_FP64_ATOL = 1e-6


def wide_cases():
    """(label, N, T, C, H, timed) of phases 3's and 6's wide and padded cases."""
    cases = []
    for h in WIDE_SWEEP_HIDDEN:
        cases += [(f"sweep over W, B={BATCH}, H={h}", BATCH * 16, 64, 2 * h, h, True),
                  (f"sweep over H, B={BATCH}, H={h}", BATCH * 64, 16, 2 * h, h, True),
                  (f"ragged N, H={h}", 771, 13, 2 * h, h, False), (f"T=1, H={h}", 37, 1, 2 * h, h, False)]
    return cases + [(f"padded H={h}", 100, 20, 2 * h, h, False) for h in PADDED_HIDDEN]


def padded_case(seed: int, n: int, t: int, c: int, h: int, dtype: torch.dtype):
    """(x, fw, bw) at the real ``h`` and the wrapper's operands at the
    instantiated size: (xp [N, T, 6Hp], w_hh [2, 3Hp, Hp], b_hh [2, 3Hp]),
    from the zero-padded weights, as ``gru_seq.bigru`` forms them."""
    x, fw, bw = gru_case(seed, n, t, c, h)
    x = x.to(dtype)
    hp = gru_seq.padded_hidden(h)
    pfw, pbw = (rnn.pad_hidden(d, hp) for d in (fw, bw))
    xp = rnn.input_projection(x, pfw, pbw).contiguous()
    return x, fw, bw, (xp, torch.stack([pfw["w_hh"], pbw["w_hh"]]), torch.stack([pfw["b_hh"], pbw["b_hh"]]))


def padded_units(h: int, hp: int, gates: int) -> torch.Tensor:
    """The padded columns of a [.., 2 * gates * Hp] tensor (both directions'
    ``gates`` gates of Hp units each, H real)."""
    cols = torch.zeros(2 * gates * hp, dtype=torch.bool)
    cols.view(2 * gates, hp)[:, h:] = True
    return cols.cuda()


def fp64_rule(kernel, plain, fp64, what: str, scale: float = 1.0) -> dict:
    """The fp32 rule: ``kernel``'s max gap to ``fp64`` at most
    WIDE_FP64_FACTOR times ``plain``'s plus WIDE_FP64_ATOL, both gaps
    divided by ``scale`` (dW_hh is 0 at T = 1, where h_{t-1} is 0, on every
    side)."""
    scale = max(scale, 1e-30)
    k = float((kernel.double() - fp64).abs().max()) / scale
    p = float((plain.double() - fp64).abs().max()) / scale
    check(k <= WIDE_FP64_FACTOR * p + WIDE_FP64_ATOL,
          f"{what}: kernel {k:.3g} from fp64, plain fp32 {p:.3g} (allowed {WIDE_FP64_FACTOR} x + {WIDE_FP64_ATOL})")
    return {"kernel_vs_fp64": k, "plain_vs_fp64": p}


def wide_forward_check(label: str, n: int, t: int, c: int, h: int, dtype: torch.dtype, seed: int):
    """One wide or padded forward case: the wrapper's output equals the
    kernel's at the instantiated size sliced back, bit for bit; the padded
    units are exactly 0; the kernel is held to the plain version on the same
    projection (fp32: ``fp64_rule``; bf16: ``agrees``).  Returns (x, fw,
    bw, kernel operands, row)."""
    x, fw, bw, (xp, w_hh, b_hh) = padded_case(seed, n, t, c, h, dtype)
    hp = xp.shape[-1] // 6
    with torch.no_grad():
        got = gru_seq.bigru(x, fw, bw)
        kernel = gru_seq._launch(xp, w_hh, b_hh)
        torch.cuda.synchronize()
        plain = rnn.bigru_recurrence(xp, w_hh, b_hh)
        real = rnn.bigru(x, fw, bw)
    tag = f"K1 wide {DTYPE_NAMES[dtype]} {label}"
    check(got.dtype == dtype and torch.isfinite(got).all().item(), f"{tag}: non-finite output")
    check(torch.equal(got, rnn.unpad_output(kernel, h)), f"{tag}: the wrapper is not the kernel's output sliced")
    check(not kernel[..., padded_units(h, hp, 1)].any().item(), f"{tag}: a padded unit is not 0")
    err = float((kernel.float() - plain.float()).abs().max())
    row = {"label": label, "dtype": DTYPE_NAMES[dtype], "N": n, "T": t, "C": c, "H": h, "Hp": hp, "max_abs_err": err,
           "real_h_gap": float((got.float() - real.float()).abs().max())}
    if dtype == torch.float32:
        fp64 = rnn._recurrence(xp.double(), w_hh.double(), b_hh.double(), torch.float64)
        row.update(fp64_rule(kernel, plain, fp64, tag))
    else:
        tol = 2e-5 if t >= 64 else 1e-5
        check(agrees(kernel, plain, tol), f"{tag}: max abs err {err:.3g} beyond one bf16 ulp + {tol}")
        row["tol"] = tol
    return x, fw, bw, (xp, w_hh, b_hh), row


def phase_k1_wide(dtype: torch.dtype = torch.float32):
    """Phase 3 beyond H = 32 in ``dtype``: every ``wide_cases`` case by
    ``wide_forward_check``, the timed sweeps with times beside the plain
    version, ``nn.GRU`` (at the real H, in ``dtype``) and the card's bound;
    then every instantiation of the wide kernel, forced, on a ragged N at T
    = 13 and T = 3.  Returns (max_abs_err, rows)."""
    name = DTYPE_NAMES[dtype]
    elem = torch.finfo(dtype).bits // 8
    max_err, rows = 0.0, []
    for i, (label, n, t, c, h, timed) in enumerate(wide_cases()):
        x, fw, bw, operands, row = wide_forward_check(label, n, t, c, h, dtype, 400 + i)
        max_err = max(max_err, row["max_abs_err"])
        row.update(gru_seq.config_for(n, row["Hp"], x.device, dtype=dtype)._asdict())
        if timed:
            lib = library_gru(c, h, fw, bw, dtype)
            with torch.no_grad():
                kernel_args = (operands[0], *gru_seq._kernel_weights(*operands))
                library_ms, library_note = library_time(lambda: lib(x), device_ms)
                row.update({
                    "ms": median_ms(lambda: gru_seq.bigru(x, fw, bw), 50),
                    "device_ms": device_ms(lambda: gru_seq.bigru(x, fw, bw)),
                    "kernel_only_ms": device_ms(lambda: gru_seq._recurrence(*kernel_args)),
                    "plain_ms": median_ms(lambda: rnn.bigru(x, fw, bw), 5, warmup=1),
                    "library_ms": library_ms})
                if library_note:
                    row["library_note"] = library_note
            row["bytes_ms"], row["operations_ms"] = bigru_bound_ms(n, t, c, h, projection=True, elem=elem)
            row.update(bound_fields(row["bytes_ms"], row["operations_ms"]))
            row.update(bound_fields(*bigru_bound_ms(n, t, c, h, projection=False, elem=elem), prefix="kernel_only_"))
        print(f"K1 wide {name} " + json.dumps(row), flush=True)
        rows.append(row)
    for h in gru_seq.WIDE_HIDDEN:
        n = 3 * gru_seq.block_rows(h, max(gru_seq.RPTS)) + 5
        x, fw, bw = gru_case(500 + h, n, 13, 16, h)
        x = x.to(dtype)
        w_hh = torch.stack([fw["w_hh"], bw["w_hh"]])
        b_hh = torch.stack([fw["b_hh"], bw["b_hh"]])
        for t in (13, 3):
            xp = rnn.input_projection(x[:, :t].contiguous(), fw, bw).contiguous()
            plain = rnn.bigru_recurrence(xp, w_hh, b_hh)
            fp64 = rnn._recurrence(xp.double(), w_hh.double(), b_hh.double(), torch.float64)
            for forced in instantiations(dtype, hidden=h):
                got = gru_seq._recurrence(xp, *gru_seq._kernel_weights(xp, w_hh, b_hh), config=forced)
                torch.cuda.synchronize()
                tag = f"K1 wide {name} H={h} {forced} T={t}"
                if dtype == torch.float32:
                    fp64_rule(got, plain, fp64, tag)
                else:
                    check(agrees(got, plain, 1e-5), f"{tag}: beyond one bf16 ulp + 1e-5")
                max_err = max(max_err, float((got.float() - plain.float()).abs().max()))
        print(f"K1 wide {name} H={h}: rows a thread {[f[0] for f in instantiations(dtype, hidden=h)]} at N={n}, "
              "T=13 and T=3 agree", flush=True)
    return max_err, rows


def wide_backward_check(label: str, n: int, t: int, c: int, h: int, dtype: torch.dtype, seed: int,
                        autograd: bool):
    """One wide or padded backward case at the instantiated size, on the
    kernel's own forward output and a cotangent zero on the padded units (as
    the wrapper's slice gives it): dxp, dW_hh and db_hh exactly 0 on the
    padded units, and held to the plain BPTT on the same operands (fp32:
    ``fp64_rule``, dW_hh and db_hh relative to their largest fp64 entry;
    bf16: dxp within one bf16 ulp plus atol, dW_hh and db_hh at 1e-4 of
    their largest entry).  With ``autograd``, the wrapper's gradients
    against the wrapper's on CPU copies (the plain versions at the real H,
    whose backward also reads h_{t-1} from the stored output): each
    gradient within 1e-4 (bf16: 1e-2) of its own norm.  Returns (x, fw, bw,
    kernel operands, out, grad_out, row)."""
    x, fw, bw, (xp, w_hh, b_hh) = padded_case(seed, n, t, c, h, dtype)
    hp = xp.shape[-1] // 6
    tag = f"K1 wide backward {DTYPE_NAMES[dtype]} {label}"
    out = gru_seq._launch(xp, w_hh, b_hh)
    g = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal((n, t, 2 * h)).astype(np.float32))
    g = g.to("cuda", dtype)
    grad_out = torch.zeros(n, t, 2 * hp, device="cuda", dtype=dtype)
    grad_out[..., ~padded_units(h, hp, 1)] = g
    got = gru_seq.recurrence_backward(xp, w_hh, b_hh, out, grad_out)
    torch.cuda.synchronize()
    want = rnn.bigru_recurrence_backward(xp, w_hh, b_hh, out, grad_out)
    check(all(torch.isfinite(v).all().item() for v in got), f"{tag}: non-finite output")
    pad3 = padded_units(h, hp, 3)
    pad_w = pad3.view(2, 3 * hp)[0]
    check(not got[0][..., pad3].any().item() and not got[1][:, pad_w].any().item()
          and not got[1][:, :, h:].any().item() and not got[2][:, pad_w].any().item(),
          f"{tag}: a padded unit's gradient is not 0")
    err = float((got[0].float() - want[0].float()).abs().max())
    row = {"label": label, "dtype": DTYPE_NAMES[dtype], "N": n, "T": t, "C": c, "H": h, "Hp": hp, "max_abs_err": err}
    if dtype == torch.float32:
        fp64 = rnn._recurrence_backward(xp.double(), w_hh.double(), b_hh.double(), out.double(), grad_out.double())
        row["dxp"] = fp64_rule(got[0], want[0], fp64[0], f"{tag} dxp")
        for k, name in ((1, "dw_hh"), (2, "db_hh")):
            row[name] = fp64_rule(got[k], want[k], fp64[k], f"{tag} {name}", float(fp64[k].abs().max()))
    else:
        tol = 5e-5 if t >= 64 else 2e-5
        ok, rel = backward_agrees(got, want, tol, 1e-4)
        check(ok, f"{tag}: dxp max abs err {err:.3g} (tol {tol} + 1 bf16 ulp), dW_hh / db_hh rel err {rel} (tol 1e-4)")
        row.update({"tol": tol, "w_b_rel_err": max(rel)})
    if autograd:
        grads = []
        for dev in ("cuda", "cpu"):
            leaves = [x.detach().to(dev, copy=True).requires_grad_(True)] + [
                {k: v.detach().to(dev, copy=True).requires_grad_(True) for k, v in d.items()} for d in (fw, bw)]
            gru_seq.bigru(*leaves).backward(g.to(dev))
            grads.append([leaves[0].grad.cpu()] + [d[k].grad.cpu() for d in leaves[1:] for k in sorted(d)])
        rel = max(float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))
                  for a, b in zip(*grads))
        check(all(a.shape == b.shape for a, b in zip(*grads)) and rel <= (1e-4 if dtype == torch.float32 else 1e-2),
              f"{tag}: the wrapper's gradients {rel:.3g} from its own on the CPU")
        row["autograd_rel_err"] = rel
    return x, fw, bw, (xp, w_hh, b_hh), out, grad_out, row


def phase_k1_wide_backward(dtype: torch.dtype = torch.float32):
    """Phase 6 beyond H = 32 in ``dtype``: every ``wide_cases`` case by
    ``wide_backward_check`` (the untimed ones also through the wrapper's
    autograd), the timed sweeps with times beside the plain BPTT, ``nn.GRU``
    forward + backward and the card's bound; then every instantiation,
    forced, on a ragged N at T = 13 and T = 3.  Returns (max_abs_err, rows)."""
    name = DTYPE_NAMES[dtype]
    elem = torch.finfo(dtype).bits // 8
    max_err, rows = 0.0, []
    for i, (label, n, t, c, h, timed) in enumerate(wide_cases()):
        x, fw, bw, (xp, w_hh, b_hh), out, grad_out, row = wide_backward_check(label, n, t, c, h, dtype, 600 + i,
                                                                               autograd=not timed)
        max_err = max(max_err, row["max_abs_err"])
        row.update(gru_seq.config_for(n, row["Hp"], x.device, backward=True, dtype=dtype)._asdict())
        if timed:
            w_t, b_k = gru_seq._kernel_weights(xp, w_hh, b_hh)
            leaves = [x.clone().requires_grad_(True), *({k: v.clone().requires_grad_(True) for k, v in d.items()}
                                                        for d in (fw, bw))]
            g = grad_out[..., ~padded_units(h, row["Hp"], 1)].contiguous()
            lib = library_gru(c, h, fw, bw, dtype)
            x_lib = x.clone().requires_grad_(True)
            library_ms, library_note = library_time(lambda: lib(x_lib)[0].backward(g), device_ms)
            row.update({
                "ms": device_ms(lambda: gru_seq.recurrence_backward(xp, w_hh, b_hh, out, grad_out)),
                "kernel_only_ms": device_ms(lambda: gru_seq._backward_kernel(xp, w_t, b_k, out, grad_out)),
                "fwd_bwd_ms": device_ms(lambda: gru_seq.bigru(*leaves).backward(g)),
                "library_ms": library_ms,
                "plain_ms": median_ms(lambda: rnn.bigru_recurrence_backward(xp, w_hh, b_hh, out, grad_out), 5,
                                      warmup=1)})
            if library_note:
                row["library_note"] = library_note
            row["bytes_ms"], row["operations_ms"] = bigru_backward_bound_ms(n, t, h, elem)
            row.update(bound_fields(row["bytes_ms"], row["operations_ms"]))
            row.update(bound_fields(*bigru_backward_bound_ms(n, t, h, elem, kernel_only=True), prefix="kernel_only_"))
        print(f"K1 wide backward {name} " + json.dumps(row), flush=True)
        rows.append(row)
    for h in gru_seq.WIDE_HIDDEN:
        n = 3 * gru_seq.block_rows(h, max(gru_seq.RPTS)) + 5
        for t in (13, 3):
            _, _, _, xp, w_hh, b_hh, out, grad_out = backward_case(700 + h + t, n, t, 16, h, dtype)
            kernel_weights = gru_seq._kernel_weights(xp, w_hh, b_hh)
            want = rnn.bigru_recurrence_backward(xp, w_hh, b_hh, out, grad_out)
            fp64 = rnn._recurrence_backward(xp.double(), w_hh.double(), b_hh.double(), out.double(),
                                            grad_out.double()) if dtype == torch.float32 else None
            for forced in instantiations(dtype, backward=True, hidden=h):
                dxp, dhp, h_prev = gru_seq._backward_kernel(xp, *kernel_weights, out, grad_out, config=forced)
                got = (dxp, *gru_seq.recurrent_weight_grads(dhp, h_prev))
                torch.cuda.synchronize()
                tag = f"K1 wide backward {name} H={h} {forced} T={t}"
                if fp64 is not None:
                    fp64_rule(got[0], want[0], fp64[0], f"{tag} dxp")
                    for k in (1, 2):
                        fp64_rule(got[k], want[k], fp64[k], f"{tag} dW_hh/db_hh", float(fp64[k].abs().max()))
                else:
                    ok, rel = backward_agrees(got, want, 2e-5, 1e-4)
                    check(ok, f"{tag}: dxp beyond one bf16 ulp + 2e-5 or dW_hh / db_hh rel err {rel} beyond 1e-4")
                max_err = max(max_err, float((got[0].float() - want[0].float()).abs().max()))
        print(f"K1 wide backward {name} H={h}: rows a thread "
              f"{[f[0] for f in instantiations(dtype, backward=True, hidden=h)]} at N={n}, T=13 and T=3 agree",
              flush=True)
    return max_err, rows


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


def phase_train_card_vs_cpu(hidden_units: int = 32):
    """One flagship train step at ``hidden_units`` (``--hd_u``) from the same
    seeded weights and numpy batch on the card and on the CPU (plain
    versions); returns K1's launches in the card's step, (forward, backward,
    wide forward, wide backward).  Gradients are compared, not
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
    card, card_step = entry.flagship_train(device="cuda", seed=0, hidden_units=hidden_units)
    cpu, cpu_step = entry.flagship_train(device="cpu", seed=0, hidden_units=hidden_units)
    before = k1_counts()
    m_card = card_step(card, batch)
    torch.cuda.synchronize()
    launches = tuple(b - a for a, b in zip(before, k1_counts()))
    m_cpu = cpu_step(cpu, batch)
    for k in m_cpu:
        got, want = float(m_card[k]), float(m_cpu[k])
        check(np.isfinite(got) and abs(got - want) <= 1e-5 * abs(want), f"train {k}: card {got} vs CPU {want}")
    worst = {**check_card_grads("sr", card.sr[0], cpu.sr[0], 5e-3),
             **check_card_grads("stu", card.stu[0], cpu.stu[0], 3e-2)}
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:5]
    print(f"train card vs CPU (batch {CARD_VS_CPU_TRAIN_BATCH}, --hd_u {hidden_units}): losses "
          f"{ {k: float(v) for k, v in m_card.items()} }; worst gradient rel errs {top}; K1 launches {launches}",
          flush=True)
    return launches


def k1_counts():
    """K1's launch counts: (forward, backward, wide forward, wide backward)."""
    return (gru_seq.LAUNCHES, gru_seq.BACKWARD_LAUNCHES, gru_seq.WIDE_LAUNCHES, gru_seq.WIDE_BACKWARD_LAUNCHES)


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
    gru_seq.WIDE_LAUNCHES = 0
    gru_seq.WIDE_BACKWARD_LAUNCHES = 0
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
    check(gru_seq.WIDE_LAUNCHES == gru_seq.WIDE_BACKWARD_LAUNCHES == 0,
          "the flagship (--hd_u 32) launched a wide kernel in training")
    check(state.step == TRAIN_WARMUP + TRAIN_STEPS, f"train state at step {state.step}")
    train = {"compute_dtype": compute_dtype, "batch": BATCH, "steps": TRAIN_STEPS,
             "images_per_s": BATCH * TRAIN_STEPS / event_s,
             "ms_per_step": event_s * 1e3 / TRAIN_STEPS, "event_s": event_s, "host_s": host_s,
             "k1_launches": launches, "k1_backward_launches": backward_launches,
             "loss_first": losses[0], "loss_last": losses[-1],
             "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    print("train " + json.dumps(train), flush=True)
    return launches, backward_launches, train


def _jpeg(img: Image.Image) -> bytes:
    buf = io.BytesIO()
    img.save(buf, "JPEG", quality=92)
    return buf.getvalue()


def random_words(rng, n: int):
    """``n`` words of 3 to 10 letters and digits drawn from ``rng``."""
    alphabet = np.array(list("0123456789abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"))
    return ["".join(rng.choice(alphabet, rng.integers(3, 11))) for _ in range(n)]


def make_textzoom_lmdb(path: str, n: int, seed: int) -> str:
    """An lmdbDataset_real-style LMDB of ``n`` pairs (HR 128x32, LR 64x16
    JPEGs) of seeded words of 3 to 10 letters and digits."""
    items = [(b"num-samples", str(n).encode())]
    for i, word in enumerate(random_words(np.random.default_rng(seed), n), 1):
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
    train = phase_lmdb_train("port", port_loader(train_dirs))
    ev = phase_lmdb_eval(val_dirs)
    summary = {"loader_epoch1_pairs_per_s": loader["epoch1_pairs_per_s"],
               "loader_epoch2_pairs_per_s": loader["epoch2_pairs_per_s"],
               "lmdb_train_images_per_s": train["images_per_s"], "phase8_train_images_per_s": train_ips,
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
# phase 10's config with the loaders in the calling process, for the
# eval-only runs from its checkpoint
EVAL_CONFIG = "trainer_eval.yaml"
SAVE_FILES = ("checkpoint_0.pth", "recognizer_0.pth", "opt_state.pth", "info.json")


class TrainerProbe:
    """What phases 10 and 12 read of a ``TextSR`` run, by wrappers installed
    for one run: the first two train steps' metrics, the first batch, the
    end of the first step with K1's counts there, each step's compute dtype,
    and each val's and save's start and end (the card synchronized at both)
    with K1's counts there and the val's metric dicts."""

    def __init__(self, marks=()):
        self.metrics, self.first_batch, self.first_step_end, self.events = [], None, None, []
        self.first_step_counts, self.compute_dtypes = None, []
        # the card synchronized and the clock read at the end of these steps (1-based)
        self.marks, self.mark_times, self.steps = tuple(marks), {}, 0

    @contextlib.contextmanager
    def installed(self):
        make, run_val, save = trainer.make_train_step, trainer.TextSR._run_val, trainer.TextSR._save

        def make_train_step(*a, **k):
            step = make(*a, **k)
            self.compute_dtypes.append(k.get("compute_dtype", "fp32"))

            def recorded(state, batch):
                metrics = step(state, batch)
                self.steps += 1
                if self.steps in self.marks:
                    torch.cuda.synchronize()
                    self.mark_times[self.steps] = time.perf_counter()
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
    2. ``--resume`` into the next epoch for RESUMED_ITERATIONS iterations,
       the loaders in the calling process: the step reaches 25 and the first
       batch is global epoch 2's;
    3. ``--go_test`` over the three splits on the card, then ``--go_test``
       and ``--test --rec crnn`` over the smallest split and ``--demo`` over
       four PNGs, each from the checkpoint, against the same command on the
       CPU;
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
    # the eval-only runs from the checkpoint (here and in phase 14) load in
    # the calling process: a loader worker's start costs a run several seconds
    t.workers = 0
    with open(f"{root}/{EVAL_CONFIG}", "w") as f:
        json.dump(cfg, f)
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


# phase 10's resumed run: the iterations of global epoch 2 it trains
RESUMED_ITERATIONS = 3


@contextlib.contextmanager
def val_in_process():
    """``TextSR`` builds its val loaders with TRAIN.workers 0 while the
    block runs (its train loader keeps the config's workers): each val
    loader's worker start costs phases 12 and 20 about 20-30 s a run, and
    the batches are the same either way."""
    get_val_data = trainer.TextSR.get_val_data

    def in_process(mission, dirs=None):
        t = mission.config.TRAIN
        workers, t.workers = t.workers, 0
        try:
            return get_val_data(mission, dirs)
        finally:
            t.workers = workers

    trainer.TextSR.get_val_data = in_process
    try:
        yield
    finally:
        trainer.TextSR.get_val_data = get_val_data


class FirstBatches:
    """A train loader cut to the first ``count`` batches of each epoch; its
    length (so the trainer's global iterations) and sampler are the
    loader's."""

    def __init__(self, loader, count: int):
        self.loader, self.count = loader, count
        self.batch_sampler = loader.batch_sampler

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self):
        return itertools.islice(iter(self.loader), self.count)


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

    # 2. resume for RESUMED_ITERATIONS iterations of the next epoch, loading
    # in the calling process (the batches are the sampler's either way; a
    # loader worker's start costs seconds)
    eval_path = f"{os.path.dirname(argv[-1])}/{EVAL_CONFIG}"
    resumed = TRAINER_EPOCH + RESUMED_ITERATIONS
    resume_cfg, resume_path = load_config(eval_path), f"{os.path.dirname(argv[-1])}/trainer_resume.yaml"
    resume_cfg.TRAIN.saveInterval = resumed  # a save at the resumed run's last iteration
    with open(resume_path, "w") as f:
        json.dump(resume_cfg, f)  # JSON is YAML
    probe = TrainerProbe()
    get_train_data = trainer.TextSR.get_train_data
    trainer.TextSR.get_train_data = lambda mission: FirstBatches(get_train_data(mission), RESUMED_ITERATIONS)
    try:
        with probe.installed():
            state = cli.main(argv[:-1] + [resume_path, "--resume", ckpt_dir])
    finally:
        trainer.TextSR.get_train_data = get_train_data
    check(state.step == resumed, f"resumed trainer at step {state.step}")
    with open(f"{ckpt_dir}/info.json") as f:
        check(json.load(f)["step"] == resumed, "info.json after the resume")
    ref_loader = trainer.train_loader(train_dirs, "tsrn_tl_cascade", mask=True, **loader_kw(BATCH, "cpu", workers=0))
    ref_loader.batch_sampler.epoch = 1
    ref = next(iter(ref_loader))
    check(probe.first_batch["labels"] == list(ref["labels"]) and torch.equal(probe.first_batch["hr"], ref["hr"]),
          "the first resumed batch is not global epoch 2's")
    print(f"trainer resumed to step {state.step}; first batch is global epoch 2's", flush=True)
    del state

    # 3. the eval-only modes from the checkpoint: --go_test over the three
    # splits on the card, then over the smallest split, --test over it and
    # --demo on the card and on the CPU
    eval_argv = argv[:-1] + [eval_path, "--resume", ckpt_dir]
    smallest = val_dirs[int(np.argmin(VAL_PAIRS))]
    small_cfg, small_path = load_config(eval_path), f"{os.path.dirname(argv[-1])}/trainer_smallest.yaml"
    small_cfg.TRAIN.VAL.val_data_dir = [smallest]
    with open(small_path, "w") as f:
        json.dump(small_cfg, f)  # JSON is YAML
    small_argv = argv[:-1] + [small_path, "--resume", ckpt_dir]
    go = cli.main(eval_argv + ["--go_test", "--vis_dir", "go_all"])
    check(list(go) == ["easy", "medium", "hard"], f"--go_test splits {list(go)}")
    modes = {}
    for dev in ("cuda", "cpu"):
        small = cli.main(small_argv + ["--go_test", "--vis_dir", f"go_{dev}"], device=dev)
        test = cli.main(eval_argv + ["--test", "--rec", "crnn", "--test_data_dir", smallest], device=dev)
        demo = cli.main(eval_argv + ["--demo", "--demo_dir", demo_dir], device=dev)
        modes[dev] = (small, test, demo, sorted(os.listdir(f"demo/go_{dev}/1")))
    (small, test, demo, vis), (cpu_small, cpu_test, cpu_demo, cpu_vis) = modes["cuda"], modes["cpu"]
    name = trainer.split_name(smallest)
    check(list(small) == list(cpu_small) == [name], f"--go_test over the smallest split: {list(small)}")
    check_metric_dicts(small[name], go[name], f"--go_test {name} alone against the three splits' run")
    check_metric_dicts(small[name], cpu_small[name], f"--go_test {name}")
    check_metric_dicts(test, cpu_test, "--test")
    check(test["images"] == min(VAL_PAIRS) and test["fps"] > 0, f"--test: {test}")
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
    ctc_labels, ctc_lengths = encode_ctc_padded(batch["labels"], CTC_LABEL_LEN)
    return {"hr": batch["hr"], "lr": batch["lr"], "ctc_labels": ctc_labels, "ctc_lengths": ctc_lengths,
            "weighted_tics": np.ones(len(ctc_lengths), np.float32)}


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
    22; finite first-iteration losses (phase 11(a) holds the bf16 step to
    the CPU's); the val's metric dicts equal the fp32 eval step's on the
    saved weights (PSNR and SSIM at 1e-4); the loop's images/s and K1's
    launches between the end of the first iteration and the val; peak
    memory.  The val loaders load in the calling process
    (``val_in_process``)."""
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
        torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        with probe.installed(), val_in_process():
            state = cli.main(argv)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - start
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
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
        check(all(np.isfinite(v) for v in card.values()), f"packaged YAML iteration 1: losses {card}")
        del state

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
           "peak_mem_gib": peak_gib, "k1_launches": window[0], "k1_backward_launches": window[1],
           "card_losses": card}
    print(json.dumps({"packaged_yaml": out}), flush=True)
    # what phase 18(b) holds the same run on two ranks to, and phase 20(b)
    # runs at --hd_u 64
    return {**out, "val": val["out"], "ckpt_dir": ckpt_dir, "config": config_path}


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
    """(c) ``cli.main`` with ``script``'s flags and the packaged YAML with
    ``compute_dtype`` in place of its bf16, over phase 9's TextZoom, TF32 on
    first: one epoch of 22 iterations with a val and a save at its end,
    then ``--go_test`` from that checkpoint, whose metric dicts equal the
    val's (the same weights, PSNR and SSIM at 1e-4); K1's launches over both
    runs."""
    name = f"{script[len('train_'):-len('.sh')]}_{compute_dtype}"
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
    in fp32 (phases 12, 15(c) and 19(d) run the CLI on the packaged YAML's
    bf16).
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
        cli_out = zoo_cli(root, script, train_dirs, val_dirs, "fp32")
        iters = cli_out["iterations"]
        k1 = script == "train_TSRN.sh"
        want = (2 * N_SRB * (iters + 2 * n_val) if k1 else 0, 2 * N_SRB * iters if k1 else 0)
        got = (cli_out["k1_launches"], cli_out["k1_backward_launches"])
        check(got == want, f"{script} (fp32) through the CLI: K1 launched {got} times, expected {want}")
        print(json.dumps({"zoo_cli": cli_out}), flush=True)
    print(f"zoo: phase 13 took {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


# phase 15: the rest of the single-model zoo, each arch with its flags of
# ``profile_zoo.ARCH_FLAGS``; the SRBs of those that run K1 (each runs it
# once over W and once over H)
ZOO_REST_SRB = {"tsrn_tl_wmask": N_SRB, "tsrn_tl": N_SRB, "textzoom_net": 6}
REMAT_FLAGS = ["--arch", "tsrn_tl_cascade", "--STN", "--mask", "--use_distill", "--gradient", "--stu_iter=2"]
SRRESNET3_SCRIPT = "train_TPGSR-SRResNet.sh"  # --stu_iter=3 --sr_share


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
    config_path = f"{root}/{EVAL_CONFIG}"
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


# phase 14(c)'s zoo scripts, one a recognizer: plain archs (the flagship, a
# cascade, is scored by both in rec_cli)
REC_ZOO_SCRIPTS = (("train_SRCNN.sh", "ASTER"), ("train_TSRN.sh", "MORAN"))


def rec_zoo_cli(root: str, val_dirs):
    """(c) for the zoo: ``cli.main`` with a plain arch's script's flags and
    ``--test --rec aster``, and another's with ``--rec moran``
    (``REC_ZOO_SCRIPTS``; the cascade is the flagship's ``rec_cli``), from its
    fp32 checkpoint of phase 13(c), over the smallest val split: the images
    all read, finite metrics, fps."""
    split = val_dirs[int(np.argmin(VAL_PAIRS))]
    rows = []
    cwd = os.getcwd()
    os.chdir(root)
    try:
        for script, kind in REC_ZOO_SCRIPTS:
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


# phase 17: the data flags --syn, --mixed and --ic15sr, and --random_reso
RR_WORDS = 384
RR_HEIGHTS = (12, 48)  # native LR heights and widths of the synthetic words, inclusive
RR_WIDTHS = (24, 320)
RR_CHECK_IMAGES = 16  # the first words, also run on the CPU
RR_THRESHOLD = 0.85  # the cascade's confidence gate (train/random_reso.conf_threshold_of)
# card against CPU, a confidence of the gate's CRNN (its output layer scaled
# by 200, so a logit's noise by as much): 3.2e-6 apart at most on the first
# 16 words (an H100 80GB HBM3 at 700 W); held at 1e-4, and decisions are
# compared where the CPU's confidence lies further than that from the
# threshold
RR_CONF_ATOL = 1e-4
RR_FLAGS = TRAINER_FLAGS[:-2]
# the train flags' runs: 2 warm-up and ZOO_TRAIN_STEPS timed iterations at
# least; the IC15 tree's train split holds just that many batches
MODE_FLAGS = ("syn", "mixed", "ic15sr")
IC15_TRAIN = (TRAIN_WARMUP + ZOO_TRAIN_STEPS) * BATCH
IC15_TEST = 2 * BATCH


def sharpened_crnn(path: str) -> str:
    """A CRNN drawn from seed 7 with its convolutions scaled by 4 and its
    output layer by 200 (tests/test_torch_random_reso.py's), saved as a
    ``state_dict``: its confidences depend on the image and straddle the
    gate's threshold, where a draw at torch's default ranges reads every
    image alike (confidence 0.03)."""
    model = load_crnn("", torch.Generator().manual_seed(7))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.startswith("cnn") and p.dim() == 4:
                p.mul_(4.0)
            elif name.startswith("rnn.1.embedding"):
                p.mul_(200.0)
    torch.save(model.state_dict(), path)
    return path


def make_native_lmdb(path: str, words, sizes, seed: int) -> str:
    """A single-image LMDB (``lmdbDataset``'s ``image-%09d`` keys) of
    ``words`` rendered at ``sizes`` (width, height), JPEGs."""
    items = [(b"num-samples", str(len(words)).encode())]
    for i, (word, size) in enumerate(zip(words, sizes), 1):
        items += [(b"label-%09d" % i, word.encode()),
                  (b"image-%09d" % i, _jpeg(render_word(word, tuple(size), seed=seed * 100_000 + i)))]
    write_lmdb(path, items)
    return path


def modes_config(root: str, name: str, train_dirs, val_dirs, crnn_path: str = "", compute_dtype: str = "fp32",
                 iterations: int = 1) -> str:
    """The packaged YAML at batch 48, one epoch, a val and a save at
    ``iterations``, in ``compute_dtype``, the loaders in the calling process
    (a worker's start costs each run several seconds); written to ``root``
    and its path returned."""
    cfg = load_config()
    cfg.TRAIN.update(train_data_dir=list(train_dirs), batch_size=BATCH, epochs=1, saveInterval=iterations,
                     displayInterval=iterations, workers=0, ckpt_dir=f"{root}/ckpt_modes", compute_dtype=compute_dtype)
    cfg.TRAIN.VAL.update(val_data_dir=list(val_dirs), valInterval=iterations, crnn_pretrained=crnn_path)
    path = f"{root}/modes_{name}.yaml"
    with open(path, "w") as f:
        json.dump(cfg, f)  # JSON is YAML
    return path


def random_reso_run(argv):
    """``cli.main(argv)`` on the card under ``--random_reso --go_test``: its
    {split: metric_dict}, the val's seconds (the card synchronized) and K1's
    launches in it."""
    probe = TrainerProbe()
    gru_seq.LAUNCHES = gru_seq.BACKWARD_LAUNCHES = 0
    with probe.installed():
        md = cli.main(argv)
    (val,) = [e for e in probe.events if e["name"] == "val"]
    launches = [b - a for a, b in zip(val["counts0"], val["counts1"])]
    check(launches[1] == 0, f"--random_reso: K1's backward launched {launches[1]} times")
    return md, val["t1"] - val["t0"], launches[0]


def gate_confidences(argv, config_path: str, lr_list, dev: str):
    """The stage-0 student's confidence on each LR, through ``TextSR``'s own
    weights on ``dev`` (the draw from TRAIN.manualSeed, the teacher from
    ``crnn_pretrained``)."""
    mission = trainer.TextSR(load_config(config_path), AttrDict(vars(build_arg_parser().parse_args(argv))), device=dev)
    stu = mission.init_state().stu[0].eval()
    return random_reso.cal_conf(lr_list, lambda x: stu(parse_crnn_data(x).permute(0, 3, 1, 2)), device=dev)


def random_reso_phase(root: str, val_dirs):
    """Phase 17 (b) and (c): ``--random_reso --go_test`` through ``cli.main``
    with the flagship's flags, its gate's CRNN ``sharpened_crnn``.

    (b) ``--syn``: 384 words at native sizes (heights 12-48, widths 24-320),
    each image read at its own size on the card: the metric dict, images/s,
    ms an image, K1's launches (10 an image sent to SR, none for a kept LR);
    then the first 16 words (half relabelled with what the CPU's CRNN reads
    on their HR, so that an accuracy is not 0) on the card and on the CPU:
    the gate's confidences (``RR_CONF_ATOL``), its decisions where they
    clear it, and the metric dicts (``check_metric_dicts``).  (c) TextZoom's
    easy split, fixed-shape batches gated image by image, on the card
    (images/s, K1's launches), and its first 16 pairs card against CPU (the
    whole split on the CPU would take minutes: every image runs alone)."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(17)
    words = random_words(rng, RR_WORDS)
    sizes = [(int(rng.integers(RR_WIDTHS[0], RR_WIDTHS[1] + 1)), int(rng.integers(RR_HEIGHTS[0], RR_HEIGHTS[1] + 1)))
             for _ in range(RR_WORDS)]
    crnn_path = sharpened_crnn(f"{root}/crnn_sharp.pth")
    first = make_native_lmdb(f"{root}/rr_first", words[:RR_CHECK_IMAGES], sizes[:RR_CHECK_IMAGES], seed=17)
    items = [SingleImageLMDB(first, "all")[i] for i in range(RR_CHECK_IMAGES)]
    batch = collate_syn_random_reso(items, CollateConfig(mask=True))
    teacher = load_crnn(crnn_path, torch.Generator()).eval()
    with torch.no_grad():
        reads = [decode_crnn(teacher(parse_crnn_data(torch.from_numpy(hr)).permute(0, 3, 1, 2)))[0]
                 for hr in batch["hr_list"]]
    words[:RR_CHECK_IMAGES] = [r if i % 2 == 0 and r else w for i, (r, w) in enumerate(zip(reads, words))]
    first = make_native_lmdb(f"{root}/rr_first", words[:RR_CHECK_IMAGES], sizes[:RR_CHECK_IMAGES], seed=17)
    every = make_native_lmdb(f"{root}/rr_all", words, sizes, seed=17)
    # the easy split's first pairs: phase 9 writes it from seed 10
    easy_first = make_textzoom_lmdb(f"{root}/rr_easy_first", RR_CHECK_IMAGES, seed=10)
    check([TextZoomDataset(easy_first)[i][2] for i in range(RR_CHECK_IMAGES)]
          == [TextZoomDataset(val_dirs[0])[i][2] for i in range(RR_CHECK_IMAGES)], "the easy split's first words")
    cfgs = {name: modes_config(root, f"rr_{name}", [d], [d], crnn_path)
            for name, d in (("all", every), ("first", first), ("easy", val_dirs[0]), ("easy_first", easy_first))}
    out = {"words": RR_WORDS, "heights": RR_HEIGHTS, "widths": RR_WIDTHS}
    cwd = os.getcwd()
    os.chdir(root)
    try:
        syn = RR_FLAGS + ["--syn", "--random_reso", "--go_test", "--vis_dir", "rr_syn"]
        md, val_s, launches = random_reso_run(syn + ["--config", cfgs["all"]])
        (m,) = md.values()
        check(m["images"] == RR_WORDS and m["go_LR"] + m["go_SR"] == RR_WORDS and m["go_SR"] > 0,
              f"--syn --random_reso: {m}")
        check(np.isfinite(m["psnr_avg"]) and np.isfinite(m["ssim_avg"]), f"--syn --random_reso: {m}")
        check(launches == 2 * N_SRB * m["go_SR"], f"--syn --random_reso: K1 launched {launches} times for "
              f"{m['go_SR']} images sent to SR")
        check(not torch.backends.cudnn.benchmark, "--random_reso turned cuDNN's autotuner on")
        out["syn"] = {"metrics": m, "val_s": val_s, "images_per_s": RR_WORDS / val_s,
                      "ms_per_image": 1e3 * val_s / RR_WORDS, "k1_launches": launches,
                      "k1_launches_per_image": launches / RR_WORDS, "host": host_load()}
        print(json.dumps({"random_reso_syn": out["syn"]}), flush=True)

        first_md = {dev: cli.main(syn + ["--config", cfgs["first"]], device=dev) for dev in ("cuda", "cpu")}
        (name,) = first_md["cpu"]
        check_metric_dicts(first_md["cuda"][name], first_md["cpu"][name], "--syn --random_reso, first words")
        lrs = collate_syn_random_reso(items, CollateConfig(mask=True))["lr_list"]
        confs = {dev: gate_confidences(syn + ["--config", cfgs["first"]], cfgs["first"], lrs, dev)
                 for dev in ("cuda", "cpu")}
        conf_err = max(abs(a - b) for a, b in zip(confs["cuda"], confs["cpu"]))
        check(conf_err <= RR_CONF_ATOL, f"gate confidences card against CPU: {conf_err:.3g}")
        near = [i for i, c in enumerate(confs["cpu"]) if abs(c - RR_THRESHOLD) <= RR_CONF_ATOL]
        decide = {dev: [c > RR_THRESHOLD and h > random_reso.MIN_HEIGHT for c, (w, h) in zip(confs[dev], sizes)]
                  for dev in confs}
        check(all(decide["cuda"][i] == decide["cpu"][i] for i in range(RR_CHECK_IMAGES) if i not in near),
              f"gate decisions card {decide['cuda']} against CPU {decide['cpu']}")
        out["first"] = {"metrics": first_md["cuda"][name], "cpu_metrics": first_md["cpu"][name],
                        "confidence_max_abs_err": conf_err, "near_threshold": near,
                        "kept_lr": sum(decide["cuda"])}
        print(json.dumps({"random_reso_first": out["first"]}), flush=True)

        easy = RR_FLAGS + ["--random_reso", "--go_test", "--vis_dir", "rr_easy"]
        md, val_s, launches = random_reso_run(easy + ["--config", cfgs["easy"]])
        (name,) = md
        check(md[name]["images"] == VAL_PAIRS[0] and launches == 2 * N_SRB * md[name]["go_SR"],
              f"--random_reso over the easy split: {md[name]}, K1 launched {launches} times")
        first_md = {dev: cli.main(easy + ["--config", cfgs["easy_first"]], device=dev) for dev in ("cuda", "cpu")}
        (first_name,) = first_md["cpu"]
        check_metric_dicts(first_md["cuda"][first_name], first_md["cpu"][first_name],
                           "--random_reso over the easy split's first pairs")
        out["easy"] = {"metrics": md[name], "val_s": val_s, "images_per_s": VAL_PAIRS[0] / val_s,
                       "k1_launches": launches, "first_metrics": first_md["cuda"][first_name]}
        print(json.dumps({"random_reso_easy": out["easy"]}), flush=True)
    finally:
        os.chdir(cwd)
    out["s"] = time.perf_counter() - t0
    return out


def make_ic15_tree(root: str, seed: int = 15) -> str:
    """An IC15 TextSR tree at TextZoom's geometry: PGM pairs (HR 128x32, LR
    its bicubic 64x16) of ``IC15_TRAIN`` train and ``IC15_TEST`` test words,
    listed in ``<split>_GT.txt``."""
    rng = np.random.default_rng(seed)
    for split, n in (("train", IC15_TRAIN), ("test", IC15_TEST)):
        for d in ("HRx2", "LRx2"):
            os.makedirs(f"{root}/{d}/{split}", exist_ok=True)
        lines = []
        for i, word in enumerate(random_words(rng, n)):
            hr = render_word(word, (128, 32), seed=seed * 100_000 + i + (split == "test") * 50_000).convert("L")
            hr.save(f"{root}/HRx2/{split}/{split}_{i}.pgm")
            hr.resize((64, 16), Image.BICUBIC).save(f"{root}/LRx2/{split}/{split}_{i}.pgm")
            lines.append(f'{split}_{i}, "{word}"')
        with open(f"{root}/{split}_GT.txt", "w") as f:
            f.write("\n".join(lines) + "\n")
    return root


def mode_train(root: str, flag: str, train_dirs, val_dir: str, compute_dtype: str):
    """(d) ``cli.main`` with the flagship's flags and ``--<flag>`` in
    ``compute_dtype`` (the packaged YAML's bf16, or fp32): one epoch at
    batch 48 with a val over ``val_dir`` and a save at its end; images/s over
    ``ZOO_TRAIN_STEPS`` iterations after ``TRAIN_WARMUP`` (the card
    synchronized at both ends), K1's launches, finite losses and the saved
    files; for ``--syn`` in fp32 the first two iterations against a CPU
    ``TextSR`` (phase 10's bounds)."""
    if flag == "ic15sr":
        iterations, n_val = IC15_TRAIN // BATCH, IC15_TEST
    else:
        iterations = len(ConcatDataset([TextZoomDataset(d) for d in train_dirs])) // BATCH
        n_val = len(TextZoomDataset(val_dir))
    name = f"{flag}_{compute_dtype}"
    config_path = modes_config(root, name, train_dirs, [val_dir], compute_dtype=compute_dtype, iterations=iterations)
    argv = RR_FLAGS + [f"--{flag}", "--vis_dir", f"mode_{name}", "--config", config_path]
    probe = TrainerProbe(marks=(TRAIN_WARMUP, TRAIN_WARMUP + ZOO_TRAIN_STEPS))
    gru_seq.LAUNCHES = gru_seq.BACKWARD_LAUNCHES = 0
    load = host_load()
    start = time.perf_counter()
    with probe.installed():
        state = cli.main(argv)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - start
    launches = (gru_seq.LAUNCHES, gru_seq.BACKWARD_LAUNCHES)
    want = (2 * N_SRB * (iterations + -(-n_val // BATCH)), 2 * N_SRB * iterations)
    check(state.step == iterations and probe.compute_dtypes == [compute_dtype], f"{name}: step {state.step}, "
          f"compute dtypes {probe.compute_dtypes}")
    check(launches == want, f"{name}: K1 launched {launches} times, expected {want}")
    (val,) = [e for e in probe.events if e["name"] == "val"]
    (md,) = val["out"].values()
    check(md["images"] == n_val and np.isfinite(md["psnr_avg"]), f"{name}: val {md}")
    files = set(os.listdir(f"{root}/ckpt_modes/mode_{name}"))
    check(set(SAVE_FILES) <= files, f"{name}: checkpoint files {sorted(files)}")
    card = [{k: float(v) for k, v in m.items()} for m in probe.metrics]
    check(all(np.isfinite(v) for m in card for v in m.values()), f"{name}: non-finite losses {card}")
    window_s = probe.mark_times[TRAIN_WARMUP + ZOO_TRAIN_STEPS] - probe.mark_times[TRAIN_WARMUP]
    out = {"flag": flag, "compute_dtype": compute_dtype, "iterations": iterations, "run_s": run_s,
           "images_per_s": BATCH * ZOO_TRAIN_STEPS / window_s, "window_s": window_s, "val": md,
           "val_s": val["t1"] - val["t0"], "card_losses": card, "k1_launches": launches, "host": load,
           "host_after": host_load()}
    del state
    if flag == "syn" and compute_dtype == "fp32":
        cpu_cfg = load_config(config_path)
        cpu_cfg.TRAIN.workers = 0
        cpu = trainer.TextSR(cpu_cfg, AttrDict(vars(build_arg_parser().parse_args(argv))), device="cpu")
        cpu_state = cpu.init_state()
        cpu._build_steps()
        loader = cpu.get_train_data()
        loader.batch_sampler.epoch = 0
        batches = iter(loader)
        cpu_losses = [{k: float(v) for k, v in cpu._train_step(cpu_state, next(batches)).items()} for _ in range(2)]
        for i, rtol in enumerate((1e-5, 1e-4)):
            for k, v in cpu_losses[i].items():
                check(abs(card[i][k] - v) <= rtol * abs(v),
                      f"--syn iteration {i + 1} {k}: card {card[i][k]} vs CPU {v} (rtol {rtol})")
        out["cpu_losses"] = cpu_losses
    print(json.dumps({"mode_train": out}), flush=True)
    return out


def phase_modes(root: str, train_dirs, val_dirs):
    """Phase 17: the flags that choose the data, at the flagship's full width
    on the card.  (a) is phase 3's native K1 cases; (b), (c)
    ``random_reso_phase``; (d) ``--syn`` and ``--mixed`` over phase 9's train
    LMDBs (val over its smallest split) and ``--ic15sr`` over a PGM tree,
    each in fp32 and on the packaged YAML (bf16), ``mode_train``.  Returns
    K1's forward launches in (b), and each flag's (forward, backward) in fp32
    and bf16."""
    t0 = time.perf_counter()
    out = {"random_reso": random_reso_phase(root, val_dirs)}
    ic15 = make_ic15_tree(f"{root}/ic15")
    smallest = val_dirs[int(np.argmin(VAL_PAIRS))]
    cwd = os.getcwd()
    os.chdir(root)
    try:
        for flag in MODE_FLAGS:
            train, val = ([ic15], ic15) if flag == "ic15sr" else (train_dirs, smallest)
            for dtype in ("fp32", "bf16"):
                out[(flag, dtype)] = mode_train(root, flag, train, val, dtype)
    finally:
        os.chdir(cwd)
    print(f"modes: phase 17 took {time.perf_counter() - t0:.1f} s", flush=True)
    launches = {"random_reso": out["random_reso"]["syn"]["k1_launches"]}
    launches.update({k: v["k1_launches"] for k, v in out.items() if isinstance(k, tuple)})
    return launches


# phase 18: data parallelism on the card.  Two ranks share the one card
# through gloo (the one-card mode; NCCL takes one card a rank), then one
# NCCL rank alone
DDP_WORLD = 2
DDP_VAL_SIZES = (BATCH, BATCH, BATCH, 29)  # 4 val batches, the last short (and odd: the ranks pad it)
DDP_STEPS = 22  # (a)'s fp32 run: as many steps as phase 12's run has iterations
DDP_TIMED_STEPS = 5  # its last steps, timed
DDP_TIMEOUT_S = 600
DDP_MOMENT_TOL = {"sr": 5e-3, "stu": 3e-2}  # phase 7's gradient bounds: Adam's first moment is 0.5 g
# Over many steps two ranks may drift from one process at most this many
# times as far as one process drifts from itself from the same weights and
# batches.  From random weights the first updates carry a rounding apart
# (Adam's first step is lr times the gradient's sign), and one process
# never repeats itself bit for bit: the STN's grid_sample backward adds
# with atomics.  Measured on the H100 after 22 steps, relative to the
# run's own change: one process from itself 0.70 (fp32, (a)) and 0.58
# (bf16, phase 12's command), two ranks from one process 0.67 and 0.71.
DDP_DRIFT_FACTOR = 2.0
# One process reruns the same command this many times, and the median of
# their distances from its first run is the drift's yardstick: one rerun is
# one sample of a chaotic distance, which fell to 0.40 of its usual size
# once (a ratio of 2.47 against 0.95-1.45 in eight other runs; PERF.md)
DDP_RERUNS = 3


def _ddp_counts(*counts):
    """Every rank's ``counts`` (ints), gathered over the group's CPU
    transport: [rank][i]."""
    mine = torch.tensor(counts, dtype=torch.int64)
    parts = [torch.empty_like(mine) for _ in range(parallel.rank_and_world()[1])]
    torch.distributed.all_gather(parts, mine)
    return [p.tolist() for p in parts]


def _snapshot(state):
    """A copy of a train state's models and Adam's moments on the host."""
    models = {"sr": state.sr[0], "stu": state.stu[0]}
    return {"sd": {kind: {k: v.detach().cpu().clone() for k, v in m.state_dict().items()}
                   for kind, m in models.items()},
            "moments": {f"{kind}.{name}": [state.optimizer.state[p][k].detach().cpu().clone()
                                           for k in ("exp_avg", "exp_avg_sq")]
                        for kind, m in models.items() for name, p in m.named_parameters()}}


def _flat_params(tensors):
    """Parameters as one fp32 vector on the host."""
    return torch.cat([t.detach().float().reshape(-1).cpu() for t in tensors])


def _state_params(state):
    return _flat_params(p for m in (state.sr[0], state.stu[0]) for p in m.parameters())


def _sd_params(sds):
    """The entries of state_dicts but the BatchNorm statistics, as one
    vector: the parameters and the constant buffers."""
    return _flat_params(v for sd in sds for k, v in sd.items()
                        if not ("running" in k or k.endswith("num_batches_tracked")))


def _saved_params(ckpt_dir: str):
    """``_sd_params`` of a save's SR model and student."""
    sds = [torch.load(f"{ckpt_dir}/{name}", map_location="cpu", weights_only=True)
           for name in ("checkpoint_0.pth", "recognizer_0.pth")]
    return _sd_params(sd.get("state_dict_G", sd) for sd in sds)


def _psnr_ssim(md):
    return {k: md[k] for k in ("psnr_avg", "ssim_avg")}


def _rank_rows(batch):
    rank, world = parallel.rank_and_world()
    return {k: parallel.local_rows(v, rank, world) for k, v in batch.items()}


def ddp_fp32_run(batch, trajectory, val_batches, device):
    """The flagship's fp32 run of phase 18(a) from seed 0, on this rank's
    rows (a process alone: every row): one step on ``batch`` (K1 counted,
    then the state's snapshot), a step on each of ``trajectory`` (the last
    DDP_TIMED_STEPS timed, the ranks at a barrier around them), then
    ``evaluate`` of the trained models over ``val_batches``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state, step = entry.flagship_train(device=device, seed=0)
    parallel.replicate([*state.sr, *state.stu], [state.teacher], state.optimizer)
    gru_seq.LAUNCHES = gru_seq.BACKWARD_LAUNCHES = 0
    metrics = {k: float(v) for k, v in step(state, _rank_rows(batch)).items()}
    torch.cuda.synchronize()
    out = {"metrics": metrics, "step_counts": (gru_seq.LAUNCHES, gru_seq.BACKWARD_LAUNCHES), **_snapshot(state)}
    losses = []
    for i, b in enumerate(trajectory):
        if i == len(trajectory) - DDP_TIMED_STEPS:
            torch.cuda.synchronize()
            parallel.barrier()
            t0 = time.perf_counter()
        losses.append(step(state, _rank_rows(b))["loss_total"].detach())
    torch.cuda.synchronize()
    parallel.barrier()
    out["timed_s"] = time.perf_counter() - t0
    out["losses"] = [metrics["loss_total"], *(float(v) for v in losses)]
    out["params"] = _state_params(state)
    models = EvalModels(sr=state.sr, stu=state.stu, teacher=state.teacher)
    out["trained_eval"] = evaluate(make_eval_step(entry.FLAGSHIP_ARGS, entry.TRAIN_WIDTH, device=device), models,
                                   val_batches)
    return out


def ddp_bf16_moments(batch, device):
    """Adam's moments after one bf16 flagship step from seed 0 on this
    rank's rows of ``batch``."""
    state, step = entry.flagship_train(device=device, seed=0, compute_dtype="bf16")
    parallel.replicate([*state.sr, *state.stu], [state.teacher], state.optimizer)
    step(state, _rank_rows(batch))
    return _snapshot(state)["moments"]


def ddp_step_rank(batch, trajectory, val_batches, device=None):
    """Phase 18(a) on one rank: the fp32 run (``ddp_fp32_run``), ``evaluate``
    of the seeded models over ``val_batches`` (K1 counted), one bf16 step."""
    run = ddp_fp32_run(batch, trajectory, val_batches, device)
    models, eval_step = entry.flagship(device=device, seed=0)
    gru_seq.LAUNCHES = 0
    md = evaluate(eval_step, models, val_batches)
    eval_launches = gru_seq.LAUNCHES
    del models
    return {**run, "eval": md, "bf16_moments": ddp_bf16_moments(batch, device),
            "counts": _ddp_counts(*run["step_counts"], eval_launches)}


def ddp_cli_rank(argv, root: str, device=None):
    """Phase 18(b) on one rank: ``cli.run_rank(argv)`` (``TextSR`` with
    TRAIN.n_devices 2) in ``<root>/rank<r>``, a ``TrainerProbe`` installed;
    rank 0's state, first losses and vals, every rank's K1 counts before the
    val and after it, and the files each rank wrote."""
    rank = parallel.rank_and_world()[0]
    work = f"{root}/rank{rank}"
    os.makedirs(work, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(work)
    try:
        probe = TrainerProbe()
        gru_seq.LAUNCHES = gru_seq.BACKWARD_LAUNCHES = 0
        t0 = time.perf_counter()
        with probe.installed():
            state = cli.run_rank(argv, device=device)
        run_s = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    (val,) = [e for e in probe.events if e["name"] == "val"]
    files = sorted(os.path.relpath(os.path.join(d, f), work) for d, _, fs in os.walk(work) for f in fs)
    return {"state": state, "first_losses": {k: float(v) for k, v in probe.metrics[0].items()}, "vals": val["out"],
            "compute_dtypes": probe.compute_dtypes, "run_s": run_s,
            "window_s": val["t0"] - probe.first_step_end, "first_iteration_s": probe.first_step_end - t0,
            "counts": _ddp_counts(*val["counts0"], *val["counts1"], len(files)), "files": files}


def ddp_rank(batch, trajectory, val_batches, argv, root: str, device=None):
    """Phase 18 (a) and (b) on one rank of one group."""
    return {"step": ddp_step_rank(batch, trajectory, val_batches, device=device),
            "cli": ddp_cli_rank(argv, root, device=device)}


def check_ddp_step(got, want):
    """Phase 18(a)'s first fp32 step on two ranks against one process, at
    phase 7's bounds: the losses at rtol 1e-5; per model, Adam's first
    moment (relative L2 over every parameter but the pre-BN biases) at phase
    7's gradient bound, its second at twice that; every parameter within 2.5
    lr (Adam's reach after one step); the BatchNorm statistics at rtol
    1e-4, atol 1e-5."""
    errs = {}
    for k, v in want["metrics"].items():
        check(np.isfinite(got["metrics"][k]) and abs(got["metrics"][k] - v) <= 1e-5 * abs(v),
              f"ddp train {k}: two ranks {got['metrics'][k]} vs one process {v}")
    for kind, tol in DDP_MOMENT_TOL.items():
        keys = [k for k in want["moments"] if k.startswith(kind + ".") and not PRE_BN_BIAS.search(k.split(".", 1)[1])]
        for j, bound in ((0, tol), (1, 2 * tol)):
            err = grad_rel({k: got["moments"][k][j] for k in keys}, {k: want["moments"][k][j] for k in keys}, keys)
            check(err <= bound, f"ddp train {kind}: Adam moment {j + 1} rel err {err:.3g} > {bound}")
            errs[f"{kind}_moment{j + 1}"] = err
        sd, ref = got["sd"][kind], want["sd"][kind]
        check(list(sd) == list(ref), f"ddp train {kind}: state_dict keys")
        for k in ref:
            if "running" in k:
                check(torch.allclose(sd[k], ref[k], rtol=1e-4, atol=1e-5), f"ddp train {kind}.{k}: BN statistic")
            elif not k.endswith("num_batches_tracked"):
                reach = float((sd[k] - ref[k]).abs().max())
                check(reach <= 2.5 * TRAIN_LR, f"ddp train {kind}.{k}: {reach:.3g} from the one-process step")
    return errs


def check_ddp_bf16(two, one, fp32):
    """Phase 18(a)'s bf16 step on two ranks against one process, at phase
    11's bounds (the card's bf16 step against the CPU's): per model, the
    pre-BN biases apart, Adam's first moment (a multiple of the clipped
    gradient) of two ranks lies at most 2 E + 1e-2 (relative L2) from one
    process's bf16, where E is one process's bf16 from its fp32, with a
    cosine to fp32 at least half of one process's bf16."""
    out = {}
    for kind in ("sr", "stu"):
        keys = [k for k in fp32 if k.startswith(kind + ".") and not PRE_BN_BIAS.search(k.split(".", 1)[1])]
        g2, g1, g32 = ({k: m[k][0] for k in keys} for m in (two, one, fp32))
        e_two, e_one = grad_rel(g2, g1, keys), grad_rel(g1, g32, keys)
        cos_two, cos_one = grad_cos(g2, g32, keys), grad_cos(g1, g32, keys)
        check(e_two <= 2 * e_one + 1e-2, f"ddp bf16 {kind}: two ranks' first moment {e_two:.3g} from one process's, "
              f"whose bf16 lies {e_one:.3g} from its fp32")
        check(cos_two >= cos_one / 2, f"ddp bf16 {kind}: cosine {cos_two:.3g} to fp32, one process's {cos_one:.3g}")
        out[kind] = {"rel_err_vs_one_process": e_two, "one_process_rel_err_vs_fp32": e_one, "cos_vs_fp32": cos_two,
                     "one_process_cos_vs_fp32": cos_one}
    return out


def check_drift(two, agains, ref, base, what: str):
    """``two`` (parameters) no farther from ``ref`` than DDP_DRIFT_FACTOR
    times the median distance of ``agains``, ``ref``'s command run again
    DDP_RERUNS times in one process; every distance also relative to
    ``ref``'s change from ``base``, and the ratio of two ranks' distance to
    the median."""
    check(len(agains) >= 3, f"{what}: {len(agains)} reruns, the median needs at least 3")
    d_two = float((two - ref).norm())
    d_agains = [float((again - ref).norm()) for again in agains]
    d_again = statistics.median(d_agains)
    check(bool(torch.isfinite(two).all()), f"{what}: a parameter is not finite")
    check(d_two <= DDP_DRIFT_FACTOR * d_again, f"{what}: two ranks {d_two:.4g} from one process, whose reruns lie "
          f"{[round(d, 4) for d in d_agains]} from it, median {d_again:.4g} (factor {DDP_DRIFT_FACTOR})")
    change = float((ref - base).norm())
    return {"two_ranks": d_two / change, "one_process_again": d_again / change,
            "one_process_reruns": [d / change for d in d_agains], "ratio": d_two / d_again,
            "rerun_ratios": [d_two / d for d in d_agains]}


def ddp_config(root: str, train_dirs, val_dirs, n_devices: int) -> str:
    """Phase 12's config (the packaged YAML, bf16, batch 48, one epoch of
    phase 9's TextZoom with a val and a save at its end) with
    TRAIN.n_devices ``n_devices``, the loaders in each rank's process and
    the checkpoints under the working directory."""
    cfg = load_config()
    iterations = TRAIN_PAIRS // BATCH
    cfg.TRAIN.update(train_data_dir=list(train_dirs), batch_size=BATCH, epochs=1, saveInterval=iterations,
                     displayInterval=iterations // 2, workers=0, ckpt_dir="ckpt", n_devices=n_devices)
    cfg.TRAIN.VAL.update(val_data_dir=list(val_dirs), valInterval=iterations)
    path = f"{root}/ddp{n_devices}.yaml"
    with open(path, "w") as f:
        json.dump(cfg, f)  # JSON is YAML
    return path


def ddp_nccl(root: str):
    """(c) One rank over NCCL on the card (``init_process_group("nccl")``,
    world 1): three flagship fp32 steps and an all-reduce."""
    parallel.init(0, 1, f"file://{root}/nccl_store", torch.device("cuda", 0))
    try:
        check(torch.distributed.get_backend() == "nccl", f"backend {torch.distributed.get_backend()}")
        rng = np.random.default_rng(183)
        state, step = entry.flagship_train(device="cuda", seed=0)
        losses = [float(step(state, synthetic_batch(rng, BATCH, labels=False))["loss_total"]) for _ in range(3)]
        check(all(np.isfinite(v) for v in losses), f"NCCL rank: losses {losses}")
        t = torch.arange(4, dtype=torch.float32, device="cuda")
        torch.distributed.all_reduce(t)
        torch.cuda.synchronize()
        check(torch.equal(t.cpu(), torch.arange(4, dtype=torch.float32)), f"NCCL all_reduce gave {t}")
        parallel.barrier()
    finally:
        parallel.shutdown()
    return {"backend": "nccl", "world": 1, "losses": losses}


def _in_dir(path: str, fn, *args):
    """``fn(*args)`` with ``path`` (made) as the working directory."""
    os.makedirs(path, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(path)
    try:
        return fn(*args)
    finally:
        os.chdir(cwd)


def phase_ddp(root: str, train_dirs, val_dirs, packaged, smi: str):
    """Phase 18: data parallelism on the card.

    (a) Two gloo ranks on the one card (24 rows each) and one process run
    the flagship's fp32 step at global batch 48 from seed 0 for DDP_STEPS
    steps over the same batches, the last DDP_TIMED_STEPS timed; one
    process runs them twice.  The first step is held at phase 7's bounds,
    with K1's launches a rank (10 + 10); after the last, two ranks lie no
    farther from one process than DDP_DRIFT_FACTOR times one process from
    itself; ``evaluate`` of the seeded models over 4 val batches (the last
    of 29 rows) gives the one-process metric dict; one bf16 step on two
    ranks is held to one process's at phase 11's bounds.

    (b) In the same group ``TextSR`` with TRAIN.n_devices 2 through the
    CLI's per-rank function (``cli.run_rank``): phase 12's run
    (``packaged``: the packaged YAML, bf16, 22 iterations over phase 9's
    TextZoom, a val and a save) on two ranks.  Rank 0 alone writes; the
    checkpoint's keys are phase 12's; the first losses at phase 11's bf16
    bounds of phase 12's; the val's metric dicts those of a one-process
    ``--go_test`` on rank 0's saved weights (phase 4's rtol 1e-4); the
    saved parameters no farther from phase 12's than DDP_DRIFT_FACTOR times
    the same command run again in one process.

    (c) One NCCL rank.  Returns K1's launches for the kernels line."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(18)
    batch = synthetic_batch(rng, BATCH, labels=False)
    val_batches = [synthetic_batch(rng, n) for n in DDP_VAL_SIZES]
    trajectory = [synthetic_batch(rng, BATCH, labels=False) for _ in range(DDP_STEPS - 1)]
    config_path = ddp_config(root, train_dirs, val_dirs, DDP_WORLD)
    argv = TRAINER_FLAGS[:-1] + ["ddp", "--config", config_path]
    s0 = time.perf_counter()
    got = parallel.spawn(DDP_WORLD, ddp_rank, batch, trajectory, val_batches, argv, f"{root}/ddp", device="cuda:0",
                         backend="gloo", timeout=DDP_TIMEOUT_S)
    group_s = time.perf_counter() - s0

    # (a) against one process on the card, run 1 + DDP_RERUNS times
    one = ddp_fp32_run(batch, trajectory, val_batches, "cuda")
    agains = [ddp_fp32_run(batch, trajectory, val_batches, "cuda") for _ in range(DDP_RERUNS)]
    models, eval_step = entry.flagship(device="cuda", seed=0)
    want_md = evaluate(eval_step, models, val_batches)
    del models
    base = _state_params(entry.flagship_train(device="cpu", seed=0)[0])
    one_bf16 = ddp_bf16_moments(batch, "cuda")
    a = got["step"]
    errs = check_ddp_step(a, one)
    bf16_errs = check_ddp_bf16(a["bf16_moments"], one_bf16, one["moments"])
    check(all(np.isfinite(v) for v in a["losses"]), f"ddp train: losses {a['losses']}")
    drift = check_drift(a["params"], [again["params"] for again in agains], one["params"], base,
                        f"ddp train after {DDP_STEPS} steps")
    check_metric_dicts(a["eval"], want_md, "ddp evaluate over two ranks")
    check(a["eval"]["images"] == sum(DDP_VAL_SIZES), f"ddp evaluate read {a['eval']['images']} images")
    n_val = len(DDP_VAL_SIZES)
    for r, (fwd, bwd, ev) in enumerate(a["counts"]):
        check((fwd, bwd, ev) == (2 * N_SRB, 2 * N_SRB, 2 * N_SRB * n_val),
              f"ddp rank {r}: K1 launched {fwd} + {bwd} in the step and {ev} in evaluate, expected "
              f"{2 * N_SRB} + {2 * N_SRB} and {2 * N_SRB * n_val}")

    # (b) against phase 12's one-process run of the same command, and that
    # command run again in one process
    b = got["cli"]
    iterations = packaged["iterations"]
    rank0 = f"{root}/ddp/rank0"
    check(b["compute_dtypes"] == ["bf16"], f"ddp TextSR stepped in {b['compute_dtypes']}")
    check(b["state"].step == iterations, f"ddp TextSR at step {b['state'].step}, expected {iterations}")
    n_val_batches = sum(-(-n // BATCH) for n in VAL_PAIRS)
    for r, (f0, b0, f1, b1, n_files) in enumerate(b["counts"]):
        want_counts = (2 * N_SRB * iterations, 2 * N_SRB * iterations, 2 * N_SRB * n_val_batches)
        check((f0, b0, f1 - f0) == want_counts, f"ddp TextSR rank {r}: K1 {f0} + {b0} in training and {f1 - f0} in "
              f"the val, expected {want_counts}")
        check((n_files == 0) == (r != 0), f"ddp TextSR rank {r} wrote {n_files} files")
    saved = sorted(f for f in b["files"] if f.startswith("ckpt/"))
    check(saved == sorted(f"ckpt/ddp/{name}" for name in SAVE_FILES), f"ddp TextSR rank 0 saved {saved}")
    check(any(f.startswith("tensorboard/ddp/") for f in b["files"]), "ddp TextSR rank 0 wrote no scalar log")
    for name, model in (("checkpoint_0.pth", b["state"].sr[0]), ("recognizer_0.pth", b["state"].stu[0])):
        sd2, sd1 = (torch.load(f"{d}/{name}", map_location="cpu", weights_only=True)
                    for d in (f"{rank0}/ckpt/ddp", packaged["ckpt_dir"]))
        sd2, sd1 = (d.get("state_dict_G", d) for d in (sd2, sd1))
        check(list(sd2) == list(sd1), f"ddp TextSR {name}: keys differ from phase 12's")
        mine = model.state_dict()
        for k in sd1:
            check(torch.equal(sd2[k], mine[k]), f"ddp TextSR {name}.{k}: the file is not rank 0's state")
    for k, v in packaged["card_losses"].items():
        check(abs(b["first_losses"][k] - v) <= BF16_LOSS_RTOL[k] * abs(v),
              f"ddp TextSR iteration 1 {k}: two ranks {b['first_losses'][k]} vs phase 12's {v}")
    one_path = ddp_config(root, train_dirs, val_dirs, 1)
    again_vals = []

    def run_again():
        probe = TrainerProbe()
        with probe.installed():
            state = cli.main(TRAINER_FLAGS[:-1] + ["ddp_again", "--config", one_path])
        check(state.step == iterations, f"phase 12's command again: step {state.step}")
        (val,) = [e["out"] for e in probe.events if e["name"] == "val"]
        again_vals.append(val)

    for k in range(DDP_RERUNS):
        _in_dir(f"{root}/ddp_one{k}", run_again)
    first = trainer.TextSR(load_config(one_path), AttrDict(vars(build_arg_parser().parse_args(argv))),
                           device="cpu").init_state()
    cli_drift = check_drift(_saved_params(f"{rank0}/ckpt/ddp"),
                            [_saved_params(f"{root}/ddp_one{k}/ckpt/ddp_again") for k in range(DDP_RERUNS)],
                            _saved_params(packaged["ckpt_dir"]),
                            _sd_params(m.state_dict() for m in (first.sr[0], first.stu[0])),
                            f"ddp TextSR after {iterations} iterations")
    del first
    go = _in_dir(f"{root}/ddp_one0", cli.main, TRAINER_FLAGS[:-1] + ["ddp_go", "--config", one_path, "--go_test",
                                                                      "--resume", f"{rank0}/ckpt/ddp"])
    check(list(b["vals"]) == list(go) == list(packaged["val"]), f"ddp TextSR val splits {list(b['vals'])}")
    for split in go:
        check_metric_dicts(b["vals"][split], go[split], f"ddp TextSR val {split} against one process's --go_test")

    # (c) NCCL
    nccl = ddp_nccl(root)
    out = {"card": smi, "batch": BATCH, "world": DDP_WORLD, "mode": "two gloo ranks on one card",
           "one_process_images_per_s": BATCH * DDP_TIMED_STEPS / one["timed_s"],
           "two_ranks_one_card_images_per_s": BATCH * DDP_TIMED_STEPS / a["timed_s"],
           "note": "two ranks sharing one card: the collectives' and the card's sharing cost, not a scaling figure",
           "step_k1_launches_per_rank": [c[:2] for c in a["counts"]],
           "eval_k1_launches_per_rank": [c[2] for c in a["counts"]], "step_errs": errs, "bf16_step": bf16_errs,
           "fp32_drift": {"steps": DDP_STEPS, "param_rel_to_change": drift,
                          "loss_rel_two_ranks": [abs(x - y) / abs(y) for x, y in zip(a["losses"], one["losses"])],
                          "loss_rel_again": [[abs(x - y) / abs(y) for x, y in zip(again["losses"], one["losses"])]
                                             for again in agains],
                          "val": {"one_process": _psnr_ssim(one["trained_eval"]),
                                  "again": [_psnr_ssim(again["trained_eval"]) for again in agains],
                                  "two_ranks": _psnr_ssim(a["trained_eval"])}},
           "cli_k1_launches_per_rank": [{"train": c[:2], "val": c[2] - c[0]} for c in b["counts"]],
           "cli_run_s": b["run_s"], "cli_window_s": b["window_s"], "cli_iterations": iterations,
           "cli_images_per_s": BATCH * (iterations - 1) / b["window_s"],
           "one_process_cli_images_per_s": packaged["images_per_s"],
           "cli_bf16_drift": {"param_rel_to_change": cli_drift,
                              "val": {s: {"phase_12": _psnr_ssim(packaged["val"][s]),
                                          "again": [_psnr_ssim(v[s]) for v in again_vals],
                                          "two_ranks": _psnr_ssim(b["vals"][s])} for s in go}},
           "nccl": nccl, "group_s": group_s, "s": time.perf_counter() - t0}
    print(json.dumps({"ddp": out}), flush=True)
    return {"fp32": [c[0] for c in a["counts"]], "fp32_backward": [c[1] for c in a["counts"]],
            "bf16": [c[0] for c in b["counts"]], "bf16_backward": [c[1] for c in b["counts"]]}


# phase 19: the dataset writers, the acceptance run and the packaged YAML's
# batch 512.  (a)'s splits: phase 9's val sizes, HR 24 to 48 pixels high and
# 3 to 5 times as wide; a second commit of 40 pairs appended to the last
ACCEPT_HEIGHTS = (24, 48)
ACCEPT_APPEND = 40
ACCEPT_RECS = ("CRNN", "ASTER", "MORAN")  # (b)'s recognizers, in the order of --recognizers
ACCEPT_NOISE_ROWS = 16  # rows on which (b) measures ASTER's chain noise, card against CPU
# tests/test_train.py::test_eval_step_tiled_equivalence's bounds: SR, then every output.
# The per-sample MSE is held in the SR's units (divided by 255^2): on its
# 255^2 scale an fp32 MSE near 1e4 has an ulp of ~1e-3, and the tiles' SR,
# 3.4e-7 from the flat one's on the H100 (cuDNN picks its algorithms by
# batch), moves it by a few ulps (3.9e-3)
TILED_SR_ATOL, TILED_OUT_ATOL = 2e-6, 2e-5
TILED_UNITS = {"mse": 255.0 ** 2}
B512_EVAL_REPEATS = 5  # timed evals of a batch of 512, after a warm one
B512_CLI_EPOCHS = 10  # (d): 2 iterations an epoch over phase 9's 1,056 train pairs; 19 timed


def _jpeg_decoded(img: Image.Image) -> np.ndarray:
    """What a reader decodes of ``img`` as ``data.create_lmdb`` writes it (JPEG, 95)."""
    buf = io.BytesIO()
    img.convert("RGB").save(buf, "JPEG", quality=95)
    return np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))


def accept_words(rng, n: int, seed: int):
    """``n`` rendered words: (HR images, words)."""
    words = random_words(rng, n)
    heights = rng.integers(ACCEPT_HEIGHTS[0], ACCEPT_HEIGHTS[1] + 1, n)
    widths = (heights * rng.uniform(3.0, 5.0, n)).astype(int)
    images = [render_word(w, (int(x), int(h)), seed=seed + j) for j, (w, x, h) in enumerate(zip(words, widths, heights))]
    return images, words


def hr_reads(recs, hr, dev: str):
    """What each recognizer of ``recs`` ({kind: module}) reads on each HR
    image as the eval step sees it: the pairs written to a scratch split,
    read back through a val loader (JPEG, then 32x128), turned into the
    recognizer's input (``recognizer_input``) and decoded (``rec_decoder``).
    Returns {kind: [reads]}."""
    voc = load_config().TRAIN.voc_type
    with tempfile.TemporaryDirectory(prefix="reads-") as tmp:
        create_paired_dataset(tmp, hr, ["x"] * len(hr))
        (loader,) = trainer.val_loaders([tmp], "tsrn_tl_cascade", mask=True, **loader_kw(BATCH, dev, workers=0))
        reads = {kind: [] for kind in recs}
        with torch.no_grad():
            for batch in loader:
                hr_t = batch["hr"].to(dev).float() / 255.0
                for kind, rec in recs.items():
                    out = rec(recognizer_input(kind, hr_t))
                    reads[kind] += rec_decoder(kind, voc)(out[0] if kind == "MORAN" else out)
    return reads


def accept_splits(root: str, files, dev: str = "cuda"):
    """(a) easy/medium/hard under ``root`` by ``create_paired_dataset`` (LR
    bicubic at half size), 40 more pairs appended to the last as a second
    commit; word j relabelled with what recognizer j mod 3 (the CRNN, ASTER,
    MORAN of ``files``) reads on its HR on ``dev``, lowercased to what
    accuracy compares, where that is not empty, so that no recognizer's HR
    accuracy is 0 by construction.  Each split read back through
    ``TextZoomDataset``: every HR, LR and label is what was written; the
    last split's first commit still reads by its meta slot.  Returns the
    split directories and the relabelled words of each recognizer."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(19)
    cfg = load_config()
    cfg.TRAIN.VAL.update(crnn_pretrained=files["crnn"], rec_pretrained=files["aster"], moran_pretrained=files["moran"])
    recs = {kind: trainer.eval_recognizer(kind, cfg, device=dev) for kind in ACCEPT_RECS}
    parts = [accept_words(rng, n, seed=19_000 + 1_000 * i) for i, n in enumerate(VAL_PAIRS)]
    parts.append(accept_words(rng, ACCEPT_APPEND, seed=19_900))
    relabelled = {kind: 0 for kind in ACCEPT_RECS}
    for hr, words in parts:
        reads = hr_reads(recs, hr, dev)
        for j in range(len(words)):
            kind = ACCEPT_RECS[j % len(ACCEPT_RECS)]
            read = str_filt(reads[kind][j], "lower")
            if read:
                words[j] = read
                relabelled[kind] += 1
    del recs
    dirs = []
    for name, (hr, words) in zip(accept_real.SPLITS, parts):
        dirs.append(f"{root}/{name}")
        check(create_paired_dataset(dirs[-1], hr, words) == len(hr), f"create_lmdb: {name} not written whole")
    check(append_paired_dataset(dirs[-1], *parts[-1]) == ACCEPT_APPEND, "create_lmdb: the appended pairs not written")
    build_s = time.perf_counter() - t0
    written = parts[:2] + [(parts[2][0] + parts[3][0], parts[2][1] + parts[3][1])]
    for d, (hr, words) in zip(dirs, written):
        ds = TextZoomDataset(d, voc_type="all")
        check(len(ds) == len(words), f"create_lmdb: {d} reads {len(ds)} pairs, {len(words)} written")
        for i, (img, word) in enumerate(zip(hr, words)):
            got_hr, got_lr, label = ds[i]
            lr = img.resize((img.size[0] // 2, img.size[1] // 2), Image.BICUBIC)
            check(label == word and np.array_equal(np.asarray(got_hr.convert("RGB")), _jpeg_decoded(img))
                  and np.array_equal(np.asarray(got_lr.convert("RGB")), _jpeg_decoded(lr)),
                  f"create_lmdb: {d} item {i} is not what was written")
    readers = sorted((LMDBReader(dirs[-1], meta_slot=s) for s in (0, 1)), key=lambda r: r.txnid)
    n_last = VAL_PAIRS[-1]
    check(readers[0].get(b"num-samples") == str(n_last).encode()
          and readers[0].get(b"label-%09d" % (n_last + 1)) is None
          and readers[1].get(b"num-samples") == str(n_last + ACCEPT_APPEND).encode(),
          "create_lmdb: the first commit's snapshot does not read by its meta slot")
    check(all(relabelled.values()), f"create_lmdb: a recognizer read nothing on the HR {relabelled}")
    out = {"splits": [len(w) for _, w in written], "appended": ACCEPT_APPEND, "relabelled": relabelled, "build_s": build_s,
           "txnids": [r.txnid for r in readers], "s": time.perf_counter() - t0}
    for r in readers:
        r.close()
    print(json.dumps({"create_lmdb": out}), flush=True)
    return dirs


def accept_files(root: str):
    """(b)'s files in the original's layout, from seeded weights:
    ``crnn.pth`` (phase 17's sharpened CRNN), ``aster_demo.pth.tar`` (a
    ``state_dict`` entry beside an epoch) and ``moran_demo.pth``, each drawn
    and sharpened as phase 14's, and a flagship generator
    ``model_best_0.pth`` with ``state_dict_G``."""
    os.makedirs(root, exist_ok=True)
    files = {"crnn": sharpened_crnn(f"{root}/crnn.pth"), "aster": f"{root}/aster_demo.pth.tar",
             "moran": f"{root}/moran_demo.pth", "ckpt": f"{root}/model_best_0.pth"}
    cfg = load_config()
    info = AsterInfo(cfg.TRAIN.voc_type)
    gen = torch.Generator().manual_seed(19)
    rec = aster.RecognizerBuilder(info.rec_num_classes, info.char2id[info.EOS], max_len_labels=info.max_len)
    torch.save({"state_dict": sharpen_recognizer_(rec.init_from_(gen), "ASTER").state_dict(), "epoch": 0},
               files["aster"])
    torch.save(sharpen_recognizer_(moran.MORAN().init_from_(gen), "MORAN").state_dict(), files["moran"])
    sr = build_model("tsrn_tl_cascade", *registry_dicts(cfg, AttrDict(STN=True, mask=True, srb=N_SRB, hd_u=32)))[0]
    torch.save({"state_dict_G": init_torch_defaults_(sr, gen).state_dict()}, files["ckpt"])
    return files


def aster_flips_within_margin(files, images, flips):
    """(b)'s rule for ASTER's strings on the first split, card against CPU:
    its 100-step beam search, from seeded weights that read to the length
    limit, may pick another beam on the card only where the CPU's own
    decisions were a near tie, as phase 14 holds it.  For each of ``images``
    (the CPU pass's SR, LR and HR, NHWC) whose rows ``flips`` lists as
    differing, ``rec_reads`` on those rows and the first
    ``ACCEPT_NOISE_ROWS``: every differing row's CPU margin within
    ``REC_MARGIN_FACTOR`` times the chain's noise (the card's score error on
    the rows whose ids agree), and at least half the rows equal, as phase
    14 asks.  Returns {kind: rows, margins, noise, threshold}."""
    cfg = load_config()
    cfg.TRAIN.VAL.update(rec_pretrained=files["aster"])
    card, cpu = (trainer.eval_recognizer("ASTER", cfg, device=d) for d in ("cuda", "cpu"))
    out = {}
    for k, rows in flips.items():
        check(2 * len(rows) <= len(images[k]), f"accept_real aster: {len(rows)} of {len(images[k])} {k} strings differ")
        if not rows:
            continue
        idx = sorted(set(range(min(ACCEPT_NOISE_ROWS, len(images[k])))) | set(rows))
        with torch.no_grad():
            r = rec_reads("ASTER", card, cpu, recognizer_input("ASTER", images[k][idx]))
        ids_g, ids_c = r["ids"]
        agree = (ids_g.cpu() == ids_c).reshape(len(ids_c), -1).all(dim=1)
        noise = float((r["chain_score"][0].cpu() - r["chain_score"][1])[agree].abs().max()) if agree.any() else 0.0
        threshold = REC_MARGIN_FACTOR * max(noise, 1e-7)
        margins = {j: float(r["margins"][idx.index(j)]) for j in rows}
        check(all(m <= threshold for m in margins.values()),
              f"accept_real aster {k}: a row differs beyond its margin {margins} > {threshold}")
        out[k] = {"rows": rows, "margins": margins, "noise": noise, "threshold": threshold}
    return out


def phase_accept_run(root: str, split_dirs, files, smi: str):
    """(b) ``python -m tpgsr_tpu_torch.accept_real --recognizers
    crnn,aster,moran`` in-process on the card over (a)'s splits at batch 48
    (loading in the calling process) with (b)'s files: each file reported
    ``[ok]``; each recognizer's ``--go_test`` pass timed (images/s of the
    pass: ``TextSR``'s start, its loaders and the val), K1's launches
    counted (10 an SR batch), each split's SR, LR and HR accuracies
    recounted by ``utils.metrics.accuracy`` from the strings the pass
    decoded, every recognizer's HR accuracy above 0 (a third of the words
    are its reads); then the same passes over the first split on the CPU,
    whose decoded SR, LR and HR strings the card's equal one for one (for
    ASTER, but in rows ``aster_flips_within_margin`` admits) and whose
    metric dicts the card's equal (PSNR and SSIM at 1e-4, each accuracy
    within the share of its rows whose strings differ, the rest exactly)."""
    t0 = time.perf_counter()
    argv = ["--textzoom", os.path.dirname(split_dirs[0]), "--recognizers", "crnn,aster,moran", "--batch", str(BATCH),
            "--workers", "0", "--json", f"{root}/accept.json"] + [f"--{k}={v}" for k, v in files.items()]
    times, recounts, decoded, images = {}, [], {}, {}
    go_test, real_evaluate = accept_real.run_go_test, trainer.evaluate
    current = ["card", None]  # the pass under way: "card" or "cpu", its recognizer

    def tapped_go_test(ns, dirs, rec, device):
        current[1] = rec
        if current[0] == "cpu":
            return go_test(ns, dirs, rec, device)
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        out = go_test(ns, dirs, rec, device)
        torch.cuda.synchronize()
        times[rec] = time.perf_counter() - s0
        return out

    def recounting_evaluate(step, models, batches, max_batches=0, decoder=decode_crnn, **kw):
        logits, labels = {"sr": [], "lr": [], "hr": []}, []

        def tapped_step(m, batch):
            sr, outs = step(m, batch)
            for k, v in logits.items():
                v.append(outs[f"logits_{k}"])
            if current == ["cpu", "aster"]:
                images.setdefault("aster", []).append(
                    {"sr": sr, **{k: port_step._as_image(batch[k], torch.device("cpu"), True) for k in ("lr", "hr")}})
            return sr, outs

        def tapped_batches():
            for batch in batches:
                labels.extend(str_filt(g, "lower") for g in batch["labels"])
                yield batch

        md = real_evaluate(tapped_step, models, tapped_batches(), max_batches, decoder=decoder, **kw)
        preds = {k: [str_filt(p, "lower") for out in v for p in decoder(out)] for k, v in logits.items()}
        for k, key in (("sr", "accuracy"), ("lr", "accuracy_lr"), ("hr", "accuracy_hr")):
            recounts.append((md[key], metrics.accuracy(preds[k], labels)))
        decoded.setdefault(tuple(current), []).append(preds)
        return md

    out = io.StringIO()
    cwd = os.getcwd()
    os.chdir(root)
    gru_seq.LAUNCHES = 0
    accept_real.run_go_test, trainer.evaluate = tapped_go_test, recounting_evaluate
    try:
        with contextlib.redirect_stdout(out):
            results = accept_real.main(argv)
        launches = gru_seq.LAUNCHES
        ns = accept_real.build_parser().parse_args(argv)
        cpu_s, cpu = {}, {}
        current[0] = "cpu"
        for rec in results:
            s0 = time.perf_counter()
            cpu[rec] = tapped_go_test(ns, split_dirs[:1], rec, "cpu")
            cpu_s[rec] = time.perf_counter() - s0
    finally:
        accept_real.run_go_test, trainer.evaluate = go_test, real_evaluate
        os.chdir(cwd)
    print(out.getvalue(), end="", flush=True)
    for label in ("crnn", "aster", "moran", "generator"):
        check(f"  [ok]   {label}: " in out.getvalue(), f"accept_real: {label}'s file not reported [ok]")
    check("=== acceptance table" in out.getvalue(), "accept_real printed no table")
    n_images = [n + (ACCEPT_APPEND if i == len(VAL_PAIRS) - 1 else 0) for i, n in enumerate(VAL_PAIRS)]
    for rec, mds in results.items():
        check(list(mds) == list(accept_real.SPLITS) and [md["images"] for md in mds.values()] == n_images
              and all(np.isfinite(v) for md in mds.values() for v in md.values()), f"accept_real {rec}: {mds}")
        check(all(md["accuracy_hr"] > 0 for md in mds.values()), f"accept_real: {rec} read no HR word of a split {mds}")
    check(len(recounts) == 3 * 3 * (len(n_images) + 1) and all(a == b for a, b in recounts),
          f"accept_real: accuracies against utils.metrics.accuracy of the decoded strings {recounts}")
    n_batches = sum(-(-n // BATCH) for n in n_images)
    check(launches == 3 * 2 * N_SRB * n_batches, f"accept_real: K1 launched {launches} times, expected "
          f"{3 * 2 * N_SRB * n_batches}")
    name = accept_real.SPLITS[0]
    strings, flips = 0, {}
    for rec in results:
        (card_first, *_), (cpu_first,) = decoded[("card", rec)], decoded[("cpu", rec)]
        for k, want in cpu_first.items():
            differ = [j for j, (g, w) in enumerate(zip(card_first[k], want)) if g != w]
            check(len(card_first[k]) == len(want) == VAL_PAIRS[0] and (rec == "aster" or not differ),
                  f"accept_real {rec} {name}: the card's {k} strings differ from the CPU's at {differ[:10]}")
            flips[(rec, k)] = differ
            strings += len(want)
    aster_images = {k: torch.cat([part[k] for part in images["aster"]]) for k in ("sr", "lr", "hr")}
    aster_flips = aster_flips_within_margin(files, aster_images, {k: flips[("aster", k)] for k in aster_images})
    for rec in results:
        got, want = dict(results[rec][name]), dict(cpu[rec][name])
        for k, key in (("sr", "accuracy"), ("lr", "accuracy_lr"), ("hr", "accuracy_hr")):
            bound = len(flips[(rec, k)]) / VAL_PAIRS[0]
            check(abs(got.pop(key) - want.pop(key)) <= bound,
                  f"accept_real {rec} {name} {key}: card {results[rec][name][key]} vs CPU {cpu[rec][name][key]}")
        check_metric_dicts(got, want, f"accept_real {rec} {name}, card against CPU")
    row = {"card": smi, "batch": BATCH, "images": sum(n_images), "k1_launches": launches,
           "images_per_s": {rec: sum(n_images) / s for rec, s in times.items()}, "pass_s": times,
           "accuracy_recounts": len(recounts), "cpu_compare_split": name, "strings_compared": strings,
           "aster_flips": aster_flips,
           "cpu_s": cpu_s, "metrics": results, "s": time.perf_counter() - t0}
    print(json.dumps({"accept_real": row}), flush=True)
    return launches


def _max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def phase_b512_eval(smi: str):
    """(c) The flagship's fp32 eval step at the packaged YAML's batch 512,
    flat (``eval_tile`` 0, the default) and in tiles of 64, on one batch:
    SR at ``TILED_SR_ATOL``, every output (per-sample MSE in the SR's units,
    SSIM, each ``logits_*``) at ``TILED_OUT_ATOL``; K1's launches (10 flat, 80 in
    tiles); images/s by CUDA events over ``B512_EVAL_REPEATS`` steps after a
    warm one, and peak memory, of each."""
    models, _ = entry.flagship(device="cuda", seed=0)
    batch = synthetic_batch(np.random.default_rng(512), BIG_BATCH, labels=False)
    rows, results = {}, {}
    for name, tile in (("flat", 0), ("tiled", tiling.DEFAULT_TILE)):
        step = make_eval_step(entry.FLAGSHIP_ARGS, entry.TRAIN_WIDTH, device="cuda", tile=tile)
        gru_seq.LAUNCHES = 0
        results[name] = step(models, batch)
        torch.cuda.synchronize()
        launches = gru_seq.LAUNCHES
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(B512_EVAL_REPEATS):
            step(models, batch)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / B512_EVAL_REPEATS
        rows[name] = {"tile": tile, "k1_launches": launches, "ms_per_batch": ms,
                      "images_per_s": BIG_BATCH / (ms / 1e3), "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    (sr_f, outs_f), (sr_t, outs_t) = results["flat"], results["tiled"]
    errs = {"sr": _max_err(sr_t, sr_f),
            **{k: _max_err(outs_t[k], v) / TILED_UNITS.get(k, 1.0) for k, v in outs_f.items()}}
    check(set(outs_t) == set(outs_f) and sr_t.shape == sr_f.shape
          and all(outs_t[k].shape == v.shape for k, v in outs_f.items()), "batch 512: tiled outputs' shapes")
    check(errs["sr"] <= TILED_SR_ATOL and all(e <= TILED_OUT_ATOL for k, e in errs.items() if k != "sr"),
          f"batch 512: tiled against flat {errs} beyond {TILED_SR_ATOL} / {TILED_OUT_ATOL}")
    check(rows["flat"]["k1_launches"] == 2 * N_SRB and rows["tiled"]["k1_launches"] == 2 * N_SRB * BIG_BATCH // 64,
          f"batch 512: K1 launches {rows}")
    out = {"card": smi, "batch": BIG_BATCH, "max_abs_err": errs, "mse_max_abs_err": _max_err(outs_t["mse"], outs_f["mse"]),
           **rows}
    print(json.dumps({"b512_eval": out}), flush=True)
    return rows["flat"]["k1_launches"] + rows["tiled"]["k1_launches"]


def phase_b512_cli(root: str, train_dirs, smi: str):
    """(d) ``cli.main`` with no flags (the default arch, ``tsrn_tl_wmask``) on
    the packaged YAML, unchanged but for the data directories, the depth
    (``B512_CLI_EPOCHS`` epochs of 2 iterations over phase 9's train
    LMDBs) and one val with a save at the end, over phase 9's first train
    LMDB (528 pairs: a batch of 512, then 16; flat, as the YAML's
    ``eval_tile: 0`` says): bf16 train steps at batch 512, K1's launches (10
    + 10 an iteration, 20 in the val), peak memory and images/s between the
    first iteration and the val."""
    cfg = load_config()
    check(cfg.TRAIN.batch_size == BIG_BATCH and cfg.TRAIN.compute_dtype == "bf16" and cfg.TRAIN.eval_tile == 0,
          f"the packaged YAML: batch {cfg.TRAIN.batch_size}, {cfg.TRAIN.compute_dtype}, tile {cfg.TRAIN.eval_tile}")
    iterations = B512_CLI_EPOCHS * (TRAIN_PAIRS // BIG_BATCH)
    cfg.TRAIN.update(train_data_dir=list(train_dirs), epochs=B512_CLI_EPOCHS, saveInterval=iterations,
                     ckpt_dir=f"{root}/ckpt_b512")
    cfg.TRAIN.VAL.update(val_data_dir=list(train_dirs[:1]), valInterval=iterations)
    config_path = f"{root}/b512.yaml"
    with open(config_path, "w") as f:
        json.dump(cfg, f)  # JSON is YAML
    argv = ["--vis_dir", "b512_default", "--config", config_path]
    cwd = os.getcwd()
    os.chdir(root)
    try:
        probe = TrainerProbe()
        gru_seq.LAUNCHES = gru_seq.BACKWARD_LAUNCHES = 0
        torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        with probe.installed():
            state = cli.main(argv)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - start
    finally:
        os.chdir(cwd)
    (val,) = [e for e in probe.events if e["name"] == "val"]
    (split,) = val["out"].values()
    val_launches = val["counts1"][0] - val["counts0"][0]
    check(state.step == iterations and probe.compute_dtypes == ["bf16"] and len(state.sr) == 1,
          f"batch 512 CLI: step {state.step}, {probe.compute_dtypes}")
    check(os.path.exists(f"{root}/ckpt_b512/b512_default/checkpoint_0.pth"), "batch 512 CLI: no save")
    check(split["images"] == TRAIN_PAIRS // 2 and all(np.isfinite(v) for v in split.values()), f"val {split}")
    val_batches = -(-(TRAIN_PAIRS // 2) // BIG_BATCH)
    want = (2 * N_SRB * (iterations + val_batches), 2 * N_SRB * iterations)
    got = (gru_seq.LAUNCHES, gru_seq.BACKWARD_LAUNCHES)
    check(got == want and val_launches == 2 * N_SRB * val_batches, f"batch 512 CLI: K1 launched {got}, "
          f"{val_launches} in the val; expected {want}")
    window_s = val["t0"] - probe.first_step_end
    out = {"card": smi, "arch": "tsrn_tl_wmask", "batch": BIG_BATCH, "compute_dtype": "bf16", "iterations": iterations,
           "images_per_s": BIG_BATCH * (iterations - 1) / window_s, "window_s": window_s,
           "first_iteration_s": probe.first_step_end - start, "val_s": val["t1"] - val["t0"], "run_s": run_s,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "k1_launches": got, "val_k1_launches": val_launches,
           "losses_first": {k: float(v) for k, v in probe.metrics[0].items()}, "val": split, "host": host_load()}
    print(json.dumps({"b512_cli": out}), flush=True)
    del state
    return {"fp32": val_launches, "bf16": got[0] - val_launches, "bf16_backward": got[1]}


def phase_accept(root: str, train_dirs, smi: str):
    """Phase 19: (a) the dataset writers, (b) the acceptance run, (c) the flagship's
    eval at batch 512 flat and in tiles, (d) the CLI as shipped at batch
    512.  Returns K1's launches: (b)'s; (c)'s and (d)'s val's (fp32); (d)'s
    training's (bf16, forward and backward)."""
    t0 = time.perf_counter()
    files = accept_files(f"{root}/accept_files")
    split_dirs = accept_splits(f"{root}/accept_tz", files)
    accept_launches = phase_accept_run(root, split_dirs, files, smi)
    eval_launches = phase_b512_eval(smi)
    cli_launches = phase_b512_cli(root, train_dirs, smi)
    print(f"accept: phase 19 took {time.perf_counter() - t0:.1f} s", flush=True)
    return {"accept": accept_launches, "b512": eval_launches + cli_launches["fp32"], "b512_bf16": cli_launches["bf16"],
            "b512_bf16_backward": cli_launches["bf16_backward"]}


# phase 20: the flagship at --hd_u beyond 32.  (a)'s fp32 steps card
# against CPU: a wide size and one padded to 32; (b)'s CLI run: the wide
# kernels in bf16 through the packaged YAML
HD_U_STEPS = (64, 20)
HD_U_CLI = 64


def phase_hd_u(root: str, val_dirs, packaged, smi: str):
    """Phase 20: (a) one flagship fp32 train step at batch 8 on the card
    against the CPU at each of ``HD_U_STEPS`` (phase 7's bounds), K1
    launched 10 + 10, on the wide kernels at 64 and on the padded 32's at 20;
    (b) ``cli.main`` with the flagship's flags and ``--hd_u 64`` on phase
    12's config (``packaged``: the packaged YAML, bf16, batch 48, one epoch
    of 22 iterations over phase 9's TextZoom with a val and a save), every K1
    launch on the wide kernels, then ``--go_test`` from its checkpoint with
    the run's val metric dicts (PSNR and SSIM at phase 4's 1e-4), the val
    loaders in the calling process as in phase 12 (``val_in_process``);
    images/s between the first iteration and the val and peak memory beside
    phase 12's at --hd_u 32.  Returns K1's launches for the kernels line."""
    t0 = time.perf_counter()
    steps = {}
    for h in HD_U_STEPS:
        launches = phase_train_card_vs_cpu(h)
        wide = 2 * N_SRB if h in gru_seq.WIDE_HIDDEN else 0
        want = (2 * N_SRB, 2 * N_SRB, wide, wide)
        check(launches == want, f"--hd_u {h} step: K1 launched {launches} (forward, backward, wide forward, wide "
              f"backward), expected {want}")
        steps[h] = launches

    iterations = packaged["iterations"]
    n_val_batches = sum(-(-n // BATCH) for n in VAL_PAIRS)
    name = f"smoke_hd{HD_U_CLI}"
    argv = TRAINER_FLAGS[:-1] + [name, "--config", packaged["config"], "--hd_u", str(HD_U_CLI)]
    ckpt_dir = f"{root}/ckpt_packaged/{name}"
    cwd = os.getcwd()
    os.chdir(root)
    try:
        probe = TrainerProbe()
        for k in ("LAUNCHES", "BACKWARD_LAUNCHES", "WIDE_LAUNCHES", "WIDE_BACKWARD_LAUNCHES"):
            setattr(gru_seq, k, 0)
        torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        with probe.installed(), val_in_process():
            state = cli.main(argv)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - start
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        check(probe.compute_dtypes == ["bf16"], f"--hd_u {HD_U_CLI}: the train step ran in {probe.compute_dtypes}")
        check(state.step == iterations, f"--hd_u {HD_U_CLI}: trainer at step {state.step}, expected {iterations}")
        sizes = {m.hidden_size for m in state.sr[0].modules() if isinstance(m, BiGRUParams)}
        check(sizes == {HD_U_CLI}, f"--hd_u {HD_U_CLI}: the SR model's BiGRUs have hidden sizes {sizes}")
        run = k1_counts()
        fwd, bwd = 2 * N_SRB * (iterations + n_val_batches), 2 * N_SRB * iterations
        check(run == (fwd, bwd, fwd, bwd), f"--hd_u {HD_U_CLI}: K1 launched {run} (forward, backward, wide forward, "
              f"wide backward), expected {(fwd, bwd, fwd, bwd)}")
        (val,) = [e for e in probe.events if e["name"] == "val"]
        window_s = val["t0"] - probe.first_step_end
        window = [b - a for a, b in zip(probe.first_step_counts, val["counts0"])]
        want = 2 * N_SRB * (iterations - 1)
        check(window == [want, want], f"--hd_u {HD_U_CLI}: K1 launched {window} times in the window, expected {want}")
        losses = {k: float(v) for k, v in probe.metrics[0].items()}
        check(all(np.isfinite(v) for v in losses.values()), f"--hd_u {HD_U_CLI} iteration 1: losses {losses}")
        del state
        with val_in_process():
            go = cli.main(argv + ["--go_test", "--resume", ckpt_dir])
        check(list(go) == list(val["out"]), f"--hd_u {HD_U_CLI} --go_test splits {list(go)}")
        for split in go:
            check_metric_dicts(go[split], val["out"][split], f"--hd_u {HD_U_CLI} --go_test {split} against the val")
    finally:
        os.chdir(cwd)
    out = {"card": smi, "compute_dtype": "bf16", "batch": BATCH, "hd_u": HD_U_CLI, "iterations": iterations,
           "window_iterations": iterations - 1, "window_s": window_s,
           "images_per_s": BATCH * (iterations - 1) / window_s, "peak_mem_gib": peak_gib,
           "phase12_hd_u32_images_per_s": packaged["images_per_s"],
           "phase12_hd_u32_peak_mem_gib": packaged["peak_mem_gib"],
           "first_iteration_s": probe.first_step_end - start, "run_s": run_s, "val_s": val["t1"] - val["t0"],
           "k1_launches": window[0], "k1_backward_launches": window[1], "card_losses": losses,
           "val": {s: _psnr_ssim(md) for s, md in val["out"].items()},
           "step_k1_launches": {str(h): list(v) for h, v in steps.items()}, "s": time.perf_counter() - t0}
    print(json.dumps({"hd_u": out}), flush=True)
    return {"fp32": steps[HD_U_CLI][2], "fp32_backward": steps[HD_U_CLI][3], "bf16": window[0],
            "bf16_backward": window[1]}


def per_sr(rows, keys, hidden: int = 32):
    """Each key summed over the two sweep rows at batch 48 (at ``hidden``:
    the wide rows' label names it), times N_SRB: one SR forward (or
    backward) at batch 48; None where a row has none (a library call cuDNN
    refused)."""
    end = f"B={BATCH}" if hidden == 32 else f"B={BATCH}, H={hidden}"
    rows = [row for row in rows if row["label"].endswith(end)]
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


def wide_entry(dtype, backward: bool, shapes, ptxas, launches, max_err, **extra):
    """The wide kernel's entry of the kernels line, forward or backward, in
    ``dtype``: per SR forward (backward) of the flagship at --hd_u 64."""
    name = DTYPE_NAMES[dtype]
    h = HD_U_CLI
    if backward:
        keys = ("ms", "kernel_only_ms", "fwd_bwd_ms", "library_ms", "plain_ms", "bytes_ms", "operations_ms",
                "kernel_only_bound_ms")
        unit = (f"one flagship SR backward at --hd_u {h}, batch {BATCH}, in {name}: {N_SRB} sweeps over W and "
                f"{N_SRB} over H; ms: the recurrence's backward (the kernel, then the dW_hh GEMM and sums); "
                f"kernel_only_ms: the kernel alone; fwd_bwd_ms: the wrapper's forward and backward; library_ms: "
                f"nn.GRU forward and backward in {name}; plain_ms: the plain BPTT")
    else:
        keys = ("ms", "device_ms", "kernel_only_ms", "plain_ms", "library_ms", "bytes_ms", "operations_ms",
                "kernel_only_bound_ms")
        unit = (f"one flagship SR forward at --hd_u {h}, batch {BATCH}, in {name}: {N_SRB} sweeps over W and "
                f"{N_SRB} over H; ms: the wrapper by per-call events; device_ms: the wrapper by device_ms; "
                "kernel_only_ms: the kernel alone on prepared weights")
    per = per_sr(shapes, keys, hidden=h)
    return {
        "name": f"K1 bigru_seq wide{' backward' if backward else ''} ({name})",
        "route": "cuda",
        "source": f"tpgsr_tpu_torch/csrc/{WIDE_SOURCE}.cu",
        "replaces": "tpgsr_tpu/ops/pallas_gru.py:34 (backward of)" if backward else "tpgsr_tpu/ops/pallas_gru.py:95",
        "dtype": name,
        "hidden": list(gru_seq.WIDE_HIDDEN),
        "launches": launches,
        "max_abs_err": max_err,
        "unit": unit,
        **{k: per[k] for k in keys if k not in ("bytes_ms", "operations_ms")},
        **bound_fields(per["bytes_ms"], per["operations_ms"]),
        "shapes": shapes,
        "ptxas": [r for r in ptxas[backward] if r["dtype"] == name],
        **extra,
    }


# K1's sources by storage type: (forward, backward)
K1_SOURCES = {torch.float32: ("bigru_seq", "bigru_seq_bwd"), torch.bfloat16: ("bigru_seq_bf16", "bigru_seq_bwd_bf16")}


WIDE_SOURCE = "bigru_seq_wide"  # both ways, both storage types, H = 64 and 128


def check_ptxas(name: str, backward: bool):
    """Phase 2's rows for one source (one direction of the wide source):
    every instantiation (hidden size x ``instantiations``; in the wide
    source storage type x hidden size x rows a thread) reported, none
    spilling or keeping a stack frame."""
    rows = ptxas_report(_build.build_log(name), backward=backward)
    for r in rows:
        print(f"nvcc {name} " + json.dumps(r), flush=True)
    if name == WIDE_SOURCE:
        want = len(DTYPE_NAMES) * len(gru_seq.WIDE_HIDDEN) * len(gru_seq.RPTS)
        rows = [r for r in rows if r.get("wide")]
    else:
        dtype = torch.bfloat16 if name.endswith("_bf16") else torch.float32
        want = len(gru_seq.NARROW_HIDDEN) * len(instantiations(dtype, backward))
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
    wide_ptxas = {backward: check_ptxas(WIDE_SOURCE, backward) for backward in (False, True)}
    lap("1-2 device, build")

    # 3. K1 against its plain version, fp32 and bf16, the wide kernels and padded sizes
    max_err, shapes = phase_k1()
    bf16_err, bf16_shapes = phase_k1(torch.bfloat16)
    wide = {dtype: phase_k1_wide(dtype) for dtype in DTYPE_NAMES}
    lap("3 K1")

    # 4. card vs CPU, 5. serve
    models, step = phase_card_vs_cpu()
    launches, serve_ips = phase_serve(models, step)
    del models, step
    lap("4-5 eval")

    # 6. K1's backward against its plain version, 7. train step card vs CPU, 8. train
    bwd_err, bwd_shapes = phase_k1_backward()
    bf16_bwd_err, bf16_bwd_shapes = phase_k1_backward(torch.bfloat16)
    wide_bwd = {dtype: phase_k1_wide_backward(dtype) for dtype in DTYPE_NAMES}
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
        # 17. --syn, --mixed, --ic15sr and --random_reso
        modes = phase_modes(root, train_dirs, val_dirs)
        lap("17 data flags, random_reso")
        # 18. data parallelism: two gloo ranks on the card, one NCCL rank
        ddp = phase_ddp(root, train_dirs, val_dirs, packaged, smi.splitlines()[0])
        lap("18 data parallelism")
        # 19. the dataset writers, the acceptance run, the packaged YAML's batch 512
        accept = phase_accept(root, train_dirs, smi.splitlines()[0])
        lap("19 create_lmdb, acceptance run, batch 512")
        # 20. --hd_u beyond 32: the wide kernels and a padded size on the flagship
        hd_u = phase_hd_u(root, val_dirs, packaged, smi.splitlines()[0])
        lap("20 --hd_u beyond 32")

    kernels = [
        forward_entry(torch.float32, shapes, ptxas, launches, max_err, train_launches=train_launches,
                      lmdb_train_launches=lmdb_train["k1_launches"], lmdb_eval_launches=lmdb_eval["k1_launches"],
                      trainer_launches=trainer_run["k1_launches"], zoo_launches=zoo["fp32"][0],
                      rec_eval_launches=rec_launches, tl_simple_launches=rest["fp32"][0],
                      remat_launches=rest["remat"][0], c2f_launches=newest[("tsrn_c2f", "fp32")][0],
                      opt_launches=newest[("opt", "fp32")][0], sem_launches=newest[("sem_tsrn", "fp32")][0],
                      seed_eval_launches=newest["seed_eval"], random_reso_launches=modes["random_reso"],
                      ddp_launches=ddp["fp32"], accept_launches=accept["accept"], b512_launches=accept["b512"],
                      **{f"{flag}_launches": modes[(flag, "fp32")][0] for flag in MODE_FLAGS}),
        backward_entry(torch.float32, bwd_shapes, bwd_ptxas, backward_launches, bwd_err,
                       lmdb_train_launches=lmdb_train["k1_backward_launches"],
                       trainer_launches=trainer_run["k1_backward_launches"], zoo_launches=zoo["fp32"][1],
                       tl_simple_launches=rest["fp32"][1], remat_launches=rest["remat"][1],
                       c2f_launches=newest[("tsrn_c2f", "fp32")][1], opt_launches=newest[("opt", "fp32")][1],
                       ddp_launches=ddp["fp32_backward"],
                       **{f"{flag}_launches": modes[(flag, "fp32")][1] for flag in MODE_FLAGS}),
        forward_entry(torch.bfloat16, bf16_shapes, ptxas, bf16_launches, bf16_err,
                      train_images_per_s=bf16_train["bf16_images_per_s"],
                      packaged_yaml_launches=packaged["k1_launches"], zoo_launches=zoo["bf16"][0],
                      tl_simple_launches=rest["bf16"][0], c2f_launches=newest[("tsrn_c2f", "bf16")][0],
                      opt_launches=newest[("opt", "bf16")][0], ddp_launches=ddp["bf16"],
                      b512_launches=accept["b512_bf16"],
                      **{f"{flag}_launches": modes[(flag, "bf16")][0] for flag in MODE_FLAGS}),
        backward_entry(torch.bfloat16, bf16_bwd_shapes, bwd_ptxas, bf16_backward_launches, bf16_bwd_err,
                       packaged_yaml_launches=packaged["k1_backward_launches"], zoo_launches=zoo["bf16"][1],
                       tl_simple_launches=rest["bf16"][1], c2f_launches=newest[("tsrn_c2f", "bf16")][1],
                       opt_launches=newest[("opt", "bf16")][1], ddp_launches=ddp["bf16_backward"],
                       b512_launches=accept["b512_bf16_backward"],
                       **{f"{flag}_launches": modes[(flag, "bf16")][1] for flag in MODE_FLAGS}),
    ]
    for dtype in DTYPE_NAMES:
        key = DTYPE_NAMES[dtype]
        kernels.append(wide_entry(dtype, False, wide[dtype][1], wide_ptxas, hd_u[key], wide[dtype][0]))
        kernels.append(wide_entry(dtype, True, wide_bwd[dtype][1], wide_ptxas, hd_u[f"{key}_backward"],
                                  wide_bwd[dtype][0]))
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} was not launched on its main path")
        check(all(k[key] > 0 for key in ("accept_launches", "b512_launches") if key in k),
              f"{k['name']} was not launched in phase 19")
        check("ddp_launches" not in k or (len(k["ddp_launches"]) == DDP_WORLD and min(k["ddp_launches"]) > 0),
              f"{k['name']} was not launched on every rank of phase 18")
    print(json.dumps({"phase_seconds": seconds}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
