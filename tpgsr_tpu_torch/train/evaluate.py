"""Validation loop: PSNR, SSIM and word accuracy over batches (counterpart
of tpgsr_tpu/train/evaluate.py:24-206; reference TextSR.eval,
interfaces/super_resolution.py:540-1347).

Aggregation is the reference's: per-batch PSNR from the batch-mean MSE, then
a plain mean over batches; accuracy is an exact match after
``str_filt(., 'lower')``.  Batch i's outputs are read back only after batch
i+1 has been queued on the card, so host-side decoding overlaps device work.
With ``vis_dir`` the first batch is also saved as LR|SR|HR grids
(``utils.visualize``; reference interfaces/base.py:488-544).

In a process group of several ranks (tpgsr_tpu/train/evaluate.py:57-135)
every rank reads the whole batch, pads it to a multiple of the world by
its last row, runs the eval step on its contiguous slice and gathers the
per-sample outputs (the SR images only for the visualized batch); the
padded rows are dropped.  Every rank then decodes and scores the whole
batch, so each gets the metric dict of one process, and rank 0 alone
writes the visualizations.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Mapping

import numpy as np
import torch

from tpgsr_tpu_torch.charset import str_filt
from tpgsr_tpu_torch.ops.ctc import decode_crnn
from tpgsr_tpu_torch.parallel import gather_rows, local_rows, rank_and_world
from tpgsr_tpu_torch.train.step import EvalModels, EvalStep
from tpgsr_tpu_torch.utils import visualize


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def evaluate(eval_step: EvalStep, models: EvalModels, batches: Iterable[Mapping], max_batches: int = 0,
             vis_dir: str = "", n_vis: int = 10,
             decoder: Callable[[torch.Tensor], List[str]] = decode_crnn) -> Dict[str, float]:
    """Run ``eval_step`` over ``{"hr", "lr", "labels"}`` batches (numpy or a
    loader's tensors; other keys are ignored, and a short last batch counts
    its own rows, unpadded), the first ``max_batches`` only when it is
    above 0; returns the metric dict {accuracy, accuracy_lr, accuracy_hr,
    psnr_avg, ssim_avg, images, accuracy_stage<i>}.  ``decoder`` turns the
    recognizer's outputs into strings (``step.rec_decoder``; greedy CTC of a
    CRNN's logits by default).  With ``vis_dir`` the first batch's first
    ``n_vis`` samples go to ``./demo/<vis_dir>/1/`` and the ones SR fixed to
    ``./display/<vis_dir>/``."""
    models.eval()
    rank, world = rank_and_world()
    crnn = models.rec_kind == "CRNN"
    totals = {"c": 0, "c_lr": 0, "c_hr": 0, "n": 0}
    stage_correct: Dict[int, int] = {}
    psnr_batches, ssim_batches = [], []

    def process(bi, batch, sr, outs):
        labels = batch["labels"]
        mse = float(outs["mse"].mean())
        psnr_batches.append(20.0 * np.log10(255.0 / np.sqrt(max(mse, 1e-12))))
        ssim_batches.append(float(outs["ssim"].mean()))
        totals["n"] += len(labels)
        preds = {k: decoder(v) for k, v in outs.items() if k.startswith("logits_")}
        if vis_dir and bi == 0 and rank == 0:
            lr, sr, hr = _numpy(batch["lr"]), _numpy(sr), _numpy(batch["hr"])
            visualize.tripple_display(lr, sr, hr, preds["logits_lr"], preds["logits_sr"], labels, index=1,
                                      vis_dir=vis_dir, n_vis=n_vis)
            visualize.test_display(lr, sr, hr, preds["logits_lr"], preds["logits_sr"], labels, str_filt, vis_dir)
        for j, gt in enumerate(labels):
            gt_f = str_filt(gt, "lower")
            for key, name in (("c", "logits_sr"), ("c_lr", "logits_lr"), ("c_hr", "logits_hr")):
                totals[key] += int(str_filt(preds[name][j], "lower") == gt_f)
            for key, p in preds.items():
                if key.startswith("logits_stage"):
                    i = int(key[len("logits_stage"):])
                    stage_correct[i] = stage_correct.get(i, 0) + int(str_filt(p[j], "lower") == gt_f)

    pending = None
    for bi, batch in enumerate(batches):
        if max_batches and bi >= max_batches:
            break
        # this rank's slice; the per-sample outputs gathered along their
        # batch axis (1 for a CRNN's [T, B, C] logits, else 0)
        n = len(batch["labels"])
        sr, outs = eval_step(models, {k: local_rows(batch[k], rank, world) for k in ("hr", "lr")})
        outs = {k: gather_rows(v, n, 1 if crnn and k.startswith("logits_") else 0) for k, v in outs.items()}
        if vis_dir and bi == 0:
            sr = gather_rows(sr, n)
        if pending is not None:
            process(*pending)
        pending = (bi, batch, sr, outs)
    if pending is not None:
        process(*pending)

    n = max(totals["n"], 1)
    metrics = {
        "accuracy": totals["c"] / n,
        "accuracy_lr": totals["c_lr"] / n,
        "accuracy_hr": totals["c_hr"] / n,
        "psnr_avg": float(np.mean(psnr_batches)) if psnr_batches else 0.0,
        "ssim_avg": float(np.mean(ssim_batches)) if ssim_batches else 0.0,
        "images": totals["n"],
    }
    for i, c in stage_correct.items():
        metrics[f"accuracy_stage{i}"] = c / n
    return metrics

