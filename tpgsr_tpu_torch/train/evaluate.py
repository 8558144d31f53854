"""Validation loop: PSNR, SSIM and word accuracy over batches (counterpart
of tpgsr_tpu/train/evaluate.py:24-206; reference TextSR.eval,
interfaces/super_resolution.py:540-1347).

Aggregation is the reference's: per-batch PSNR from the batch-mean MSE, then
a plain mean over batches; accuracy is an exact match after
``str_filt(., 'lower')``.  Batch i's outputs are read back only after batch
i+1 has been queued on the card, so host-side decoding overlaps device work.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping

import numpy as np

from tpgsr_tpu_torch.charset import str_filt
from tpgsr_tpu_torch.ops.ctc import decode_crnn
from tpgsr_tpu_torch.train.step import EvalModels, EvalStep


def evaluate(eval_step: EvalStep, models: EvalModels, batches: Iterable[Mapping]) -> Dict[str, float]:
    """Run ``eval_step`` over ``{"hr", "lr", "labels"}`` batches (numpy or a
    loader's tensors; other keys are ignored, and a short last batch counts
    its own rows, unpadded); returns the metric dict {accuracy, accuracy_lr,
    accuracy_hr, psnr_avg, ssim_avg, images, accuracy_stage<i>}."""
    models.eval()
    totals = {"c": 0, "c_lr": 0, "c_hr": 0, "n": 0}
    stage_correct: Dict[int, int] = {}
    psnr_batches, ssim_batches = [], []

    def process(labels, outs):
        mse = float(outs["mse"].mean())
        psnr_batches.append(20.0 * np.log10(255.0 / np.sqrt(max(mse, 1e-12))))
        ssim_batches.append(float(outs["ssim"].mean()))
        totals["n"] += len(labels)
        preds = {k: decode_crnn(v) for k, v in outs.items() if k.startswith("logits_")}
        for j, gt in enumerate(labels):
            gt_f = str_filt(gt, "lower")
            for key, name in (("c", "logits_sr"), ("c_lr", "logits_lr"), ("c_hr", "logits_hr")):
                totals[key] += int(str_filt(preds[name][j], "lower") == gt_f)
            for key, p in preds.items():
                if key.startswith("logits_stage"):
                    i = int(key[len("logits_stage"):])
                    stage_correct[i] = stage_correct.get(i, 0) + int(str_filt(p[j], "lower") == gt_f)

    pending = None
    for batch in batches:
        _, outs = eval_step(models, batch)
        if pending is not None:
            process(*pending)
        pending = (batch["labels"], outs)
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
