"""Scalar log: ``scalars.jsonl`` always, TensorBoard events when
``torch.utils.tensorboard`` imports (counterpart of
tpgsr_tpu/train/logging.py; reference tensorboardX use at
interfaces/super_resolution.py:96-103).

The event dir is ``tensorboard/<vis_dir>``, cleared on a fresh run and
appended to on a continuation; the tags are ``loss/{total,SR,distill}`` and
``eval/{psnr_avg,ssim_avg,accuracy}_<split>``.  In a data-parallel run
rank 0 alone writes (every rank logs the same global metrics;
tpgsr_tpu/train/logging.py:26-30); the others' loggers write nothing.
"""

from __future__ import annotations

import json
import os
import shutil
import time

from tpgsr_tpu_torch.parallel import is_primary


class ScalarLogger:
    def __init__(self, log_dir: str, clear: bool = True):
        self._jsonl = self._tb = None
        if not is_primary():
            return
        if clear and os.path.isdir(log_dir):
            shutil.rmtree(log_dir)  # super_resolution.py:98-101
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:  # the tensorboard package is optional
            self._tb = None
        else:
            self._tb = SummaryWriter(log_dir)

    def add_scalar(self, tag: str, value: float, global_step: int) -> None:
        if self._jsonl is None:
            return
        self._jsonl.write(json.dumps({"t": time.time(), "tag": tag, "value": float(value),
                                      "step": int(global_step)}) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), global_step=global_step)

    def close(self) -> None:
        if self._jsonl is None:
            return
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
