"""Running-average meter (counterpart of tpgsr_tpu/utils/meters.py;
reference utils/meters.py:4-23)."""

from __future__ import annotations


class AverageMeter:
    """The last value, and the sum, count and mean of the values seen."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count
