"""The bicubic x2 baseline (counterpart of tpgsr_tpu/models/bicubic.py;
reference model/bicubic.py:6-13): ``F.interpolate(mode='bicubic',
align_corners=True)``, no parameters."""

from __future__ import annotations

import torch
import torch.nn as nn

from tpgsr_tpu_torch.ops.resize import interpolate_bicubic


class BICUBIC(nn.Module):
    """Arch bicubic: any number of channels in and out."""

    def __init__(self, scale_factor: int = 2):
        super().__init__()
        self.scale_factor = scale_factor

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, C, h, w] -> [B, C, 2h, 2w]."""
        s = self.scale_factor
        return interpolate_bicubic(x, (x.shape[2] * s, x.shape[3] * s), align_corners=True)
