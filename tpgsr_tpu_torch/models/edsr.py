"""EDSR (counterpart of tpgsr_tpu/models/edsr.py; reference model/edsr.py:35-90).

A 256-channel trunk of 32 residual blocks (conv-ReLU-conv, scaled by 0.1),
a conv and the skip from the first conv, a PixelShuffle head and a conv to
RGB; every conv a bias-free MSRA 3x3.  The original's frozen MeanShift
convs (an identity kernel with a -/+ ``RGB_MEAN`` bias) are plain
arithmetic here, as in the JAX package, and are not in the state_dict.
Keys: ``conv_input``, ``residual.{i}.conv{1,2}``, ``conv_mid``,
``upscale.{2j}`` and ``conv_output`` (tpgsr_tpu/interop/torch_import.py:492).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpgsr_tpu_torch.models.layers import MSRAConv2d

RGB_MEAN = (0.4488, 0.4371, 0.4040)


class _ResBlock(nn.Module):
    def __init__(self, channels: int = 256):
        super().__init__()
        self.conv1 = MSRAConv2d(channels, channels)
        self.conv2 = MSRAConv2d(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(F.relu(self.conv1(x))) * 0.1 + x


class EDSR(nn.Module):
    """Arch edsr: RGB in and out."""

    def __init__(self, scale_factor: int = 2, n_resblocks: int = 32):
        super().__init__()
        self.conv_input = MSRAConv2d(3, 256)
        self.residual = nn.Sequential(*(_ResBlock(256) for _ in range(n_resblocks)))
        self.conv_mid = MSRAConv2d(256, 256)
        up = []
        for _ in range(int(math.log2(scale_factor))):
            up += [MSRAConv2d(256, 256 * 4), nn.PixelShuffle(2)]
        self.upscale = nn.Sequential(*up)
        self.conv_output = MSRAConv2d(256, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, 3, h, w] -> [B, 3, 2h, 2w]."""
        mean = torch.tensor(RGB_MEAN, dtype=x.dtype, device=x.device).view(1, 3, 1, 1)
        out = self.conv_input(x - mean)
        out = self.conv_mid(self.residual(out)) + out
        return self.conv_output(self.upscale(out)) + mean
