"""LapSRN (counterpart of tpgsr_tpu/models/lapsrn.py; reference
model/lapsrn.py:57-137).

One level of the Laplacian pyramid a factor of 2: a feature branch of 10
bias-free MSRA 3x3 conv-LeakyReLU(0.2) layers and a bilinear x2 deconv with
LeakyReLU (``convt_F``), an image branch that deconvolves the input
(``convt_I``), and a conv that turns the features into the residual
(``convt_R``); level 2 (scale 4) repeats it on level 1's output.  With
``stn=True`` the STN head and the TPS rectify the input in train mode only,
at the LR size.  Keys: ``conv_input``, ``convt_F{s}.0.cov_block.{2i}`` (the
deconv at ``.20``), ``convt_I{s}``, ``convt_R{s}`` and ``stn_head.*``
(tpgsr_tpu/interop/torch_import.py:512).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpgsr_tpu_torch.models.layers import BilinearConvTranspose2d, MSRAConv2d
from tpgsr_tpu_torch.models.stn import STNHead, TPSSpatialTransformer


class _ConvBlock(nn.Module):
    """The original's ``_Conv_Block``: ``cov_block`` = 10 x (conv, LeakyReLU),
    the deconv and a LeakyReLU."""

    def __init__(self):
        super().__init__()
        layers = []
        for _ in range(10):
            layers += [MSRAConv2d(64, 64), nn.LeakyReLU(0.2)]
        layers += [BilinearConvTranspose2d(64, 64), nn.LeakyReLU(0.2)]
        self.cov_block = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cov_block(x)


class LapSRN(nn.Module):
    """Arch lapsrn: ``in_planes`` channels in and out."""

    def __init__(self, scale_factor: int = 2, in_planes: int = 3, stn: bool = False, width: int = 128,
                 height: int = 32):
        super().__init__()
        self.stn = stn
        self.levels = int(math.log2(scale_factor))
        self.conv_input = MSRAConv2d(in_planes, 64)
        for s in range(1, self.levels + 1):
            setattr(self, f"convt_F{s}", nn.Sequential(_ConvBlock()))
            setattr(self, f"convt_I{s}", BilinearConvTranspose2d(in_planes, in_planes))
            setattr(self, f"convt_R{s}", MSRAConv2d(64, in_planes))
        if stn:
            lr_size = (height // scale_factor, width // scale_factor)
            self.tps = TPSSpatialTransformer(lr_size)
            self.stn_head = STNHead(in_planes, input_size=lr_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, in_planes, h, w] -> [B, in_planes, 2h, 2w]."""
        if self.stn and self.training:
            x, _ = self.tps(x, self.stn_head(x)[1])
        features = F.leaky_relu(self.conv_input(x), 0.2)
        for s in range(1, self.levels + 1):
            features = getattr(self, f"convt_F{s}")(features)
            x = getattr(self, f"convt_I{s}")(x) + getattr(self, f"convt_R{s}")(features)
        return x
