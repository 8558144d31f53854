"""SRCNN and SRCNN_TL (counterpart of tpgsr_tpu/models/srcnn.py; reference
model/srcnn.py:50-146).

Pre-upsample design: the LR input is nearest-upsampled x2, or rectified by
the STN and TPS straight to the HR size, before 3 convolutions; SRCNN_TL
concatenates the spatial prior map before every convolution.  Keys:
``conv{1,2,3}``, ``infoGen.*`` (SRCNN_TL) and ``stn_head.*``.

The STN here runs in eval too, and its TPS output is the HR size
(tpgsr_tpu/models/srcnn.py:37-42), unlike TSRN's, which runs in train mode
only, at the LR size.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpgsr_tpu_torch.models.prior import NP_PADDINGS, InfoGenP
from tpgsr_tpu_torch.models.stn import STNHead, TPSSpatialTransformer
from tpgsr_tpu_torch.ops.resize import interpolate_bilinear


def upsample_nearest(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Each pixel repeated ``factor`` x ``factor`` times (NCHW), the JAX
    package's ``jnp.repeat`` pair exactly."""
    return F.interpolate(x, scale_factor=factor, mode="nearest")


class SRCNN(nn.Module):
    """Arch srcnn: ``in_planes`` channels in and out, no output activation."""

    def __init__(self, scale_factor: int = 2, in_planes: int = 3, stn: bool = False, height: int = 32,
                 width: int = 128, text_channels: int = 0):
        super().__init__()
        self.scale_factor = scale_factor
        self.stn = stn
        self.conv1 = nn.Conv2d(in_planes + text_channels, 64, 9, padding=4)
        self.conv2 = nn.Conv2d(64 + text_channels, 32, 1)
        self.conv3 = nn.Conv2d(32 + text_channels, in_planes, 5, padding=2)
        if stn:
            self.tps = TPSSpatialTransformer((height, width))
            self.stn_head = STNHead(in_planes, input_size=(height // scale_factor, width // scale_factor))

    def _upsample(self, x: torch.Tensor) -> torch.Tensor:
        if self.stn:
            x, _ = self.tps(x, self.stn_head(x)[1])
            return x
        return upsample_nearest(x, self.scale_factor)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, in_planes, h, w] -> [B, in_planes, 2h, 2w]."""
        x = F.relu(self.conv1(self._upsample(x)))
        return self.conv3(F.relu(self.conv2(x)))


class SRCNN_TL(SRCNN):
    """Arch srcnn_tl: the prior map joins the input of every convolution."""

    def __init__(self, scale_factor: int = 2, in_planes: int = 4, stn: bool = False, height: int = 32,
                 width: int = 128, text_emb: int = 37, out_text_channels: int = 32):
        super().__init__(scale_factor, in_planes, stn, height, width, text_channels=out_text_channels)
        self.text_emb = text_emb
        self.infoGen = InfoGenP(text_emb, out_text_channels, NP_PADDINGS)

    def forward(self, x: torch.Tensor, text_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, in_planes, h, w], text_emb [B, 37, 1, T] -> [B, in_planes, 2h, 2w]."""
        x = self._upsample(x)
        if text_emb is None:
            text_emb = x.new_zeros(x.shape[0], self.text_emb, 1, 26)
        t = interpolate_bilinear(self.infoGen(text_emb), (x.shape[2], x.shape[3]), align_corners=True)
        out = F.relu(self.conv1(torch.cat([x, t], 1)))
        out = F.relu(self.conv2(torch.cat([out, t], 1)))
        return self.conv3(torch.cat([out, t], 1))
