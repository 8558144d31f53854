"""SRResNet and SRResNet_TL (counterpart of tpgsr_tpu/models/srresnet.py:23-130;
reference model/srresnet.py:13-235).

A 9x9 conv with PReLU, 5 residual blocks (conv-BN-PReLU-conv-BN), conv-BN
with the skip from ``block1``, PixelShuffle upsampling with PReLU, a 9x9
conv and tanh.  SRResNet_TL concatenates the prior map between the two
convolutions of each residual block.  With ``stn=True`` the STN and TPS
rectify the input in train mode, at the LR size.  Keys: ``block1.{0,1}``,
``block{2..6}.{conv1,bn1,prelu,conv2,bn2}``, ``block7.{0,1}``,
``block8.{j}.{conv,prelu}`` and the final ``block8.{ups}`` conv,
``infoGen.*`` (SRResNet_TL) and ``stn_head.*``.  The SRGAN discriminator
(tpgsr_tpu/models/srresnet.py:133) is on no path the port runs.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpgsr_tpu_torch.models.prior import NP_PADDINGS, InfoGenP
from tpgsr_tpu_torch.models.stn import STNHead, TPSSpatialTransformer
from tpgsr_tpu_torch.ops.resize import interpolate_bilinear


class ResidualBlock(nn.Module):
    """x + BN(conv(PReLU(BN(conv(x))))); with ``text_channels`` the prior map
    joins the second conv's input."""

    def __init__(self, channels: int, text_channels: int = 0):
        super().__init__()
        self.conv1 = nn.Conv2d(channels, channels, 3, padding=1)
        self.bn1 = nn.BatchNorm2d(channels)
        self.prelu = nn.PReLU()
        self.conv2 = nn.Conv2d(channels + text_channels, channels, 3, padding=1)
        self.bn2 = nn.BatchNorm2d(channels)

    def forward(self, x: torch.Tensor, text_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        r = self.prelu(self.bn1(self.conv1(x)))
        if text_emb is not None:
            r = torch.cat([r, text_emb], 1)
        return x + self.bn2(self.conv2(r))


class ResidualBlockTL(ResidualBlock):
    """The residual block that takes the prior map."""

    def __init__(self, channels: int, out_text_channels: int = 32):
        super().__init__(channels, out_text_channels)


class _UpsamplePReLU(nn.Module):
    """conv -> PixelShuffle -> PReLU (reference ``UpsampleBLock``)."""

    def __init__(self, in_channels: int, up_scale: int = 2):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, in_channels * up_scale**2, 3, padding=1)
        self.prelu = nn.PReLU()
        self.up_scale = up_scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.prelu(F.pixel_shuffle(self.conv(x), self.up_scale))


class SRResNet(nn.Module):
    """Arch srres: 4 channels in and out with ``mask``, else 3."""

    def __init__(self, scale_factor: int = 2, stn: bool = False, width: int = 128, height: int = 32,
                 mask: bool = False, out_text_channels: int = 0):
        super().__init__()
        self.in_planes = 4 if mask else 3
        self.stn = stn
        self.block1 = nn.Sequential(nn.Conv2d(self.in_planes, 64, 9, padding=4), nn.PReLU())
        for i in range(2, 7):
            setattr(self, f"block{i}", ResidualBlockTL(64, out_text_channels) if out_text_channels else ResidualBlock(64))
        self.block7 = nn.Sequential(nn.Conv2d(64, 64, 3, padding=1), nn.BatchNorm2d(64))
        head = [_UpsamplePReLU(64, 2) for _ in range(int(math.log2(scale_factor)))]
        head.append(nn.Conv2d(64, self.in_planes, 9, padding=4))
        self.block8 = nn.Sequential(*head)
        if stn:
            lr_size = (height // scale_factor, width // scale_factor)
            self.tps = TPSSpatialTransformer(lr_size)
            self.stn_head = STNHead(self.in_planes, input_size=lr_size)

    def _rectify(self, x: torch.Tensor) -> torch.Tensor:
        if self.stn and self.training:
            x, _ = self.tps(x, self.stn_head(x)[1])
        return x

    def _trunk(self, x: torch.Tensor, t: Optional[torch.Tensor] = None) -> torch.Tensor:
        b1 = self.block1(x)
        b = b1
        for i in range(2, 7):
            b = getattr(self, f"block{i}")(b, t)
        return torch.tanh(self.block8(b1 + self.block7(b)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, in_planes, h, w] -> [B, in_planes, 2h, 2w]."""
        return self._trunk(self._rectify(x))


class SRResNet_TL(SRResNet):
    """Arch srresnet_tl."""

    def __init__(self, scale_factor: int = 2, stn: bool = False, width: int = 128, height: int = 32,
                 mask: bool = False, text_emb: int = 37, out_text_channels: int = 32):
        super().__init__(scale_factor, stn, width, height, mask, out_text_channels)
        self.text_emb = text_emb
        self.infoGen = InfoGenP(text_emb, out_text_channels, NP_PADDINGS)

    def forward(self, x: torch.Tensor, text_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, in_planes, h, w], text_emb [B, 37, 1, T] -> [B, in_planes, 2h, 2w]."""
        x = self._rectify(x)
        if text_emb is None:
            text_emb = x.new_zeros(x.shape[0], self.text_emb, 1, 26)
        t = interpolate_bilinear(self.infoGen(text_emb), (x.shape[2], x.shape[3]), align_corners=True)
        return self._trunk(x, t)
