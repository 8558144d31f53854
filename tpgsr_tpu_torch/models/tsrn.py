"""TSRN_TL, the text-prior-guided SR backbone (counterpart of
tpgsr_tpu/models/tsrn.py:42-226; reference model/tsrn.py:81-215).

NCHW, with the reference's keys: ``block1.{0,1}``, ``block{2..srb+1}.*``,
``infoGen.*``, ``block{srb+2}.{0,1}``, ``block{srb+3}.{j}.conv`` and the final
``block{srb+3}.{ups}`` conv.  The head is the original form (upsample conv,
PixelShuffle, mish, 9x9 conv at HR), which equals the JAX package's fused
5x5 LR head exactly.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpgsr_tpu_torch.models.layers import GruBlock, UpsampleBlock, mish
from tpgsr_tpu_torch.models.stn import STNHead, TPSSpatialTransformer
from tpgsr_tpu_torch.ops.resize import interpolate_bilinear


class RecurrentResidualBlockTL(nn.Module):
    """conv-BN-mish-conv-BN, concatenate the prior map, BiGRU over H (the
    H/W transpose around ``gru1``), then BiGRU over W on x + residual
    (reference model/tsrn.py:397-426)."""

    def __init__(self, channels: int, text_channels: int):
        super().__init__()
        self.conv1 = nn.Conv2d(channels, channels, 3, padding=1)
        self.bn1 = nn.BatchNorm2d(channels)
        self.gru1 = GruBlock(channels + text_channels, channels)
        self.conv2 = nn.Conv2d(channels, channels, 3, padding=1)
        self.bn2 = nn.BatchNorm2d(channels)
        self.gru2 = GruBlock(channels, channels)

    def forward(self, x: torch.Tensor, text_emb: torch.Tensor) -> torch.Tensor:
        residual = mish(self.bn1(self.conv1(x)))
        residual = self.bn2(self.conv2(residual))
        cat = torch.cat([residual, text_emb], 1)
        residual = self.gru1(cat.transpose(-1, -2)).transpose(-1, -2)
        return self.gru2(x + residual)


class InfoGen(nn.Module):
    """Lift the [B, t_emb, 1, T] prior to a [B, output_size, 1, 8T-5] map with
    4 ConvTranspose-BN-ReLU stages (paddings as tpgsr_tpu/models/tsrn.py:93-103)."""

    def __init__(self, t_emb: int, output_size: int):
        super().__init__()
        self.tconv1 = nn.ConvTranspose2d(t_emb, 512, 3, 2, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(512)
        self.tconv2 = nn.ConvTranspose2d(512, 128, 3, 2, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(128)
        self.tconv3 = nn.ConvTranspose2d(128, 64, 3, 2, padding=1, bias=False)
        self.bn3 = nn.BatchNorm2d(64)
        self.tconv4 = nn.ConvTranspose2d(64, output_size, 3, (2, 1), padding=(1, 0), bias=False)
        self.bn4 = nn.BatchNorm2d(output_size)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.tconv1(t)))
        x = F.relu(self.bn2(self.tconv2(x)))
        x = F.relu(self.bn3(self.tconv3(x)))
        return F.relu(self.bn4(self.tconv4(x)))


class TSRN_TL(nn.Module):
    """TSRN with text-prior fusion (archs tsrn_tl / tsrn_tl_cascade).

    With ``stn=True`` the STN head and the TPS transformer rectify the input
    in train mode, at (height, width) / scale, before ``block1``; eval skips
    them (tpgsr_tpu/models/tsrn.py:179-184)."""

    def __init__(self, scale_factor: int = 2, width: int = 128, height: int = 32, stn: bool = False,
                 srb_nums: int = 5, mask: bool = True, hidden_units: int = 32, text_emb: int = 37,
                 out_text_channels: int = 32):
        super().__init__()
        if srb_nums > 5:
            # the reference fuses the prior in blocks 2..6 only; plain SRBs
            # beyond them come with the TSRN port
            raise NotImplementedError("TSRN_TL with more than 5 SRBs")
        self.in_planes = 4 if mask else 3
        self.stn = stn
        self.srb_nums = srb_nums
        self.text_emb = text_emb
        ch = 2 * hidden_units
        self.block1 = nn.Sequential(nn.Conv2d(self.in_planes, ch, 9, padding=4), nn.PReLU())
        for i in range(srb_nums):
            setattr(self, f"block{i + 2}", RecurrentResidualBlockTL(ch, out_text_channels))
        self.infoGen = InfoGen(text_emb, out_text_channels)
        setattr(self, f"block{srb_nums + 2}", nn.Sequential(nn.Conv2d(ch, ch, 3, padding=1), nn.BatchNorm2d(ch)))
        head = [UpsampleBlock(ch, 2) for _ in range(int(math.log2(scale_factor)))]
        head.append(nn.Conv2d(ch, self.in_planes, 9, padding=4))
        setattr(self, f"block{srb_nums + 3}", nn.Sequential(*head))
        if stn:
            lr_size = (height // scale_factor, width // scale_factor)
            self.tps = TPSSpatialTransformer(lr_size)
            self.stn_head = STNHead(self.in_planes, input_size=lr_size)

    def forward(self, x: torch.Tensor, text_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, in_planes, h, w], text_emb [B, 37, 1, T] -> [B, in_planes, 2h, 2w]."""
        if self.stn and self.training:
            _, ctrl = self.stn_head(x)
            x, _ = self.tps(x, ctrl)
        block1 = self.block1(x)
        if text_emb is None:
            text_emb = x.new_zeros(x.shape[0], self.text_emb, 1, 26)
        spatial = interpolate_bilinear(self.infoGen(text_emb), (x.shape[2], x.shape[3]), align_corners=True)
        b = block1
        for i in range(self.srb_nums):
            b = getattr(self, f"block{i + 2}")(b, spatial)
        b = getattr(self, f"block{self.srb_nums + 2}")(b)
        return torch.tanh(getattr(self, f"block{self.srb_nums + 3}")(block1 + b))
