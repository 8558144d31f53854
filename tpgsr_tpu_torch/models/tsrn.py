"""TSRN and TSRN_TL, the recurrent SR backbones (counterpart of
tpgsr_tpu/models/tsrn.py:42-226; reference model/tsrn.py:18-215).

NCHW, with the reference's keys: ``block1.{0,1}``, ``block{2..srb+1}.*``,
``infoGen.*`` (TSRN_TL), ``block{srb+2}.{0,1}``, ``block{srb+3}.{j}.conv``
and the final ``block{srb+3}.{ups}`` conv.  The head is the original form
(upsample conv, PixelShuffle, mish, 9x9 conv at HR), which equals the JAX
package's fused 5x5 LR head exactly.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn as nn

from tpgsr_tpu_torch.models.layers import GruBlock, UpsampleBlock, mish
from tpgsr_tpu_torch.models.prior import TSRN_PADDINGS, InfoGenP
from tpgsr_tpu_torch.models.stn import STNHead, TPSSpatialTransformer
from tpgsr_tpu_torch.ops.resize import interpolate_bilinear


class RecurrentResidualBlock(nn.Module):
    """conv-BN-mish-conv-BN, BiGRU over H on the residual (the H/W transpose
    around ``gru1``), then BiGRU over W on x + residual (reference
    model/tsrn.py:373-394).  With ``text_channels`` the prior map is
    concatenated to the residual before ``gru1`` (model/tsrn.py:397-426)."""

    def __init__(self, channels: int, text_channels: int = 0):
        super().__init__()
        self.conv1 = nn.Conv2d(channels, channels, 3, padding=1)
        self.bn1 = nn.BatchNorm2d(channels)
        self.gru1 = GruBlock(channels + text_channels, channels)
        self.conv2 = nn.Conv2d(channels, channels, 3, padding=1)
        self.bn2 = nn.BatchNorm2d(channels)
        self.gru2 = GruBlock(channels, channels)

    def forward(self, x: torch.Tensor, text_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        residual = mish(self.bn1(self.conv1(x)))
        residual = self.bn2(self.conv2(residual))
        if text_emb is not None:
            residual = torch.cat([residual, text_emb], 1)
        residual = self.gru1(residual.transpose(-1, -2)).transpose(-1, -2)
        return self.gru2(x + residual)


class RecurrentResidualBlockTL(RecurrentResidualBlock):
    """The recurrent block that takes the prior map."""

    def __init__(self, channels: int, text_channels: int):
        super().__init__(channels, text_channels)


# the reference's InfoGen of TSRN (model/tsrn.py:81-108)
InfoGen = functools.partial(InfoGenP, paddings=TSRN_PADDINGS)
# TSRN_TL fuses the prior in SRBs 2..6 only; plain SRBs follow
# (tpgsr_tpu/models/tsrn.py:199-207)
TL_BLOCKS = 5


class TSRN(nn.Module):
    """Baseline TSRN (arch tsrn): ``srb_nums`` plain recurrent blocks.

    With ``stn=True`` the STN head and the TPS transformer rectify the input
    in train mode, at (height, width) / scale, before ``block1``; eval skips
    them (tpgsr_tpu/models/tsrn.py:126-131)."""

    def __init__(self, scale_factor: int = 2, width: int = 128, height: int = 32, stn: bool = False,
                 srb_nums: int = 5, mask: bool = True, hidden_units: int = 32):
        super().__init__()
        self._build(scale_factor, width, height, stn, srb_nums, mask, hidden_units)

    def _build(self, scale_factor, width, height, stn, srb_nums, mask, hidden_units, text_emb=0,
               out_text_channels=0):
        """Register the trunk in the reference's order; with ``text_emb`` the
        first ``TL_BLOCKS`` SRBs take the prior and ``infoGen`` follows the
        SRBs."""
        self.in_planes = 4 if mask else 3
        self.stn = stn
        self.srb_nums = srb_nums
        ch = 2 * hidden_units
        self.block1 = nn.Sequential(nn.Conv2d(self.in_planes, ch, 9, padding=4), nn.PReLU())
        for i in range(srb_nums):
            block = (RecurrentResidualBlockTL(ch, out_text_channels) if text_emb and i < TL_BLOCKS
                     else RecurrentResidualBlock(ch))
            setattr(self, f"block{i + 2}", block)
        if text_emb:
            self.infoGen = InfoGenP(text_emb, out_text_channels, TSRN_PADDINGS)
        setattr(self, f"block{srb_nums + 2}", nn.Sequential(nn.Conv2d(ch, ch, 3, padding=1), nn.BatchNorm2d(ch)))
        head = [UpsampleBlock(ch, 2) for _ in range(int(math.log2(scale_factor)))]
        head.append(nn.Conv2d(ch, self.in_planes, 9, padding=4))
        setattr(self, f"block{srb_nums + 3}", nn.Sequential(*head))
        if stn:
            lr_size = (height // scale_factor, width // scale_factor)
            self.tps = TPSSpatialTransformer(lr_size)
            self.stn_head = STNHead(self.in_planes, input_size=lr_size)

    def _rectify(self, x: torch.Tensor) -> torch.Tensor:
        if self.stn and self.training:
            x, _ = self.tps(x, self.stn_head(x)[1])
        return x

    def _trunk(self, x: torch.Tensor, spatial: Optional[torch.Tensor] = None) -> torch.Tensor:
        block1 = self.block1(x)
        b = block1
        for i in range(self.srb_nums):
            block = getattr(self, f"block{i + 2}")
            b = block(b, spatial) if isinstance(block, RecurrentResidualBlockTL) else block(b)
        b = getattr(self, f"block{self.srb_nums + 2}")(b)
        return torch.tanh(getattr(self, f"block{self.srb_nums + 3}")(block1 + b))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, in_planes, h, w] -> [B, in_planes, 2h, 2w]."""
        return self._trunk(self._rectify(x))


class TSRN_TL(TSRN):
    """TSRN with text-prior fusion (archs tsrn_tl / tsrn_tl_cascade): SRBs
    2..6 concatenate the prior map, any beyond them are plain."""

    def __init__(self, scale_factor: int = 2, width: int = 128, height: int = 32, stn: bool = False,
                 srb_nums: int = 5, mask: bool = True, hidden_units: int = 32, text_emb: int = 37,
                 out_text_channels: int = 32):
        nn.Module.__init__(self)
        self.text_emb = text_emb
        self._build(scale_factor, width, height, stn, srb_nums, mask, hidden_units, text_emb, out_text_channels)

    def forward(self, x: torch.Tensor, text_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, in_planes, h, w], text_emb [B, 37, 1, T] -> [B, in_planes, 2h, 2w]."""
        x = self._rectify(x)
        if text_emb is None:
            text_emb = x.new_zeros(x.shape[0], self.text_emb, 1, 26)
        spatial = interpolate_bilinear(self.infoGen(text_emb), (x.shape[2], x.shape[3]), align_corners=True)
        return self._trunk(x, spatial)
