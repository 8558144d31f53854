"""RRDBNet and RRDBNet_TL, the ESRGAN generator (counterpart of
tpgsr_tpu/models/rrdb.py; reference model/esrgan.py:16-90, model/rrdb.py).

A conv, 23 residual-in-residual dense blocks (three 5-conv dense blocks of
growth ``gc``, each scaled by 0.2, and the RRDB scaled by 0.2), a trunk conv
with the skip, nearest x2 upsampling convs, ``HRconv`` and ``conv_last``;
LeakyReLU(0.2) throughout, convs with bias.  RRDBNet_TL lifts the prior with
the TSRN-padding ``InfoGen``, resizes it bilinearly (``align_corners``) to
the LR map, and concatenates it before every dense block's ``conv5``, whose
output it scales by 0.166.  Keys: ``conv_first``,
``RRDB_trunk.{i}.RDB{k}.conv{c}``, ``trunk_conv``, ``upconv{j}``, ``HRconv``,
``conv_last`` and ``infoGen.*`` (RRDBNet_TL).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpgsr_tpu_torch.models.srcnn import upsample_nearest
from tpgsr_tpu_torch.models.tsrn import InfoGen
from tpgsr_tpu_torch.ops.resize import interpolate_bilinear


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


def _conv(c_in: int, c_out: int) -> nn.Conv2d:
    return nn.Conv2d(c_in, c_out, 3, padding=1)


class ResidualDenseBlock5C(nn.Module):
    """Five convs over the growing concatenation; with ``text_channels`` the
    prior map joins ``conv5``'s input and the block scales by 0.166, not 0.2."""

    def __init__(self, nf: int = 64, gc: int = 32, text_channels: int = 0):
        super().__init__()
        for c in range(1, 5):
            setattr(self, f"conv{c}", _conv(nf + (c - 1) * gc, gc))
        self.conv5 = _conv(nf + 4 * gc + text_channels, nf)
        self.scale = 0.166 if text_channels else 0.2

    def forward(self, x: torch.Tensor, text_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        feats = [x]
        for c in range(1, 5):
            feats.append(_lrelu(getattr(self, f"conv{c}")(torch.cat(feats, 1))))
        if text_emb is not None:
            feats.append(text_emb)
        return self.conv5(torch.cat(feats, 1)) * self.scale + x


class RRDB(nn.Module):
    def __init__(self, nf: int = 64, gc: int = 32, text_channels: int = 0):
        super().__init__()
        self.RDB1 = ResidualDenseBlock5C(nf, gc, text_channels)
        self.RDB2 = ResidualDenseBlock5C(nf, gc, text_channels)
        self.RDB3 = ResidualDenseBlock5C(nf, gc, text_channels)

    def forward(self, x: torch.Tensor, text_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        out = self.RDB3(self.RDB2(self.RDB1(x, text_emb), text_emb), text_emb)
        return out * 0.2 + x


class RRDBNet(nn.Module):
    """Arch esrgan: ``in_nc`` channels in, ``out_nc`` out."""

    def __init__(self, scale_factor: int = 2, in_nc: int = 3, out_nc: int = 3, nf: int = 64, nb: int = 23,
                 gc: int = 32, text_channels: int = 0):
        super().__init__()
        self.ups = int(math.log2(scale_factor))
        self.conv_first = _conv(in_nc, nf)
        self.RRDB_trunk = nn.ModuleList(RRDB(nf, gc, text_channels) for _ in range(nb))
        self.trunk_conv = _conv(nf, nf)
        for j in range(1, self.ups + 1):
            setattr(self, f"upconv{j}", _conv(nf, nf))
        self.HRconv = _conv(nf, nf)
        self.conv_last = _conv(nf, out_nc)

    def _trunk(self, x: torch.Tensor, t: Optional[torch.Tensor] = None) -> torch.Tensor:
        fea = self.conv_first(x)
        trunk = fea
        for block in self.RRDB_trunk:
            trunk = block(trunk, t)
        fea = fea + self.trunk_conv(trunk)
        for j in range(1, self.ups + 1):
            fea = _lrelu(getattr(self, f"upconv{j}")(upsample_nearest(fea, 2)))
        return self.conv_last(_lrelu(self.HRconv(fea)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, in_nc, h, w] -> [B, out_nc, 2h, 2w]."""
        return self._trunk(x)


class RRDBNet_TL(RRDBNet):
    """Arch esrgan_tl."""

    def __init__(self, scale_factor: int = 2, in_nc: int = 3, out_nc: int = 3, nf: int = 64, nb: int = 23,
                 gc: int = 32, text_emb: int = 37, out_text_channels: int = 32):
        super().__init__(scale_factor, in_nc, out_nc, nf, nb, gc, text_channels=out_text_channels)
        self.text_emb = text_emb
        self.infoGen = InfoGen(text_emb, out_text_channels)

    def forward(self, x: torch.Tensor, text_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, in_nc, h, w], text_emb [B, 37, 1, T] -> [B, out_nc, 2h, 2w]."""
        if text_emb is None:
            text_emb = x.new_zeros(x.shape[0], self.text_emb, 1, 26)
        t = interpolate_bilinear(self.infoGen(text_emb), (x.shape[2], x.shape[3]), align_corners=True)
        return self._trunk(x, t)
