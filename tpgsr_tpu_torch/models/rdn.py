"""RDN and RDN_TL (counterpart of tpgsr_tpu/models/rdn.py; reference
model/rdn.py:54-214).

Residual Dense Network: two 3x3 convs, 3 residual dense blocks (6 dense
layers each, growth 32, no biases), global feature fusion (1x1 then 3x3),
a conv and PixelShuffle up, and a 3x3 conv out; no output activation.
RDN takes 3 channels; RDN_TL takes 4 and concatenates the prior map before
each block's 1x1 fusion.  Keys: ``conv1``, ``conv2``,
``RDB{k}.dense_layers.{i}.conv``, ``RDB{k}.conv_1x1``, ``GFF_1x1``,
``GFF_3x3``, ``conv_up``, ``conv3`` and ``infoGen.*`` (RDN_TL).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpgsr_tpu_torch.models.prior import NP_PADDINGS, InfoGenP
from tpgsr_tpu_torch.ops.resize import interpolate_bilinear


class _DenseLayer(nn.Module):
    """[x, relu(conv3x3(x))] along the channels."""

    def __init__(self, in_channels: int, growth: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, growth, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([x, F.relu(self.conv(x))], 1)


class RDB(nn.Module):
    """``n_dense`` dense layers, the prior map appended when given, a 1x1
    fusion back to ``n_channels`` and the skip."""

    def __init__(self, n_channels: int, n_dense: int = 6, growth: int = 32, text_channels: int = 0):
        super().__init__()
        self.dense_layers = nn.Sequential(*(_DenseLayer(n_channels + i * growth, growth) for i in range(n_dense)))
        self.conv_1x1 = nn.Conv2d(n_channels + n_dense * growth + text_channels, n_channels, 1, bias=False)

    def forward(self, x: torch.Tensor, text_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        out = self.dense_layers(x)
        if text_emb is not None:
            out = torch.cat([out, text_emb], 1)
        return self.conv_1x1(out) + x


class RDN(nn.Module):
    """Arch rdn: ``n_channel`` channels in and out."""

    def __init__(self, n_channel: int = 3, n_dense: int = 6, n_feat: int = 64, scale_factor: int = 2,
                 growth: int = 32, text_channels: int = 0):
        super().__init__()
        self.scale_factor = scale_factor
        self.conv1 = nn.Conv2d(n_channel, n_feat, 3, padding=1)
        self.conv2 = nn.Conv2d(n_feat, n_feat, 3, padding=1)
        for k in (1, 2, 3):
            setattr(self, f"RDB{k}", RDB(n_feat, n_dense, growth, text_channels))
        self.GFF_1x1 = nn.Conv2d(3 * n_feat, n_feat, 1)
        self.GFF_3x3 = nn.Conv2d(n_feat, n_feat, 3, padding=1)
        self.conv_up = nn.Conv2d(n_feat, n_feat * scale_factor**2, 3, padding=1)
        self.conv3 = nn.Conv2d(n_feat, n_channel, 3, padding=1)

    def _trunk(self, x: torch.Tensor, t: Optional[torch.Tensor] = None) -> torch.Tensor:
        f_m1 = self.conv1(x)
        f_1 = self.RDB1(self.conv2(f_m1), t)
        f_2 = self.RDB2(f_1, t)
        f_3 = self.RDB3(f_2, t)
        fdf = self.GFF_3x3(self.GFF_1x1(torch.cat([f_1, f_2, f_3], 1))) + f_m1
        return self.conv3(F.pixel_shuffle(self.conv_up(fdf), self.scale_factor))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, n_channel, h, w] -> [B, n_channel, 2h, 2w]."""
        return self._trunk(x)


class RDN_TL(RDN):
    """Arch rdn_tl."""

    def __init__(self, n_channel: int = 4, n_dense: int = 6, n_feat: int = 64, scale_factor: int = 2,
                 growth: int = 32, text_emb: int = 37, out_text_channels: int = 32):
        super().__init__(n_channel, n_dense, n_feat, scale_factor, growth, text_channels=out_text_channels)
        self.text_emb = text_emb
        self.infoGen = InfoGenP(text_emb, out_text_channels, NP_PADDINGS)

    def forward(self, x: torch.Tensor, text_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, n_channel, h, w], text_emb [B, 37, 1, T] -> [B, n_channel, 2h, 2w]."""
        if text_emb is None:
            text_emb = x.new_zeros(x.shape[0], self.text_emb, 1, 26)
        t = interpolate_bilinear(self.infoGen(text_emb), (x.shape[2], x.shape[3]), align_corners=True)
        return self._trunk(x, t)
