"""VDSR and VDSR_TL (counterpart of tpgsr_tpu/models/vdsr.py; reference
model/vdsr.py:39-233).

The LR is nearest-upsampled x2, then a bias-free MSRA 3x3 conv with ReLU, 6
conv-ReLU blocks each with its own skip, a conv back to ``in_planes`` and the
skip from the upsampled input.  VDSR_TL concatenates the prior map, lifted by
``InfoGenP`` with ``NP_PADDINGS`` and resized bilinearly to (height, width),
before every block conv.  The original hard-codes its STN off
(vdsr.py:56,181), so there is none.  Keys: ``input``,
``residual_layer.{i}.conv`` (VDSR), ``block{k}.conv`` (VDSR_TL), ``output``
and ``infoGen.*`` (tpgsr_tpu/interop/torch_import.py:470).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpgsr_tpu_torch.models.layers import MSRAConv2d
from tpgsr_tpu_torch.models.prior import NP_PADDINGS, InfoGenP
from tpgsr_tpu_torch.models.srcnn import upsample_nearest
from tpgsr_tpu_torch.ops.resize import interpolate_bilinear


class _Block(nn.Module):
    """The original's ``Conv_ReLU_Block``: one conv, under the key ``conv``."""

    def __init__(self, in_channels: int):
        super().__init__()
        self.conv = MSRAConv2d(in_channels, 64)


class VDSR(nn.Module):
    """Arch vdsr: ``in_planes`` channels in and out."""

    def __init__(self, scale_factor: int = 2, in_planes: int = 3, n_blocks: int = 6):
        super().__init__()
        self.scale_factor = scale_factor
        self.input = MSRAConv2d(in_planes, 64)
        self.residual_layer = nn.Sequential(*(_Block(64) for _ in range(n_blocks)))
        self.output = MSRAConv2d(64, in_planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, in_planes, h, w] -> [B, in_planes, 2h, 2w]."""
        x = upsample_nearest(x, self.scale_factor)
        out = F.relu(self.input(x))
        for block in self.residual_layer:
            out = F.relu(block.conv(out)) + out
        return self.output(out) + x


class VDSR_TL(nn.Module):
    """Arch vdsr_tl."""

    def __init__(self, scale_factor: int = 2, in_planes: int = 4, n_blocks: int = 6, height: int = 32,
                 width: int = 128, text_emb: int = 37, out_text_channels: int = 32):
        super().__init__()
        self.scale_factor = scale_factor
        self.size = (height, width)
        self.text_emb = text_emb
        self.n_blocks = n_blocks
        self.infoGen = InfoGenP(text_emb, out_text_channels, NP_PADDINGS)
        self.input = MSRAConv2d(in_planes, 64)
        for k in range(1, n_blocks + 1):
            setattr(self, f"block{k}", _Block(64 + out_text_channels))
        self.output = MSRAConv2d(64, in_planes)

    def forward(self, x: torch.Tensor, text_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, in_planes, h, w], text_emb [B, 37, 1, T] -> [B, in_planes, 2h, 2w]."""
        x = upsample_nearest(x, self.scale_factor)
        if text_emb is None:
            text_emb = x.new_zeros(x.shape[0], self.text_emb, 1, 26)
        t = interpolate_bilinear(self.infoGen(text_emb), self.size, align_corners=True)
        out = F.relu(self.input(x))
        for k in range(1, self.n_blocks + 1):
            out = F.relu(getattr(self, f"block{k}").conv(torch.cat([out, t], 1))) + out
        return self.output(out) + x
