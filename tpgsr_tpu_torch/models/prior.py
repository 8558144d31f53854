"""The text-prior pyramid shared by the SR backbones (counterpart of
tpgsr_tpu/models/prior.py).

The original keeps one ``InfoGen`` per backbone; the copies differ only in
their ConvTranspose paddings:

* TSRN (reference model/tsrn.py:81-108): (1, 1), (1, 1), (1, 1), (1, 0);
* SRCNN, SRResNet, RDN and VDSR (model/srcnn.py:18-47, srresnet.py:166-195,
  rdn.py:93-120, vdsr.py:92-119): (0, 0), (0, 0), (1, 1), (1, 1).

Keys: ``tconv{k}`` and ``bn{k}``, k = 1..4, in every copy.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

TSRN_PADDINGS = ((1, 1), (1, 1), (1, 1), (1, 0))
NP_PADDINGS = ((0, 0), (0, 0), (1, 1), (1, 1))
_STRIDES = ((2, 2), (2, 2), (2, 2), (2, 1))


class InfoGenP(nn.Module):
    """Lift the [B, t_emb, 1, T] prior to a spatial map with 4
    ConvTranspose-BN-ReLU stages of 512, 128, 64 and ``output_size``
    channels."""

    def __init__(self, t_emb: int, output_size: int, paddings: Sequence[Tuple[int, int]] = TSRN_PADDINGS):
        super().__init__()
        c_in = t_emb
        for k, (c_out, stride, pad) in enumerate(zip((512, 128, 64, output_size), _STRIDES, paddings), start=1):
            setattr(self, f"tconv{k}", nn.ConvTranspose2d(c_in, c_out, 3, stride, padding=pad, bias=False))
            setattr(self, f"bn{k}", nn.BatchNorm2d(c_out))
            c_in = c_out

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        x = t
        for k in (1, 2, 3, 4):
            x = F.relu(getattr(self, f"bn{k}")(getattr(self, f"tconv{k}")(x)))
        return x
