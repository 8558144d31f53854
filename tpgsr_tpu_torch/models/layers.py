"""Building blocks of the SR path (counterpart of tpgsr_tpu/models/layers.py).

NCHW, with the original TPGSR's module names so its ``state_dict`` keys
load unchanged.  PReLU and BatchNorm are ``nn.PReLU(1)`` and
``nn.BatchNorm2d`` (eps 1e-5) themselves.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpgsr_tpu_torch.models.stn import STNHead
from tpgsr_tpu_torch.ops import gru_seq


def mish(x: torch.Tensor) -> torch.Tensor:
    """x * tanh(softplus(x)) (reference model/tsrn.py:480-488)."""
    return x * torch.tanh(F.softplus(x))


def init_torch_defaults_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-draw every conv, linear and RNN weight from ``generator`` with
    torch's default ranges: U(+-1/sqrt(fan_in)) for weights and biases (fan_in
    of a transposed conv is out_channels * kh * kw), U(+-1/sqrt(hidden)) for
    recurrent ones.  BatchNorm and PReLU keep their constant defaults.  An
    STN head draws its own init instead (``STNHead.init_from_``)."""
    own = set()
    with torch.no_grad():
        for m in module.modules():
            if id(m) in own:
                continue
            if isinstance(m, STNHead):
                m.init_from_(generator)
                own.update(id(c) for c in m.modules())
            elif isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                if isinstance(m, nn.ConvTranspose2d):
                    fan_in = m.weight.shape[1] * m.weight[0, 0].numel()
                else:
                    fan_in = m.weight[0].numel()
                bound = 1.0 / math.sqrt(fan_in)
                m.weight.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, (nn.LSTM, BiGRUParams)):
                bound = 1.0 / math.sqrt(m.hidden_size)
                for p in m.parameters(recurse=False):
                    p.uniform_(-bound, bound, generator=generator)
    return module


class BiGRUParams(nn.Module):
    """The parameters of ``nn.GRU(C, H, bidirectional=True)``, under the same
    names; the recurrence itself runs in ``ops.gru_seq`` (K1)."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.hidden_size = hidden_size
        for sfx in ("", "_reverse"):
            self.register_parameter(f"weight_ih_l0{sfx}", nn.Parameter(torch.empty(3 * hidden_size, input_size)))
            self.register_parameter(f"weight_hh_l0{sfx}", nn.Parameter(torch.empty(3 * hidden_size, hidden_size)))
            self.register_parameter(f"bias_ih_l0{sfx}", nn.Parameter(torch.empty(3 * hidden_size)))
            self.register_parameter(f"bias_hh_l0{sfx}", nn.Parameter(torch.empty(3 * hidden_size)))
        bound = 1.0 / math.sqrt(hidden_size)
        with torch.no_grad():
            for p in self.parameters():
                p.uniform_(-bound, bound)

    def direction(self, suffix: str):
        return {
            "w_ih": getattr(self, f"weight_ih_l0{suffix}"),
            "w_hh": getattr(self, f"weight_hh_l0{suffix}"),
            "b_ih": getattr(self, f"bias_ih_l0{suffix}"),
            "b_hh": getattr(self, f"bias_hh_l0{suffix}"),
        }

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[N, T, C] -> [N, T, 2H]."""
        return gru_seq.bigru(x, self.direction(""), self.direction("_reverse"))


class GruBlock(nn.Module):
    """1x1 conv, then a bidirectional GRU along W for each of the B*H rows
    (reference model/tsrn.py:491-508; keys ``conv1.*``, ``gru.*``)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        if out_channels % 2:
            raise ValueError(f"GruBlock needs an even out_channels, got {out_channels}")
        self.conv1 = nn.Conv2d(in_channels, out_channels, 1)
        self.gru = BiGRUParams(out_channels, out_channels // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x).permute(0, 2, 3, 1).contiguous()
        b, h, w, c = x.shape
        x = self.gru(x.view(b * h, w, c))
        return x.view(b, h, w, c).permute(0, 3, 1, 2)


class UpsampleBlock(nn.Module):
    """conv -> PixelShuffle -> mish (reference model/tsrn.py:464-477)."""

    def __init__(self, in_channels: int, up_scale: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, in_channels * up_scale**2, 3, padding=1)
        self.up_scale = up_scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mish(F.pixel_shuffle(self.conv(x), self.up_scale))
