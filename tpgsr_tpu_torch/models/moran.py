"""MORAN, the second eval recognizer: the MORN offset-grid rectifier and the
ASRN attention decoder (counterpart of tpgsr_tpu/models/moran.py; reference
model/moran/morn.py:6-139, asrn_res.py:27-259, moran.py:6-22).

Eval path only (``test=True``, ``enhance=1``), as TPGSR runs it frozen.  NCHW,
with the original's keys, so that ``moran_demo.pth`` loads and a port
``state_dict`` goes through the JAX package's ``import_moran``
(tpgsr_tpu/interop/torch_import.py:235) unchanged:

* ``MORN.cnn.{1,2} {5,6} {9,10} {12,13} {15,16}``: the offset CNN's (conv,
  BatchNorm) pairs in one ``nn.Sequential``, max-pools and ReLUs between;
* ``ASRN.cnn.block0.{0,1}`` and ``ASRN.cnn.block{1..5}.{i}.conv1|conv2|
  downsample.{0,1}``: the residual CNN, 32x100 -> 1x25;
* ``ASRN.rnn.{0,1}.rnn|embedding``: two BiLSTMs, each with a Linear;
* ``ASRN.attentionL2R|attentionR2L``: ``char_embeddings``, ``generator``
  and ``attention_cell.{i2h,h2h,score,rnn}`` (the GRU cell).

The original's MORN keeps its base grid as a buffer (``MORN.grid``); the port
builds it from the sizes and ``ORIGINAL_CONSTANTS`` names what a loader may
drop.  The decoders run 20 greedy steps from target 0, each feeding back
``argmax + 1``; the R2L decoder reads the same features as the L2R one.
Decoding cuts at '$' (the '0:1:...:z:$' alphabet, utils/utils_moran.py).
``fracPickup`` jitters attention in training only and is not here.
"""

from __future__ import annotations

import string
from typing import List, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from tpgsr_tpu_torch.models.aster import gru_step
from tpgsr_tpu_torch.models.crnn import BidirectionalLSTM
from tpgsr_tpu_torch.models.layers import init_torch_defaults_
from tpgsr_tpu_torch.ops.grid_sample import grid_sample
from tpgsr_tpu_torch.ops.resize import interpolate_bilinear

MORAN_CHARS = string.digits + string.ascii_lowercase + "$"
MORAN_NCLASS = len(MORAN_CHARS)  # 37, '$' (36) ends a word
MORAN_MAX_ITER = 20
ORIGINAL_CONSTANTS = ("MORN.grid",)
# (channels, blocks, stride) of ASRN.cnn.block1..5
_STAGES = ((32, 3, (2, 2)), (64, 4, (2, 2)), (128, 6, (2, 1)), (256, 6, (2, 1)), (512, 3, (2, 1)))


class MORN(nn.Module):
    """Offsets predicted on a bilinear 32x100 copy of the image, pooled by
    the relu(+)/relu(-) max-pool trick, sampled onto the base grid and added
    to its y; the image sampled there; then once more from the rectified
    image (``enhance``), the offsets summed."""

    def __init__(self, target_h: int = 32, target_w: int = 100, enhance: int = 1):
        super().__init__()
        self.target_size, self.enhance = (target_h, target_w), enhance
        self.cnn = nn.Sequential(
            nn.MaxPool2d(2, 2),
            nn.Conv2d(1, 64, 3, 1, 1), nn.BatchNorm2d(64), nn.ReLU(inplace=True), nn.MaxPool2d(2, 2),
            nn.Conv2d(64, 128, 3, 1, 1), nn.BatchNorm2d(128), nn.ReLU(inplace=True), nn.MaxPool2d(2, 2),
            nn.Conv2d(128, 64, 3, 1, 1), nn.BatchNorm2d(64), nn.ReLU(inplace=True),
            nn.Conv2d(64, 16, 3, 1, 1), nn.BatchNorm2d(16), nn.ReLU(inplace=True),
            nn.Conv2d(16, 1, 3, 1, 1), nn.BatchNorm2d(1))
        self.pool = nn.MaxPool2d(2, 1)
        h_list = np.arange(target_h) * 2.0 / (target_h - 1) - 1
        w_list = np.arange(target_w) * 2.0 / (target_w - 1) - 1
        gx, gy = np.meshgrid(w_list, h_list)
        grid = np.stack([gx, gy], axis=-1)[None].astype(np.float32)
        self.register_buffer("base_grid", torch.from_numpy(grid), persistent=False)  # [1, H, W, 2]

    def _offsets(self, x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
        """The offset map of ``x`` [B, 1, h, w], sampled at ``grid`` -> [B, H, W, 1]."""
        off = self.cnn(x)
        pooled = self.pool(F.relu(off)) - self.pool(F.relu(-off))
        return grid_sample(pooled.permute(0, 2, 3, 1), grid)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, 1, 32, 100] -> the rectified [B, 1, 32, 100]."""
        grid = self.base_grid.expand(x.shape[0], -1, -1, -1)
        grid_x, grid_y = grid[..., 0:1], grid[..., 1:2]
        x_nhwc = x.permute(0, 2, 3, 1)
        offsets = self._offsets(interpolate_bilinear(x, self.target_size), grid)
        rectified = grid_sample(x_nhwc, torch.cat([grid_x, grid_y + offsets], dim=-1))
        for _ in range(self.enhance):
            offsets = offsets + self._offsets(rectified.permute(0, 3, 1, 2), grid)
            rectified = grid_sample(x_nhwc, torch.cat([grid_x, grid_y + offsets], dim=-1))
        return rectified.permute(0, 3, 1, 2)


class ResidualBlockASRN(nn.Module):
    """(conv3x3(stride) in a stage's first block, else conv1x1)-BN, then
    conv3x3-BN, plus the residual (through a conv3x3(stride)-BN
    ``downsample`` in a first block), then ReLU."""

    def __init__(self, c_in: int, c_out: int, stride=(1, 1)):
        super().__init__()
        down = stride[0] > 1
        k, pad = (3, 1) if down else (1, 0)
        self.conv1 = nn.Sequential(nn.Conv2d(c_in, c_out, k, stride, pad), nn.BatchNorm2d(c_out))
        self.conv2 = nn.Sequential(nn.Conv2d(c_out, c_out, 3, 1, 1), nn.BatchNorm2d(c_out))
        self.downsample = (nn.Sequential(nn.Conv2d(c_in, c_out, 3, stride, 1), nn.BatchNorm2d(c_out))
                           if down else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(residual + self.conv2(self.conv1(x)))


class ASRNResNet(nn.Module):
    """[B, 1, 32, 100] -> [B, 512, 1, 25]."""

    def __init__(self):
        super().__init__()
        self.block0 = nn.Sequential(nn.Conv2d(1, 32, 3, 1, 1), nn.BatchNorm2d(32))
        c_in = 32
        for i, (c_out, blocks, stride) in enumerate(_STAGES, start=1):
            layer = [ResidualBlockASRN(c_in, c_out, stride)] + [ResidualBlockASRN(c_out, c_out)
                                                                 for _ in range(blocks - 1)]
            setattr(self, f"block{i}", nn.Sequential(*layer))
            c_in = c_out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(len(_STAGES) + 1):
            x = getattr(self, f"block{i}")(x)
        return x


class AttentionCell(nn.Module):
    """The parameters of one attention step: ``i2h`` (no bias), ``h2h``,
    ``score`` (no bias) and the GRU cell ``rnn`` over [context, embedding]."""

    def __init__(self, hidden: int, num_embeddings: int):
        super().__init__()
        self.i2h = nn.Linear(hidden, hidden, bias=False)
        self.h2h = nn.Linear(hidden, hidden)
        self.score = nn.Linear(hidden, 1, bias=False)
        self.rnn = nn.GRUCell(hidden + num_embeddings, hidden)


class MoranAttention(nn.Module):
    """The greedy attention decoder of the eval path (asrn_res.py:68-156)."""

    def __init__(self, num_classes: int = MORAN_NCLASS, hidden: int = 256, num_embeddings: int = 256,
                 num_steps: int = MORAN_MAX_ITER):
        super().__init__()
        self.hidden, self.num_steps = hidden, num_steps
        self.attention_cell = AttentionCell(hidden, num_embeddings)
        self.generator = nn.Linear(hidden, num_classes)
        self.char_embeddings = nn.Parameter(torch.randn(num_classes + 1, num_embeddings))

    def forward(self, feats_tbc: torch.Tensor) -> torch.Tensor:
        """feats [T, B, hidden] -> logits [B, num_steps, num_classes]."""
        cell = self.attention_cell
        feats = feats_tbc.permute(1, 0, 2)
        feats_proj = cell.i2h(feats)  # the same at every step
        hidden = feats.new_zeros(feats.shape[0], self.hidden)
        target = torch.zeros(feats.shape[0], dtype=torch.long, device=feats.device)
        outs = []
        for _ in range(self.num_steps):
            emition = cell.score(torch.tanh(feats_proj + cell.h2h(hidden)[:, None, :]))[..., 0]
            context = torch.bmm(torch.softmax(emition, dim=1)[:, None, :], feats)[:, 0]
            gru_in = torch.cat([context, self.char_embeddings[target]], dim=-1)
            hidden = gru_step(gru_in, hidden, cell.rnn.weight_ih, cell.rnn.weight_hh, cell.rnn.bias_ih,
                              cell.rnn.bias_hh)
            logits = self.generator(hidden)
            outs.append(logits)
            target = torch.argmax(logits, dim=-1) + 1
        return torch.stack(outs, dim=1)


class ASRN(nn.Module):
    """The CNN, two BiLSTM + Linear layers, and the L2R and R2L decoders."""

    def __init__(self, num_classes: int = MORAN_NCLASS, hidden: int = 256):
        super().__init__()
        self.cnn = ASRNResNet()
        self.rnn = nn.Sequential(BidirectionalLSTM(512, hidden, hidden), BidirectionalLSTM(hidden, hidden, hidden))
        self.attentionL2R = MoranAttention(num_classes, hidden)
        self.attentionR2L = MoranAttention(num_classes, hidden)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        conv = self.cnn(x)
        if conv.shape[2] != 1:
            raise ValueError(f"the ASRN's conv height must be 1, got {conv.shape[2]}")
        feats = self.rnn(conv.squeeze(2).permute(2, 0, 1))
        return self.attentionL2R(feats), self.attentionR2L(feats)


class MORAN(nn.Module):
    """MORN + ASRN: [B, 1, 32, 100] grayscale (parse_moran_data) -> the L2R
    and R2L logits, each [B, 20, 37]."""

    def __init__(self, num_classes: int = MORAN_NCLASS, hidden: int = 256, target_h: int = 32,
                 target_w: int = 100):
        super().__init__()
        self.MORN = MORN(target_h, target_w)
        self.ASRN = ASRN(num_classes, hidden)

    def init_from_(self, generator: torch.Generator) -> "MORAN":
        """The JAX package's draws (tpgsr_tpu/models/moran.py): torch's
        default ranges for convs, linears and recurrent weights, N(0, 1) for
        the character embeddings, BatchNorm at its defaults."""
        init_torch_defaults_(self, generator)
        with torch.no_grad():
            for att in (self.ASRN.attentionL2R, self.ASRN.attentionR2L):
                att.char_embeddings.normal_(0.0, 1.0, generator=generator)
        return self

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.ASRN(self.MORN(x))


def decode_moran_ids(logits_bln) -> List[str]:
    """Per-step argmax -> characters, cut at the first '$'."""
    logits = logits_bln.detach().cpu().numpy() if isinstance(logits_bln, torch.Tensor) else np.asarray(logits_bln)
    out = []
    for row in logits.argmax(-1):
        word = "".join(MORAN_CHARS[int(v)] for v in row)
        out.append(word.split("$")[0])
    return out
