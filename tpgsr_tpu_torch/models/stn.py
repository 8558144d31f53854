"""STN rectification head and thin-plate-spline transformer (counterpart of
tpgsr_tpu/models/stn.py:65-192; reference model/stn_head.py:25-106 and
model/tps_spatial_transformer.py:54-112).

NCHW, with the original's keys: ``stn_convnet.{0,2,4,6,8,10}.{0,1}`` (conv,
BatchNorm2d; max-pools at the odd indices), ``stn_fc1.{0,1}`` (Linear,
BatchNorm1d) and ``stn_fc2``.  TSRN_TL runs both in train mode only.

The TPS constants (the inverse of the control-point kernel and the target
grid's radial basis) are built in numpy at construction and registered as
buffers outside the ``state_dict``: they follow from the sizes alone, so an
original checkpoint's ``tps.*`` entries carry nothing the module lacks.
"""

from __future__ import annotations

import itertools
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn

from tpgsr_tpu_torch.ops.grid_sample import grid_sample

_CHANNELS = (32, 64, 128, 256, 256, 256)
NUM_CTRLPOINTS = 20


def _conv3x3_block(c_in: int, c_out: int) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(c_in, c_out, 3, 1, 1), nn.BatchNorm2d(c_out), nn.ReLU(inplace=True))


def border_points(margin_x: float, margin_y: float) -> np.ndarray:
    """NUM_CTRLPOINTS (x, y) points, half along the top and half along the
    bottom edge of [0, 1]^2, inset by the margins: the target control points
    (margins 0.05) and the start of fc2's bias (0.01; stn_head.py:73-90)."""
    num_side = NUM_CTRLPOINTS // 2
    ctrl_x = np.linspace(margin_x, 1.0 - margin_x, num_side)
    top = np.stack([ctrl_x, np.full(num_side, margin_y)], axis=1)
    bot = np.stack([ctrl_x, np.full(num_side, 1.0 - margin_y)], axis=1)
    return np.concatenate([top, bot], axis=0)


class STNHead(nn.Module):
    """Predict NUM_CTRLPOINTS TPS control points in [0, 1] from the image.

    Six conv3x3-BN-ReLU blocks with 2x2 max-pools between, the fifth pool
    (1, 2) (the SR variant); fc1's input width is 256 times the trunk's
    output size, which follows ``input_size`` (h, w) as the flax module's
    does (512 at the flagship's 16x64)."""

    def __init__(self, in_planes: int, input_size: Tuple[int, int]):
        super().__init__()
        layers, c_in = [], in_planes
        h, w = input_size
        for i, c_out in enumerate(_CHANNELS):
            layers.append(_conv3x3_block(c_in, c_out))
            if i < 4:
                layers.append(nn.MaxPool2d(2, 2))
                h, w = h // 2, w // 2
            elif i == 4:
                layers.append(nn.MaxPool2d((1, 2), (1, 2)))
                w = w // 2
            c_in = c_out
        if h < 1 or w < 1:
            raise ValueError(f"STNHead needs an input of at least 16x64 / (1, 2) pools, got {input_size}")
        self.stn_convnet = nn.Sequential(*layers)
        self.stn_fc1 = nn.Sequential(nn.Linear(c_in * h * w, 512), nn.BatchNorm1d(512), nn.ReLU(inplace=True))
        self.stn_fc2 = nn.Linear(512, NUM_CTRLPOINTS * 2)
        self.init_from_(None)

    def init_from_(self, generator) -> "STNHead":
        """The original's init (stn_head.py:59-90), drawn from ``generator``:
        convs normal(0, sqrt(2 / (9 * out))) with zero bias, fc1 normal(0,
        0.001) with zero bias, fc2 zero weights with the border grid as bias;
        BatchNorm at its defaults."""
        with torch.no_grad():
            for m in self.stn_convnet.modules():
                if isinstance(m, nn.Conv2d):
                    m.weight.normal_(0.0, math.sqrt(2.0 / (9 * m.out_channels)), generator=generator)
                    m.bias.zero_()
            self.stn_fc1[0].weight.normal_(0.0, 0.001, generator=generator)
            self.stn_fc1[0].bias.zero_()
            self.stn_fc2.weight.zero_()
            self.stn_fc2.bias.copy_(torch.from_numpy(border_points(0.01, 0.01).reshape(-1)))
        return self

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B, C, h, w] -> (fc1 features [B, 512], control points [B, N, 2])."""
        x = self.stn_convnet(x)
        img_feat = self.stn_fc1(x.flatten(1))  # channel-major, as the original's view
        pts = self.stn_fc2(0.1 * img_feat)
        return img_feat, pts.view(-1, NUM_CTRLPOINTS, 2)


def _partial_repr(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """phi(r) = 0.5 r^2 log(r^2) over pairwise distances, nan -> 0."""
    diff = a[:, None, :] - b[None, :, :]
    dist = (diff**2).sum(-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        rep = 0.5 * dist * np.log(dist)
    rep[~np.isfinite(rep)] = 0.0
    return rep


class TPSSpatialTransformer(nn.Module):
    """Warp an image by the TPS that maps the target control points to the
    predicted source ones, sampled bilinearly (``align_corners=False``, zero
    padding) at ``output_image_size``."""

    def __init__(self, output_image_size: Tuple[int, int]):
        super().__init__()
        self.target_height, self.target_width = output_image_size
        target_cp = border_points(0.05, 0.05)
        n = NUM_CTRLPOINTS
        forward_kernel = np.zeros((n + 3, n + 3))
        forward_kernel[:n, :n] = _partial_repr(target_cp, target_cp)
        forward_kernel[:n, n] = 1.0
        forward_kernel[n, :n] = 1.0
        forward_kernel[:n, n + 1:] = target_cp
        forward_kernel[n + 1:, :n] = target_cp.T
        coords = np.array(list(itertools.product(range(self.target_height), range(self.target_width))),
                          dtype=np.float64)
        y = coords[:, 0:1] / (self.target_height - 1)
        x = coords[:, 1:2] / (self.target_width - 1)
        target_coordinate = np.concatenate([x, y], axis=1)  # (x, y) order
        repr_mat = np.concatenate(
            [_partial_repr(target_coordinate, target_cp), np.ones((len(coords), 1)), target_coordinate], axis=1)
        self.register_buffer("inverse_kernel", torch.from_numpy(np.linalg.inv(forward_kernel).astype(np.float32)),
                             persistent=False)  # [N+3, N+3]
        self.register_buffer("target_coordinate_repr", torch.from_numpy(repr_mat.astype(np.float32)),
                             persistent=False)  # [HW, N+3]

    def forward(self, x: torch.Tensor, source_control_points: torch.Tensor):
        """x [B, C, H, W], control points [B, N, 2] in [0, 1] -> (the warped
        image [B, C, Ht, Wt], source coordinates [B, Ht * Wt, 2])."""
        b = source_control_points.shape[0]
        y = torch.cat([source_control_points, source_control_points.new_zeros(b, 3, 2)], 1)
        mapping = torch.matmul(self.inverse_kernel, y)  # [B, N+3, 2]
        source_coordinate = torch.matmul(self.target_coordinate_repr, mapping)  # [B, HW, 2]
        grid = source_coordinate.view(b, self.target_height, self.target_width, 2)
        grid = torch.clamp(grid, 0.0, 1.0) * 2.0 - 1.0
        out = grid_sample(x.permute(0, 2, 3, 1), grid, align_corners=False)
        return out.permute(0, 3, 1, 2), source_coordinate
