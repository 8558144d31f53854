"""Bilinear grid sampling in NHWC (counterpart of tpgsr_tpu/ops/grid_sample.py:53).

The JAX package's default ``method='contraction'`` is an XLA rewrite for the
TPU's matrix unit, not a Pallas kernel, so the port takes the stock
``F.grid_sample``; the tests hold it to both of the JAX package's methods.
Grid values in [-1, 1], (x, y) order in the last axis, ``padding_mode``
``'zeros'`` or ``'border'``, ``align_corners`` explicit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample(x: torch.Tensor, grid: torch.Tensor, align_corners: bool = False,
                padding_mode: str = "zeros") -> torch.Tensor:
    """x [B, H, W, C], grid [B, Hg, Wg, 2] -> [B, Hg, Wg, C]."""
    out = F.grid_sample(x.permute(0, 3, 1, 2), grid, mode="bilinear", padding_mode=padding_mode,
                        align_corners=align_corners)
    return out.permute(0, 2, 3, 1)
