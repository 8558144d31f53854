"""Bilinear grid sampling in NHWC (counterpart of tpgsr_tpu/ops/grid_sample.py:53).

The JAX package's default ``method='contraction'`` is an XLA rewrite for the
TPU's matrix unit, not a Pallas kernel, so the port takes the stock
``F.grid_sample``; the tests hold it to both of the JAX package's methods.
Grid values in [-1, 1], (x, y) order in the last axis, ``padding_mode``
``'zeros'`` or ``'border'``, ``align_corners`` explicit.  A bf16 image is
sampled in fp32 at the bf16 grid's values and the result rounded to bf16,
on both devices.  The JAX package computes the source coordinates in fp32
from the bf16 grid and rounds only the bilinear weights and the products;
torch's sampler on bf16 inputs computes the coordinates in bf16 (1/8 pixel
apart at x = 30), which puts its result about 250 bf16 ulps from the JAX
package's where this one stays within 2 (tests/test_torch_bf16.py).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample(x: torch.Tensor, grid: torch.Tensor, align_corners: bool = False,
                padding_mode: str = "zeros") -> torch.Tensor:
    """x [B, H, W, C], grid [B, Hg, Wg, 2] -> [B, Hg, Wg, C] in x's dtype."""
    out = F.grid_sample(x.permute(0, 3, 1, 2).float(), grid.float(), mode="bilinear", padding_mode=padding_mode,
                        align_corners=align_corners)
    return out.permute(0, 2, 3, 1).to(x.dtype)
