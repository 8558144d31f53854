"""Text-prior plumbing (counterpart of tpgsr_tpu/train/priors.py:21-38).

NHWC in and out, as the JAX package:
  * ``parse_crnn_data``: bicubic resize of RGB to 32 x width, then BT.601
    grayscale (reference interfaces/base.py:806-829);
  * ``logits_to_prior``: softmax of [T, B, C] logits -> [B, 1, T, C];
  * ``prior_dropout_first_quarter``: zero the prior of the first B//4 samples
    (of the global batch in a data-parallel step).
"""

from __future__ import annotations

import torch

from tpgsr_tpu_torch.ops.image import rgb_to_gray
from tpgsr_tpu_torch.ops.resize import interpolate_bicubic


def parse_crnn_data(images_nhwc: torch.Tensor, width: int = 100) -> torch.Tensor:
    """[B, H, W, C>=3] in [0, 1] -> [B, 32, width, 1] grayscale."""
    x = interpolate_bicubic(images_nhwc[..., :3].permute(0, 3, 1, 2), (32, width))
    return rgb_to_gray(x.permute(0, 2, 3, 1))


def logits_to_prior(logits_tbc: torch.Tensor) -> torch.Tensor:
    return torch.softmax(logits_tbc, dim=-1).permute(1, 0, 2)[:, None, :, :]


def prior_dropout_first_quarter(prior_b1tc: torch.Tensor, offset: int = 0, total: int = 0) -> torch.Tensor:
    """Zero the prior of the first quarter of the batch.  In a data-parallel
    step the rows are a rank's slice of a global batch of ``total`` starting
    at row ``offset``: the quarter is the global batch's (its first
    ``total // 4`` rows, as the JAX step's global view has it)."""
    b = prior_b1tc.shape[0]
    keep = prior_b1tc.new_ones(b)
    keep[: min(max((total or b) // 4 - offset, 0), b)] = 0.0
    return prior_b1tc * keep[:, None, None, None]
