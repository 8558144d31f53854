"""Image metrics and the gradient map (counterpart of
tpgsr_tpu/ops/image.py:60-142).

NHWC in [0, 1], as the JAX package: PSNR (reference utils/ssim_psnr.py:9-15)
and SSIM (:18-89) over the first 3 channels; SSIM with an 11x11 Gaussian
window (sigma 1.5) and zero "same" padding, border bias included; the
central-difference gradient magnitude that the gradient prior loss reads.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rgb_to_gray(x: torch.Tensor) -> torch.Tensor:
    """NHWC RGB -> NHW1 with BT.601 weights (reference interfaces/base.py:825-828)."""
    return 0.299 * x[..., 0:1] + 0.587 * x[..., 1:2] + 0.114 * x[..., 2:3]


def calculate_psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((img1[..., :3] * 255.0 - img2[..., :3] * 255.0) ** 2)
    return 20.0 * torch.log10(255.0 / torch.sqrt(mse))


def _gaussian_window(size: int, sigma: float = 1.5) -> torch.Tensor:
    g = torch.tensor(
        [math.exp(-((x - size // 2) ** 2) / float(2 * sigma**2)) for x in range(size)],
        dtype=torch.float32,
    )
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11, size_average: bool = True) -> torch.Tensor:
    """SSIM of NHWC images; per sample ([B]) when ``size_average`` is False."""
    a = img1[..., :3].permute(0, 3, 1, 2)
    b = img2[..., :3].permute(0, 3, 1, 2)
    c = a.shape[1]
    window = _gaussian_window(window_size).to(a.device, a.dtype)
    window = window.expand(c, 1, window_size, window_size).contiguous()
    pad = window_size // 2

    def blur(v):
        return F.conv2d(v, window, padding=pad, groups=c)

    mu1, mu2 = blur(a), blur(b)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = blur(a * a) - mu1_sq
    sigma2_sq = blur(b * b) - mu2_sq
    sigma12 = blur(a * b) - mu1_mu2
    c1, c2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )
    if size_average:
        return ssim_map.mean()
    return ssim_map.mean(dim=(1, 2, 3))


def gradient_map(x: torch.Tensor) -> torch.Tensor:
    """Central-difference gradient magnitude map, NHWC (reference
    loss/image_loss.py:43-51): shifted by one pixel with zero padding, so the
    borders take one-sided halves."""
    h, w = x.shape[1], x.shape[2]
    r = F.pad(x, (0, 0, 0, 1))[:, :, 1:]
    l = F.pad(x, (0, 0, 1, 0))[:, :, :w]
    t = F.pad(x, (0, 0, 0, 0, 1, 0))[:, :h]
    b = F.pad(x, (0, 0, 0, 0, 0, 1))[:, 1:]
    return torch.sqrt(((r - l) * 0.5) ** 2 + ((t - b) * 0.5) ** 2 + 1e-6)
