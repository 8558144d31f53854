"""Image metrics, the gradient map and the device-side contour mask
(counterpart of tpgsr_tpu/ops/image.py:24-142).

NHWC in [0, 1], as the JAX package: PSNR (reference utils/ssim_psnr.py:9-15)
and SSIM (:18-89) over the first 3 channels; SSIM with an 11x11 Gaussian
window (sigma 1.5) and zero "same" padding, border bias included; the
central-difference gradient magnitude that the gradient prior loss reads.
The contour mask works on uint8 NHWC in exact int32 arithmetic.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def pil_gray_u8(rgb_u8: torch.Tensor) -> torch.Tensor:
    """PIL's ``convert('L')`` exactly: libImaging's integer formula
    ``(R*19595 + G*38470 + B*7471 + 0x8000) >> 16``.  [..., 3] uint8 ->
    [...] int32 in [0, 255]."""
    r, g, b = (rgb_u8[..., i].to(torch.int32) for i in range(3))
    return (r * 19595 + g * 38470 + b * 7471 + 32768) >> 16


def append_contour_mask_u8(img: torch.Tensor) -> torch.Tensor:
    """Append the contour-mask channel to uint8 NHWC RGB, [..., H, W, 3] ->
    [..., H, W, 4], the mask in {0, 255}: the same bytes as the host
    collate's mask (data/transforms.py, ``resize_normalize(as_uint8=True,
    mask=True)``).  A pixel is 0 where its gray exceeds the image's mean,
    tested as ``gray * (H * W) > sum(gray)`` in int32 (at most 255 * H * W),
    since a float mean could flip pixels where gray equals it."""
    gray = pil_gray_u8(img)
    hw = gray.shape[-1] * gray.shape[-2]
    total = gray.sum(dim=(-2, -1), keepdim=True, dtype=torch.int32)
    mask = (gray * hw <= total).to(torch.uint8) * 255
    return torch.cat([img, mask.unsqueeze(-1)], dim=-1)


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
