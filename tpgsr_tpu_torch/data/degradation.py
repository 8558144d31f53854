"""Synthetic-LR degradation (counterpart of tpgsr_tpu/data/degradation.py).

Two functions of the reference's vendored KAIR utilities are live:
``fspecial('gaussian', 15, 1.)`` (utils/utils_deblur.py:526, used at
dataset/dataset.py:32-34) and ``srmd_degradation`` (utils/utils_sisr.py:235,
used by ``alignCollate_syn.degradation``, dataset.py:934-950: a blur, then
Gaussian noise).  Without scipy the blur is a circular convolution by
numpy's FFT, which is scipy.ndimage's ``mode='wrap'`` exactly.
"""

from __future__ import annotations

import numpy as np
from PIL import Image


def fspecial_gaussian(hsize: int = 15, sigma: float = 1.0) -> np.ndarray:
    """MATLAB's ``fspecial('gaussian', hsize, sigma)``: a normalized 2-D kernel."""
    half = (hsize - 1) / 2.0
    y, x = np.mgrid[-half : half + 1, -half : half + 1]
    k = np.exp(-(x * x + y * y) / (2.0 * sigma * sigma))
    k[k < np.finfo(float).eps * k.max()] = 0.0
    return k / k.sum()


def _convolve_wrap(x: np.ndarray, k: np.ndarray) -> np.ndarray:
    """``scipy.ndimage.convolve(x, k, mode='wrap')`` per channel: the kernel
    placed at the origin with its centre rolled to (0, 0), then a product of
    real FFTs."""
    h, w = x.shape[:2]
    kh, kw = k.shape
    pad = np.zeros((h, w), np.float64)
    pad[:kh, :kw] = k
    kf = np.fft.rfft2(np.roll(pad, (-(kh // 2), -(kw // 2)), axis=(0, 1)))
    if x.ndim == 2:
        return np.fft.irfft2(np.fft.rfft2(x) * kf, s=(h, w))
    out = np.empty_like(x, dtype=np.float64)
    for c in range(x.shape[2]):
        out[..., c] = np.fft.irfft2(np.fft.rfft2(x[..., c]) * kf, s=(h, w))
    return out


def srmd_degradation(x: np.ndarray, k: np.ndarray, sf: int = 3) -> np.ndarray:
    """The blur by ``k`` with wrapped borders (utils/utils_sisr.py:235-258;
    the reference's downsample there is commented out, so ``sf`` is unused)."""
    return _convolve_wrap(np.asarray(x, np.float64), np.asarray(k, np.float64))


def degrade_image(img: Image.Image, kernel: np.ndarray, noise_level: float = 0.0,
                  deterministic: bool = False) -> Image.Image:
    """``alignCollate_syn.degradation`` (dataset.py:934-950): blur, add
    N(0, ``noise_level``) noise from numpy's global generator, clip and
    truncate to uint8.  ``deterministic`` reseeds that generator with 0 first,
    as the reference does for its evals."""
    arr = srmd_degradation(np.array(img), kernel)
    if deterministic:
        np.random.seed(0)
    arr = arr + np.random.normal(0, noise_level, arr.shape)
    return Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8))


DEFAULT_BLUR_KERNEL = fspecial_gaussian(15, 1.0)
