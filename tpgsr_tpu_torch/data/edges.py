"""Edge-based loss-weight masks in numpy (counterpart of
tpgsr_tpu/data/edges.py): the reference ``lmdbDatasetWithMask_real.get_mask``
(dataset/dataset.py:841-852), ``Canny(20, 150)`` on the grayscale HR, a 5x5
dilation, a 5x5 Gaussian blur of sigma 1, then ``0.4 + mask / 255 * 0.5``.

Without cv2 the Canny detector is written out: a 5x5 Gaussian smooth, Sobel
gradients, non-maximum suppression over four directions and hysteresis by
repeated dilation.  Its edges follow cv2's closely, not bit for bit (cv2
rounds its gradients its own way); the result is a soft weight in [0.4,
0.9].  Every step is the JAX package's arithmetic, so the two packages give
the same bytes.
"""

from __future__ import annotations

import numpy as np
from PIL import Image

# hysteresis rounds: strong edges grow into weak neighbours at most this often
HYSTERESIS_ROUNDS = 16


def _gaussian_kernel_1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2 * sigma * sigma))
    return k / k.sum()


def _sep_filter(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Separable filter, rows then columns, reflected borders."""
    r = len(k) // 2
    pad = np.pad(img, ((r, r), (0, 0)), mode="reflect")
    out = sum(k[i] * pad[i : i + img.shape[0], :] for i in range(len(k)))
    pad = np.pad(out, ((0, 0), (r, r)), mode="reflect")
    return sum(k[i] * pad[:, i : i + img.shape[1]] for i in range(len(k)))


def canny(gray: np.ndarray, low: float = 20.0, high: float = 150.0) -> np.ndarray:
    """Binary edge map in {0, 255} (uint8): thresholds on the L2 gradient
    magnitude of the 5x5-smoothed image, as cv2.Canny takes them."""
    img = _sep_filter(np.asarray(gray, np.float64), _gaussian_kernel_1d(1.4, 2))
    p = np.pad(img, 1, mode="reflect")
    gx = (p[:-2, 2:] + 2 * p[1:-1, 2:] + p[2:, 2:]) - (p[:-2, :-2] + 2 * p[1:-1, :-2] + p[2:, :-2])
    gy = (p[2:, :-2] + 2 * p[2:, 1:-1] + p[2:, 2:]) - (p[:-2, :-2] + 2 * p[:-2, 1:-1] + p[:-2, 2:])
    mag = np.hypot(gx, gy)
    ang = np.rad2deg(np.arctan2(gy, gx)) % 180.0

    # non-maximum suppression: a pixel stays where neither neighbour along
    # its quantized gradient direction is larger
    m = np.pad(mag, 1)
    h, w = mag.shape
    c = m[1 : h + 1, 1 : w + 1]
    directions = [(ang < 22.5) | (ang >= 157.5), (ang >= 22.5) & (ang < 67.5), (ang >= 67.5) & (ang < 112.5),
                  (ang >= 112.5) & (ang < 157.5)]
    n1 = np.select(directions, [m[1 : h + 1, 2 : w + 2], m[0:h, 2 : w + 2], m[0:h, 1 : w + 1], m[0:h, 0:w]])
    n2 = np.select(directions, [m[1 : h + 1, 0:w], m[2 : h + 2, 0:w], m[2 : h + 2, 1 : w + 1],
                                m[2 : h + 2, 2 : w + 2]])
    mag = np.where((c >= n1) & (c >= n2), mag, 0.0)

    # hysteresis: strong seeds grow into their weak 8-neighbours
    weak = mag >= low
    edges = mag >= high
    for _ in range(HYSTERESIS_ROUNDS):
        grown = np.pad(edges, 1)
        neigh = np.zeros_like(edges)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                neigh |= grown[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
        new = neigh & weak
        if (new == edges).all():
            break
        edges = new
    return (edges * 255).astype(np.uint8)


def dilate(mask: np.ndarray, ksize: int = 5, iterations: int = 1) -> np.ndarray:
    """cv2.dilate with an all-ones ``ksize`` x ``ksize`` kernel, {0, 255} uint8."""
    out = mask.astype(bool)
    r = ksize // 2
    h, w = mask.shape
    for _ in range(iterations):
        p = np.pad(out, r)
        acc = np.zeros_like(out)
        for dy in range(ksize):
            for dx in range(ksize):
                acc |= p[dy : dy + h, dx : dx + w]
        out = acc
    return (out * 255).astype(np.uint8)


def gaussian_blur(img: np.ndarray, ksize: int = 5, sigma: float = 1.0) -> np.ndarray:
    """cv2.GaussianBlur((ksize, ksize), sigma), float64."""
    return _sep_filter(np.asarray(img, np.float64), _gaussian_kernel_1d(sigma, ksize // 2))


def edge_weight_mask(image: Image.Image) -> np.ndarray:
    """The whole ``get_mask`` chain: float64 weights in [0.4, 0.9], [H, W]."""
    e = gaussian_blur(dilate(canny(np.asarray(image.convert("L")), 20, 150), 5, 1), 5, 1.0)
    return 0.4 + (e / 255.0) * 0.5
