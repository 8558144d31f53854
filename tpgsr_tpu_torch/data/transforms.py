"""Host-side image transforms, PIL-backed so that preprocessing is
byte-identical to the JAX package's (counterpart of
tpgsr_tpu/data/transforms.py:19-121).

Reference ``resizeNormalize`` (dataset/dataset.py:615-652): PIL bicubic
resize, then ToTensor ([0, 1]), then an optional 4th contour-mask channel:
the grayscale image thresholded at its own mean, 0 where gray > mean, else 1.
Arrays are numpy HWC.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from PIL import Image


def contour_mask(img: Image.Image) -> np.ndarray:
    """Mean-threshold binary mask of the grayscale image, [H, W, 1] in {0, 1}."""
    arr = np.asarray(img.convert("L"))
    mask = np.where(arr > arr.mean(), 0, 255).astype(np.uint8)
    return (mask.astype(np.float32) / 255.0)[..., None]


def resize_normalize(img: Image.Image, size: Tuple[int, int], mask: bool = False,
                     as_uint8: bool = False) -> np.ndarray:
    """PIL bicubic resize to (W, H) ``size``; [H, W, 3 (+1)] float32 in [0, 1].

    The mask is computed from the resized image, as in the reference.  An
    image already at ``size`` skips the resize: PIL's bicubic kernel is the
    identity at integer positions, and TextZoom's pairs are stored at the
    target geometry.  ``as_uint8`` returns the uint8 array before the divide
    (mask channel in {0, 255}): the compact wire, divided by 255 on the
    device by the steps, which gives the same fp32 values.
    """
    if img.size != size:
        img = img.resize(size, Image.BICUBIC)
    if as_uint8:
        arr = np.asarray(img.convert("RGB"), np.uint8)
        if mask:
            gray = np.asarray(img.convert("L"))
            m = np.where(gray > gray.mean(), 0, 255).astype(np.uint8)
            arr = np.concatenate([arr, m[..., None]], axis=-1)
        return arr
    return normalize(img, mask)


def normalize(img: Image.Image, mask: bool = False) -> np.ndarray:
    """ToTensor without resizing (reference dataset.py:635-652)."""
    arr = np.asarray(img.convert("RGB"), np.float32) / 255.0
    if mask:
        arr = np.concatenate([arr, contour_mask(img)], axis=-1)
    return arr


def pil_downsample(img: Image.Image, factor: int) -> Image.Image:
    """Bicubic downsample by an integer factor (reference alignCollate_syn,
    dataset.py:984-986)."""
    return img.resize((img.size[0] // factor, img.size[1] // factor), Image.BICUBIC)


def resize_normalize_random_crop(img: Image.Image, size: Tuple[int, int], mask: bool = False,
                                 interval=None) -> np.ndarray:
    """Reference ``resizeNormalizeRandomCrop`` (dataset.py:656-688), which is
    ``resize_normalize`` on every path: its crop branch needs ``w >= 32``
    and no ``interval``, and there it crops nothing (the reference's
    ``if w < 32 or not interval is None``, kept as the JAX package keeps it,
    tpgsr_tpu/data/transforms.py:74-92)."""
    return resize_normalize(img, size, mask)


def resize_normalize_keep_ratio(img: Image.Image, size: Tuple[int, int],
                                mask: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Reference ``resizeNormalizeKeepRatio`` (dataset.py:689-763): resize to
    the target height keeping the aspect ratio and centre the result in the
    target width, zeros around it.  Returns (image [H, W, 3 (+1)], the valid
    region at twice the size [2H, 2W])."""
    tw, th = size
    ow, oh = img.size
    re_w = int(th * ow / float(oh))
    if re_w > tw:
        arr = resize_normalize(img, size, mask)
        valid = np.ones((th, tw), np.float32)
    else:
        small = img.resize((re_w, th), Image.BICUBIC)
        shift = (tw - re_w) // 2
        arr = np.zeros((th, tw, 3), np.float32)
        arr[:, shift : shift + re_w] = np.asarray(small.convert("RGB"), np.float32) / 255.0
        valid = np.zeros((th, tw), np.float32)
        valid[:, shift : shift + re_w] = 1.0
        if mask:
            full = np.zeros((th, tw, 1), np.float32)
            full[:, shift : shift + re_w] = contour_mask(small)
            arr = np.concatenate([arr, full], axis=-1)
    return arr, np.repeat(np.repeat(valid, 2, axis=0), 2, axis=1)
