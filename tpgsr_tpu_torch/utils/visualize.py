"""LR|SR|HR grids saved as PNGs (counterpart of
tpgsr_tpu/utils/visualize.py: ``tripple_display`` :41, ``test_display`` :67;
reference interfaces/base.py:488-544).

Images are NHWC numpy, float in [0, 1] or uint8 (the compact wire); the LR
image is bicubic-upscaled to the HR size and stacked above SR and HR.
"""

from __future__ import annotations

import os
from typing import Callable, Sequence

import numpy as np
from PIL import Image


def _to_pil(arr01: np.ndarray) -> Image.Image:
    a = np.asarray(arr01)[..., :3]
    if a.dtype == np.uint8:
        return Image.fromarray(a)
    a = np.clip(a, 0.0, 1.0)
    return Image.fromarray((a * 255.0 + 0.5).astype(np.uint8))


def _grid(lr: np.ndarray, sr: np.ndarray, hr: np.ndarray) -> Image.Image:
    h, w = hr.shape[0], hr.shape[1]
    canvas = Image.new("RGB", (w, 3 * h))
    canvas.paste(_to_pil(lr).resize((w, h), Image.BICUBIC), (0, 0))
    canvas.paste(_to_pil(sr), (0, h))
    canvas.paste(_to_pil(hr), (0, 2 * h))
    return canvas


# a file name's most bytes on common file systems, and a part's share of it
NAME_MAX = 255
NAME_PART_MAX = 80


def _name(pred_lr: str, pred_sr: str, label: str) -> str:
    """``<pred_lr>_<pred_sr>_<label>_.png`` without '/', as the JAX package
    names it; where that passes ``NAME_MAX`` bytes (a recognizer reading to
    its 100-character limit, where the JAX package's save fails), each part
    cut to ``NAME_PART_MAX`` bytes."""
    parts = [p.replace("/", "") for p in (pred_lr, pred_sr, label)]
    name = "_".join(parts) + "_.png"
    if len(name.encode()) > NAME_MAX:
        parts = [p.encode()[:NAME_PART_MAX].decode(errors="ignore") for p in parts]
        name = "_".join(parts) + "_.png"
    return name


def tripple_display(images_lr: np.ndarray, images_sr: np.ndarray, images_hr: np.ndarray,
                    pred_str_lr: Sequence[str], pred_str_sr: Sequence[str], label_strs: Sequence[str], index: int,
                    vis_dir: str, n_vis: int = 10, out_root: str = "./demo") -> None:
    """The first ``n_vis`` samples as grids in ``<out_root>/<vis_dir>/<index>/``
    (index 0 is skipped, as the reference does)."""
    if index == 0:
        return
    out = os.path.join(out_root, vis_dir, str(index))
    os.makedirs(out, exist_ok=True)
    for i in range(min(n_vis, images_lr.shape[0])):
        _grid(images_lr[i], images_sr[i], images_hr[i]).save(
            os.path.join(out, _name(pred_str_lr[i], pred_str_sr[i], label_strs[i])))


def test_display(images_lr: np.ndarray, images_sr: np.ndarray, images_hr: np.ndarray,
                 pred_str_lr: Sequence[str], pred_str_sr: Sequence[str], label_strs: Sequence[str],
                 str_filt: Callable[[str, str], str], vis_dir: str, out_root: str = "./display") -> int:
    """The samples that SR fixed (LR read wrong, SR right) as grids in
    ``<out_root>/<vis_dir>/``; returns their count."""
    out = os.path.join(out_root, vis_dir)
    os.makedirs(out, exist_ok=True)
    visualized = 0
    for i in range(images_lr.shape[0]):
        gt = str_filt(label_strs[i], "lower")
        if str_filt(pred_str_lr[i], "lower") != gt and str_filt(pred_str_sr[i], "lower") == gt:
            visualized += 1
            _grid(images_lr[i], images_sr[i], images_hr[i]).save(
                os.path.join(out, _name(pred_str_lr[i], pred_str_sr[i], label_strs[i])))
    return visualized
