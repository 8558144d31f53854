"""Batch assembly for the TextZoom loaders (counterpart of
tpgsr_tpu/data/collate.py: ``CollateConfig`` :35, ``_xformed`` :66,
``_stack_pairs`` :85, ``collate_real`` :109, ``collate_real_wtl`` :122,
``collate_real_wtl_amask`` :136).

* ``collate_real`` is the reference ``alignCollate_real`` (dataset.py:1139-1152);
* ``collate_real_wtl`` is ``alignCollate_realWTL`` (:1155-1223), the TL val
  collate, with the reference's ``word[2] = 'e'`` on words longer than 4
  characters (:1176-1179), which reaches only the one-hot tensor;
* ``collate_real_wtl_amask`` is ``alignCollate_realWTLAMask`` (:1226-1323),
  the TL train collate: CTC labels padded to 15, their lengths, and
  ``weighted_tics``, 1 where a word has a label and 0 where it falls back to
  the blank.

Batches are dicts of numpy arrays and the ``labels`` list, as the JAX
package's: NHWC images ``hr`` [B, H, W, C] and ``lr`` [B, H/s, W/s, C],
``label_vecs`` [B, 1, 26, 37] padded to the CRNN's 26 frames.  The loader
(loader.py) turns the arrays into tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
from PIL import Image

from tpgsr_tpu_torch.charset import CTC_CHAR_TO_ID, CTC_NUM_CLASSES
from tpgsr_tpu_torch.data.transforms import resize_normalize, resize_normalize_keep_ratio


@dataclass(frozen=True)
class CollateConfig:
    imgH: int = 32
    imgW: int = 128
    down_sample_scale: int = 2
    mask: bool = False
    prior_len: int = 26  # the one-hot label tensor's pad, the CRNN's frames
    max_label_len: int = 15  # WTLAMask's truncation (reference dataset.py:1282)
    keep_ratio: bool = False  # aspect-preserving, centred resize
    # "uint8" ships images before the divide by 255 (mask channel {0, 255}),
    # a quarter of the bytes; the steps divide on the device
    wire_dtype: str = "float32"
    # keep each image's transformed array on the PIL image itself; with the
    # dataset's decode cache the same images recur every epoch, and epochs
    # after the first skip the resize and mask
    cache_transformed: bool = True
    # on the uint8 wire with the mask on, ship RGB and let the steps append
    # the mask channel on the device (ops.image.append_contour_mask_u8, the
    # same bytes)
    device_mask: bool = False


def _xformed(img: Image.Image, size, mask: bool, u8: bool, cache: bool) -> np.ndarray:
    """``resize_normalize`` of ``img``, cached on the image when ``cache``."""
    if not cache:
        return resize_normalize(img, size, mask, as_uint8=u8)
    store = getattr(img, "_tpgsr_xform", None)
    if store is None:
        store = {}
        try:
            img._tpgsr_xform = store
        except AttributeError:  # an image type without __dict__
            return resize_normalize(img, size, mask, as_uint8=u8)
    key = (size, mask, u8)
    arr = store.get(key)
    if arr is None:
        arr = resize_normalize(img, size, mask, as_uint8=u8)
        arr.setflags(write=False)  # shared across epochs
        store[key] = arr
    return arr


def _stack_pairs(batch, cfg: CollateConfig) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    lr_size = (cfg.imgW // cfg.down_sample_scale, cfg.imgH // cfg.down_sample_scale)
    hr_size = (cfg.imgW, cfg.imgH)
    u8 = cfg.wire_dtype == "uint8" and not cfg.keep_ratio
    # with device_mask the steps append the mask channel: the wire ships RGB
    want_mask = cfg.mask and not (u8 and cfg.device_mask)
    hrs, lrs, labels = [], [], []
    for img_hr, img_lr, label, *_ in batch:
        if cfg.keep_ratio:
            hr_arr, _ = resize_normalize_keep_ratio(img_hr, hr_size, cfg.mask)
            lr_arr, _ = resize_normalize_keep_ratio(img_lr, lr_size, cfg.mask)
        else:
            hr_arr = _xformed(img_hr, hr_size, want_mask, u8, cfg.cache_transformed)
            lr_arr = _xformed(img_lr, lr_size, want_mask, u8, cfg.cache_transformed)
        hrs.append(hr_arr)
        lrs.append(lr_arr)
        labels.append(label)
    return np.stack(hrs), np.stack(lrs), labels


def _onehot_rows(word: str) -> np.ndarray:
    ids = [CTC_CHAR_TO_ID[ch] for ch in word if ch in CTC_CHAR_TO_ID]
    vec = np.zeros((len(ids), CTC_NUM_CLASSES), np.float32)
    if ids:
        vec[np.arange(len(ids)), ids] = 1.0
    return vec


def collate_real(batch, cfg: CollateConfig) -> Dict:
    hr, lr, labels = _stack_pairs(batch, cfg)
    return {"hr": hr, "lr": lr, "labels": labels}


def collate_real_wtl(batch, cfg: CollateConfig) -> Dict:
    hr, lr, labels = _stack_pairs(batch, cfg)
    label_vecs = np.zeros((len(labels), 1, cfg.prior_len, CTC_NUM_CLASSES), np.float32)
    for i, word in enumerate(labels):
        word = word.lower()
        if len(word) > 4:
            word = word[:2] + "e" + word[3:]  # reference quirk (dataset.py:1176-1179)
        rows = _onehot_rows(word[: cfg.prior_len])
        label_vecs[i, 0, : rows.shape[0]] = rows
    return {"hr": hr, "lr": lr, "labels": labels, "label_vecs": label_vecs}


def collate_real_wtl_amask(batch, cfg: CollateConfig) -> Dict:
    hr, lr, labels = _stack_pairs(batch, cfg)
    b = len(labels)
    label_vecs = np.zeros((b, 1, cfg.prior_len, CTC_NUM_CLASSES), np.float32)
    ctc_labels = np.zeros((b, cfg.max_label_len), np.int32)
    ctc_lengths = np.zeros((b,), np.int32)
    weighted_tics = np.zeros((b,), np.float32)
    for i, word in enumerate(labels):
        word = word.lower()[: cfg.max_label_len]
        ids = [CTC_CHAR_TO_ID[ch] for ch in word if ch in CTC_CHAR_TO_ID]
        if ids:
            rows = _onehot_rows(word)
            label_vecs[i, 0, : rows.shape[0]] = rows
            ctc_labels[i, : len(ids)] = ids
            ctc_lengths[i] = len(ids)
            weighted_tics[i] = 1.0
        else:
            label_vecs[i, 0, 0, 0] = 1.0  # blank-label fallback (dataset.py:1305-1310)
    return {"hr": hr, "lr": lr, "labels": labels, "label_vecs": label_vecs, "ctc_labels": ctc_labels,
            "ctc_lengths": ctc_lengths, "weighted_tics": weighted_tics}


COLLATES = {
    "real": collate_real,
    "realWTL": collate_real_wtl,
    "realWTLAMask": collate_real_wtl_amask,
}
