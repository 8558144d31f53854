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
  the blank;
* ``collate_c2f_real`` is ``alignCollatec2f_real`` (:1447-1482, tsrn_c2f's):
  ``coarse``, the mean of the HR and the LR resized to the HR size, at LR
  size (tpgsr_tpu/data/collate.py:248-264);
* ``collate_w2v_real`` is ``alignCollateW2V_real`` (:1414-1444, sem_tsrn's):
  ``w2v``, zero word vectors of width 300, the original's FastText being
  disabled (tpgsr_tpu/data/collate.py:267-275);
* ``collate_syn`` is ``alignCollate_syn`` (:901-992, ``--syn``; JAX :167):
  HR the single image resized, LR its bicubic downsample resized, float32
  with the mask channel whatever the wire says, and no CTC labels;
* ``collate_syn_random_reso`` is ``alignCollate_syn_random_reso``
  (:996-1089, ``--syn --random_reso``; JAX :193): no resize, ``hr_list``
  and ``lr_list`` of [1, H, W, C] arrays at each image's native size (the
  HR its bicubic x2), for the per-image evaluator (train/random_reso.py);
* ``collate_real_wtl_withcrop`` is ``alignCollate_realWTL_withcrop``
  (:1327-1411; JAX :210): the dash-spread one-hot prior of
  ``_dash_padded_onehot`` plus uniform(-0.1, 0.1) noise from ``rng``.

Batches are dicts of numpy arrays and the ``labels`` list, as the JAX
package's: NHWC images ``hr`` [B, H, W, C] and ``lr`` [B, H/s, W/s, C],
``label_vecs`` [B, 1, 26, 37] padded to the CRNN's 26 frames.  The loader
(loader.py) turns the arrays into tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
from PIL import Image

from tpgsr_tpu_torch.charset import CTC_CHAR_TO_ID, CTC_NUM_CLASSES, encode_ctc_padded
from tpgsr_tpu_torch.data.transforms import normalize, pil_downsample, resize_normalize, resize_normalize_keep_ratio


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
    words = [word.lower()[: cfg.max_label_len] for word in labels]
    ctc_labels, ctc_lengths = encode_ctc_padded(words, cfg.max_label_len)
    weighted_tics = (ctc_lengths > 0).astype(np.float32)
    for i, word in enumerate(words):
        if ctc_lengths[i]:
            rows = _onehot_rows(word)
            label_vecs[i, 0, : rows.shape[0]] = rows
        else:
            label_vecs[i, 0, 0, 0] = 1.0  # blank-label fallback (dataset.py:1305-1310)
    return {"hr": hr, "lr": lr, "labels": labels, "label_vecs": label_vecs, "ctc_labels": ctc_labels,
            "ctc_lengths": ctc_lengths, "weighted_tics": weighted_tics}


COLLATES = {
    "real": collate_real,
    "realWTL": collate_real_wtl,
    "realWTLAMask": collate_real_wtl_amask,
}


def collate_c2f_real(batch, cfg: CollateConfig) -> Dict:
    """``collate_real`` plus ``coarse`` [B, H/s, W/s, C] float in [0, 1]: the
    HR and the LR resized (PIL bicubic) to the HR size, averaged in fp32 and
    truncated to uint8, then ``resize_normalize``d to the LR size with the
    mask channel when ``mask`` (whatever the wire)."""
    hr, lr, labels = _stack_pairs(batch, cfg)
    lr_size = (cfg.imgW // cfg.down_sample_scale, cfg.imgH // cfg.down_sample_scale)
    coarse = []
    for img_hr, img_lr, *_ in batch:
        a = np.asarray(img_hr.convert("RGB"), np.float32)
        b = np.asarray(img_lr.resize(img_hr.size).convert("RGB"), np.float32)
        mid = Image.fromarray(((a + b) / 2.0).astype(np.uint8))
        coarse.append(resize_normalize(mid, lr_size, cfg.mask))
    return {"hr": hr, "lr": lr, "labels": labels, "coarse": np.stack(coarse)}


def collate_w2v_real(batch, cfg: CollateConfig) -> Dict:
    """``collate_real`` plus ``w2v`` [B, 300] zeros."""
    hr, lr, labels = _stack_pairs(batch, cfg)
    return {"hr": hr, "lr": lr, "labels": labels, "w2v": np.zeros((len(labels), 300), np.float32)}


def collate_syn(batch, cfg: CollateConfig) -> Dict:
    """Items (img, ..., label): ``hr`` the image ``resize_normalize``d to
    (imgW, imgH), ``lr`` its PIL bicubic downsample by the scale, resized to
    the LR size; float32 [B, H, W, 3 (+1)] in [0, 1] on any wire."""
    lr_size = (cfg.imgW // cfg.down_sample_scale, cfg.imgH // cfg.down_sample_scale)
    hrs, lrs, labels = [], [], []
    for item in batch:
        img, label = item[0], item[-1]
        hrs.append(resize_normalize(img, (cfg.imgW, cfg.imgH), cfg.mask))
        lrs.append(resize_normalize(pil_downsample(img, cfg.down_sample_scale), lr_size, cfg.mask))
        labels.append(label)
    return {"hr": np.stack(hrs), "lr": np.stack(lrs), "labels": labels}


def collate_syn_random_reso(batch, cfg: CollateConfig) -> Dict:
    """Items (img, ..., label): each image at its own size, unstacked.
    ``lr_list`` holds the image, ``hr_list`` its PIL bicubic resize to twice
    its width and height, each [1, H, W, 3 (+1)] float32 in [0, 1]."""
    hrs, lrs, labels = [], [], []
    for item in batch:
        img, label = item[0], item[-1] if isinstance(item[-1], str) else item[2]
        up = img.resize((img.size[0] * 2, img.size[1] * 2), Image.BICUBIC)
        hrs.append(normalize(up, cfg.mask)[None])
        lrs.append(normalize(img, cfg.mask)[None])
        labels.append(label)
    return {"hr_list": hrs, "lr_list": lrs, "labels": labels}


def _dash_padded_onehot(word: str, prior_len: int) -> np.ndarray:
    """[prior_len, 37] one-hot of ``word`` spread toward ``prior_len``
    characters (dataset.py:1360-1393): lowercased, 'e' at index 2 of a word
    longer than 4 (the reference's quirk), runs of '-' (the blank) between
    the characters of a word shorter than ``prior_len``, a longer one cut."""
    word = word.lower()
    if len(word) > 4:
        word = word[:2] + "e" + word[3:]
    if 1 < len(word) < prior_len:
        padding = (prior_len - len(word)) // max(len(word) - 1, 1)
        word = word[0] + "".join("-" * padding + ch for ch in word[1:])
    elif len(word) >= prior_len:
        word = word[:prior_len]
    ids = [CTC_CHAR_TO_ID[ch] for ch in word if ch in CTC_CHAR_TO_ID]
    vec = np.zeros((prior_len, CTC_NUM_CLASSES), np.float32)
    if ids:
        vec[np.arange(len(ids)), ids] = 1.0
    return vec


def collate_real_wtl_withcrop(batch, cfg: CollateConfig, rng: Optional[np.random.Generator] = None) -> Dict:
    """``collate_real`` plus ``label_vecs`` [B, 1, prior_len, 37]: each word's
    ``_dash_padded_onehot`` plus uniform(-0.1, 0.1) noise drawn from ``rng``
    (``np.random.default_rng(0)`` unless given).  The reference's crop
    intervals reach ``resize_normalize_random_crop``, which crops nothing."""
    rng = rng or np.random.default_rng(0)
    hr, lr, labels = _stack_pairs(batch, cfg)
    label_vecs = np.zeros((len(labels), 1, cfg.prior_len, CTC_NUM_CLASSES), np.float32)
    for i, word in enumerate(labels):
        label_vecs[i, 0] = _dash_padded_onehot(word, cfg.prior_len)
    label_vecs += (rng.random(label_vecs.shape).astype(np.float32) - 0.5) * 0.2
    return {"hr": hr, "lr": lr, "labels": labels, "label_vecs": label_vecs}


COLLATES.update({"c2f_real": collate_c2f_real, "W2V_real": collate_w2v_real, "syn": collate_syn,
                 "syn_random_reso": collate_syn_random_reso, "realWTL_withcrop": collate_real_wtl_withcrop})
