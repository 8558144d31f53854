"""The 37-class CTC alphabet and label filtering (counterpart of
tpgsr_tpu/charset.py: ``CTC_CHARS``, ``CTC_NUM_CLASSES``, ``CTC_CHAR_TO_ID``,
``str_filt``)."""

from __future__ import annotations

import string
from typing import Dict

# Index 0 is the CTC blank ('-') (reference dataset/dataset.py:917-918).
CTC_ALPHABET = "0123456789abcdefghijklmnopqrstuvwxyz"
CTC_CHARS = "-" + CTC_ALPHABET
CTC_NUM_CLASSES = len(CTC_CHARS)  # 37
CTC_CHAR_TO_ID: Dict[str, int] = {ch: i for i, ch in enumerate(CTC_CHARS)}

_ALPHA_DICT = {
    "digit": string.digits,
    "lower": string.digits + string.ascii_lowercase,
    "upper": string.digits + string.ascii_letters,
    "all": string.digits + string.ascii_letters + string.punctuation,
}


def str_filt(s: str, voc_type: str) -> str:
    """Drop characters outside the vocabulary; lowercase first for
    ``voc_type='lower'`` (reference utils/util.py:12-25)."""
    if voc_type == "lower":
        s = s.lower()
    allowed = _ALPHA_DICT[voc_type]
    return "".join(ch for ch in s if ch in allowed)
