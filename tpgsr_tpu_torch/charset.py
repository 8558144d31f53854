"""The 37-class CTC alphabet, label filtering and the attention recognizers'
vocabulary (counterpart of tpgsr_tpu/charset.py: ``CTC_CHARS``,
``CTC_NUM_CLASSES``, ``CTC_CHAR_TO_ID``, ``str_filt``, ``get_vocabulary``,
``char2id``, ``id2char``, ``AsterInfo``)."""

from __future__ import annotations

import string
from dataclasses import dataclass, field
from typing import Dict, List, Sequence

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


def get_vocabulary(voc_type: str, EOS: str = "EOS", PADDING: str = "PADDING", UNKNOWN: str = "UNKNOWN") -> List[str]:
    """The attention recognizers' vocabulary: the characters of ``voc_type``,
    then EOS, PADDING and UNKNOWN (reference utils/labelmaps.py:6-29)."""
    if voc_type not in _ALPHA_DICT:
        raise KeyError("voc_type Error")
    return list(_ALPHA_DICT[voc_type]) + [EOS, PADDING, UNKNOWN]


def char2id(voc: Sequence[str]) -> Dict[str, int]:
    return dict(zip(voc, range(len(voc))))


def id2char(voc: Sequence[str]) -> Dict[int, str]:
    return dict(zip(range(len(voc)), voc))


@dataclass
class AsterInfo:
    """Vocabulary of ASTER (reference interfaces/base.py:867-879): 97 classes
    for ``voc_type`` 'all', decoded up to ``max_len`` steps."""

    voc_type: str
    EOS: str = "EOS"
    PADDING: str = "PADDING"
    UNKNOWN: str = "UNKNOWN"
    max_len: int = 100
    voc: List[str] = field(default_factory=list)
    char2id: Dict[str, int] = field(default_factory=dict)
    id2char: Dict[int, str] = field(default_factory=dict)
    rec_num_classes: int = 0

    def __post_init__(self):
        self.voc = get_vocabulary(self.voc_type, self.EOS, self.PADDING, self.UNKNOWN)
        self.char2id = char2id(self.voc)
        self.id2char = id2char(self.voc)
        self.rec_num_classes = len(self.voc)
