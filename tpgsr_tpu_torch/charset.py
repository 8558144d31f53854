"""The 37-class CTC alphabet, label filtering, the attention recognizers'
vocabulary and the label converters (counterpart of tpgsr_tpu/charset.py:
``CTC_CHARS``, ``CTC_NUM_CLASSES``, ``CTC_CHAR_TO_ID``, ``str_filt``,
``get_vocabulary``, ``char2id``, ``id2char``, ``AsterInfo``,
``CTCLabelConverter``, ``encode_ctc_padded``, ``AttentionLabelConverter``,
``labels2strs``)."""

from __future__ import annotations

import string
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np

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


class CTCLabelConverter:
    """Strings to CTC labels and back, the blank at 0 (reference
    utils/utils_crnn.py:10-110, ``strLabelConverter``): a character maps to
    its index in ``alphabet`` plus 1."""

    def __init__(self, alphabet: str = CTC_ALPHABET):
        self.alphabet = alphabet + "-"  # index -1 of the reference's convention
        self.dict = {ch: i + 1 for i, ch in enumerate(alphabet)}

    def encode(self, text) -> Tuple[np.ndarray, np.ndarray]:
        """A string or a list of them -> (the ids of every character, one
        flat int32 array; each string's length)."""
        words = [text] if isinstance(text, str) else list(text)
        ids = [self.dict[ch] for ch in "".join(words)]
        return np.asarray(ids, np.int32), np.asarray([len(w) for w in words], np.int32)

    def decode(self, ids: Sequence[int], length: int, raw: bool = False) -> str:
        """The first ``length`` ids -> a string: every id with ``raw``, else
        greedy CTC (repeats merged, blanks dropped)."""
        ids = list(ids)[:length]
        if raw:
            return "".join(self.alphabet[i - 1] for i in ids)
        return "".join(self.alphabet[t - 1] for i, t in enumerate(ids) if t != 0 and not (i > 0 and ids[i - 1] == t))


def encode_ctc_padded(labels: Sequence[str], max_label_len: int,
                      char_to_id: Dict[str, int] = CTC_CHAR_TO_ID) -> Tuple[np.ndarray, np.ndarray]:
    """Strings -> ([B, max_label_len] int32 ids padded with the blank 0, [B]
    int32 lengths): each word lowercased, its characters outside
    ``char_to_id`` dropped, the rest cut to ``max_label_len``.  The
    reference concatenates the labels into one list (dataset/dataset.py:
    1284-1290); a fixed shape pads them."""
    batch = np.zeros((len(labels), max_label_len), np.int32)
    lengths = np.zeros((len(labels),), np.int32)
    for b, word in enumerate(labels):
        ids = [char_to_id[ch] for ch in word.lower() if ch in char_to_id][:max_label_len]
        batch[b, : len(ids)] = ids
        lengths[b] = len(ids)
    return batch, lengths


class AttentionLabelConverter:
    """Strings to the attention decoders' ids and back, each word ended by
    '$' (reference utils/utils_moran.py:6-150,
    ``strLabelConverterForAttention``): ``alphabet`` is split at ``sep``
    where it holds one, else taken character by character."""

    def __init__(self, alphabet: str = "0123456789abcdefghijklmnopqrstuvwxyz$", sep: str = ":"):
        self.alphabet = alphabet.split(sep) if sep in alphabet else list(alphabet)
        self.dict = {ch: i for i, ch in enumerate(self.alphabet)}

    def encode(self, text) -> Tuple[np.ndarray, np.ndarray]:
        """A string or a list of them -> (the flat int64 ids of every word
        lowercased with '$' appended, characters outside the alphabet
        dropped; each word's count of ids)."""
        flat, lengths = [], []
        for word in [text] if isinstance(text, str) else text:
            ids = [self.dict[ch] for ch in word.lower() + "$" if ch in self.dict]
            flat.extend(ids)
            lengths.append(len(ids))
        return np.asarray(flat, np.int64), np.asarray(lengths, np.int64)

    def decode(self, ids, lengths) -> List[str]:
        """Flat ids and each word's count -> the words, each cut at its first
        '$'."""
        ids, out, start = np.asarray(ids), [], 0
        for n in np.asarray(lengths):
            word = "".join(self.alphabet[int(i)] for i in ids[start : start + int(n)])
            out.append(word.split("$")[0])
            start += int(n)
        return out


def labels2strs(labels, id2char: Dict[int, str], char2id: Dict[str, int]) -> List[str]:
    """[B, L] ids -> one string a row, cut at its first EOS (reference
    utils/labelmaps.py:40-62)."""
    eos = char2id["EOS"]
    out = []
    for row in np.atleast_2d(np.asarray(labels)):
        chars = []
        for v in row:
            if int(v) == eos:
                break
            chars.append(id2char[int(v)])
        out.append("".join(chars))
    return out
