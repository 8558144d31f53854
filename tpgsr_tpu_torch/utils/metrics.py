"""String-level metrics: exact-match accuracy, edit distance, their lexicon
variants and the sequence score of a decoded word (counterpart of
tpgsr_tpu/utils/metrics.py; reference utils/metrics.py:100-206,
``Accuracy``, ``Accuracy_with_lexicon``, ``EditDistance``,
``EditDistance_with_lexicon``, ``RecPostProcess``).

They score decoded strings (``ops.ctc.decode_crnn``,
``models.aster.decode_aster_ids``, ``models.moran.decode_moran_ids``): host
code, run once a batch.  The edit distance is a plain Levenshtein (the
reference's ``editdistance.eval`` gives the same value); the lexicon search
picks the lexicon word nearest the prediction by edit distance, the first
of equals, and a lexicon variant scores 0 for a file with no lexicon.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np


def levenshtein(a: str, b: str) -> int:
    """Edit distance: insertions, deletions and substitutions, each 1."""
    if a == b:
        return 0
    if not a or not b:
        return len(a) + len(b)
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def _lexicon_search(lexicon: Sequence[str], word: str) -> str:
    """The lexicon word nearest ``word``, lowercased (reference
    utils/metrics.py:93-97)."""
    dists = [levenshtein(word, w.lower()) for w in lexicon]
    return lexicon[int(np.argmin(dists))].lower()


def accuracy(pred_list: Sequence[str], targ_list: Sequence[str]) -> float:
    """Share of exact matches; 0 for no predictions."""
    if not pred_list:
        return 0.0
    return sum(p == t for p, t in zip(pred_list, targ_list)) / len(pred_list)


def edit_distance(pred_list: Sequence[str], targ_list: Sequence[str]) -> int:
    """Edit distance summed over the pairs."""
    return sum(levenshtein(p, t) for p, t in zip(pred_list, targ_list))


def _with_lexicon(fn, pred_list, targ_list, lexicons, file_names) -> list:
    """[fn of the predictions, then fn of the predictions each replaced by its
    file's nearest lexicon word, for each lexicon map]; 0 for a map that has
    no entry for the first file."""
    out = [fn(pred_list, targ_list)]
    for lex_map in lexicons:
        if not file_names or not lex_map or not lex_map.get(file_names[0]):
            out.append(0)
            continue
        out.append(fn([_lexicon_search(lex_map[f], p) for f, p in zip(file_names, pred_list)], targ_list))
    return out


def accuracy_with_lexicon(pred_list: Sequence[str], targ_list: Sequence[str],
                          lexicons50: Optional[Dict[str, List[str]]] = None,
                          lexicons1k: Optional[Dict[str, List[str]]] = None,
                          lexiconsfull: Optional[Dict[str, List[str]]] = None,
                          file_names: Sequence[str] = ()) -> List[float]:
    """[no lexicon, lexicon 50, 1k, full] accuracies; each lexicon maps a
    file name to its words."""
    return _with_lexicon(accuracy, pred_list, targ_list,
                         (lexicons50 or {}, lexicons1k or {}, lexiconsfull or {}), list(file_names))


def edit_distance_with_lexicon(pred_list: Sequence[str], targ_list: Sequence[str],
                               lexicons50: Optional[Dict[str, List[str]]] = None,
                               lexicons1k: Optional[Dict[str, List[str]]] = None,
                               lexiconsfull: Optional[Dict[str, List[str]]] = None,
                               file_names: Sequence[str] = ()) -> List[int]:
    """[no lexicon, lexicon 50, 1k, full] summed edit distances."""
    return _with_lexicon(edit_distance, pred_list, targ_list,
                         (lexicons50 or {}, lexicons1k or {}, lexiconsfull or {}), list(file_names))


def rec_post_process(pred_list: Sequence[str], scores, max_len_labels: int) -> List[float]:
    """Each word's sequence probability: the product of its per-step scores
    ``scores`` [B, steps] over its length plus the end symbol, at most
    ``max_len_labels`` steps."""
    scores = np.asarray(scores)
    out = []
    for i, pred in enumerate(pred_list):
        s = scores[i, : min(max_len_labels, len(pred) + 1)]
        out.append(math.exp(float(np.sum(np.log(np.maximum(s, 1e-30))))))
    return out
