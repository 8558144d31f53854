"""Greedy CTC decoding and the CTC loss (counterpart of
tpgsr_tpu/ops/ctc.py:28-84).

Decoding mirrors the reference's ``get_string_crnn`` (utils/metrics.py:71-88):
argmax per frame, collapse repeats, drop blanks, and reset the repeat
tracker after a blank, so 'aa-aa' decodes to 'aa'.  The loss is the
reference's ``nn.CTCLoss(blank=0, reduction='none')``
(interfaces/super_resolution.py:40,355-366) on padded labels.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from tpgsr_tpu_torch.charset import CTC_CHARS


def ctc_greedy_ids(logits_tbc: torch.Tensor) -> torch.Tensor:
    """Per-frame argmax ids of [T, B, C] logits -> [T, B]."""
    return torch.argmax(logits_tbc, dim=-1)


def ctc_ids_to_strings(ids_tb: np.ndarray, alphabet: str = CTC_CHARS) -> List[str]:
    out = []
    for row in np.asarray(ids_tb).T:
        s = []
        last = ""
        for i in row:
            ch = alphabet[int(i)]
            if ch != last:
                if int(i) != 0:
                    s.append(ch)
                    last = ch
                else:
                    last = ""
        out.append("".join(s))
    return out


def decode_crnn(logits_tbc: torch.Tensor) -> List[str]:
    return ctc_ids_to_strings(ctc_greedy_ids(logits_tbc).cpu().numpy())


def ctc_loss(logits_tbc: torch.Tensor, labels_bl: torch.Tensor, label_lengths: torch.Tensor) -> torch.Tensor:
    """Per-sample CTC negative log likelihood [B], summed over the label (not
    divided by its length); the caller masks by ``weighted_tics`` and means.

    ``logits_tbc`` [T, B, C] unnormalised; ``labels_bl`` [B, L] padded with
    0, the blank; ``label_lengths`` [B]; every sample has all T frames.  A label that no
    alignment fits into T frames (its length plus its repeated neighbours
    above T) gives ``inf``, as ``nn.CTCLoss`` does without
    ``zero_infinity``; the JAX package (optax) gives a large finite value
    there instead.
    """
    t, b = logits_tbc.shape[:2]
    input_lengths = torch.full((b,), t, dtype=torch.long, device=logits_tbc.device)
    return F.ctc_loss(torch.log_softmax(logits_tbc, -1), labels_bl.long(), input_lengths, label_lengths.long(),
                      blank=0, reduction="none")
