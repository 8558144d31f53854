"""Greedy CTC decoding and the CTC loss (counterpart of
tpgsr_tpu/ops/ctc.py:28-84).

Decoding mirrors the reference's ``get_string_crnn`` (utils/metrics.py:71-88):
argmax per frame, collapse repeats, drop blanks, and reset the repeat
tracker after a blank, so 'aa-aa' decodes to 'aa'.  The loss is the JAX
package's: ``optax.ctc_loss`` on padded labels (tpgsr_tpu/ops/ctc.py:56-84),
which equals the reference's ``nn.CTCLoss(blank=0, reduction='none')``
(interfaces/super_resolution.py:40,355-366) wherever an alignment exists.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

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


class _LogAddExp(torch.autograd.Function):
    """``log(exp(a) + exp(b))`` with JAX's derivative, ``exp(a - out)``
    (jax/_src/lax/other.py, ``_logaddexp_jvp``).  torch's own derivative,
    a sigmoid of ``b - a``, is the more accurate one; near ``log_epsilon``
    the two differ by ~1 %, as ``out`` keeps only ~0.008 of a value near
    -1e5 in fp32, and the port is held to the JAX package's gradient."""

    @staticmethod
    def forward(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        out = torch.maximum(a, b) + torch.log1p(torch.exp(-torch.abs(a - b)))
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        a, b, out = ctx.saved_tensors
        return grad * torch.exp(a - out), grad * torch.exp(b - out)


def ctc_loss(logits_tbc: torch.Tensor, labels_bl: torch.Tensor, label_lengths: torch.Tensor, blank_id: int = 0,
             log_epsilon: float = -1e5) -> torch.Tensor:
    """Per-sample CTC negative log likelihood [B], summed over the label (not
    divided by its length); the caller masks by ``weighted_tics`` and means.

    ``logits_tbc`` [T, B, C] unnormalised; ``labels_bl`` [B, L] padded with
    0, the blank; ``label_lengths`` [B]; every sample has all T frames.

    The forward algorithm of ``optax.ctc_loss_with_forward_probs``, as the
    JAX package calls it (zero logit paddings, label paddings from the
    lengths): log space, with ``log_epsilon`` standing for log 0.  The
    lattice is the L + 1 blank states ``phi`` and the L label states
    ``emit`` (2L + 1 in all), stepped over the T frames; autograd gives the
    gradient, with JAX's derivative of ``logaddexp``.  A label that no alignment fits into T frames gives a large
    finite loss (about ``-log_epsilon``), not ``inf``, as in the JAX package.
    """
    t, b, _ = logits_tbc.shape
    n = labels_bl.shape[1]
    logprobs = torch.log_softmax(logits_tbc, -1)
    labels = labels_bl.long()
    lengths = label_lengths.long().clamp(max=n)
    # repeat[b, i] is 1 where label i equals label i + 1 (0 at the last)
    repeat = logprobs.new_zeros(b, n)
    repeat[:, :-1] = (labels[:, :-1] == labels[:, 1:]).to(repeat.dtype)
    logprob_phi = logprobs[:, :, blank_id : blank_id + 1]  # [T, B, 1]
    logprob_emit = torch.gather(logprobs, 2, labels.unsqueeze(0).expand(t, b, n))  # [T, B, L]

    def add_to_phi(phi: torch.Tensor, score: torch.Tensor) -> torch.Tensor:
        return torch.cat([phi[:, :1], _LogAddExp.apply(phi[:, 1:], score)], 1)

    phi = logprobs.new_full((b, n + 1), log_epsilon)
    phi[:, 0] = 0.0
    emit = logprobs.new_full((b, n), log_epsilon)
    for s in range(t):
        # emit-to-phi epsilon transition, except into a repeated label
        prev_phi = add_to_phi(phi, emit + log_epsilon * repeat)
        next_emit = _LogAddExp.apply(prev_phi[:, :-1] + logprob_emit[s], emit + logprob_emit[s])
        # the blank's self-loop, and emit-to-phi on a blank before a repeat
        next_phi = add_to_phi(prev_phi + logprob_phi[s], emit + logprob_phi[s] + log_epsilon * (1.0 - repeat))
        phi, emit = next_phi, next_emit
    last_phi = add_to_phi(phi, emit)
    return -last_phi.gather(1, lengths.unsqueeze(1)).squeeze(1)
