"""Straight-through Gumbel softmax (counterpart of tpgsr_tpu/ops/gumbel.py;
reference model/gumbel_softmax.py:8-27).

The reference trainer imports it (super_resolution.py:28) and no path calls
it; it is here for the same ablations.  The noise comes from an explicit
``torch.Generator`` (the JAX package takes a PRNG key), or from the uniform
draws ``u`` given in its place, so that a caller can feed both packages the
same draws.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def sample_gumbel(shape, generator: Optional[torch.Generator] = None, eps: float = 1e-20,
                  u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gumbel(0, 1) noise of ``shape``: from the uniform [0, 1) draws ``u``
    where given, else drawn from ``generator`` on its device (the CPU's
    default generator without one), fp32."""
    if u is None:
        dev = generator.device if generator is not None else "cpu"
        u = torch.rand(shape, generator=generator, device=dev)
    return -torch.log(-torch.log(u + eps) + eps)


def gumbel_softmax_sample(logits: torch.Tensor, temperature: float, generator: Optional[torch.Generator] = None,
                          u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax((log_softmax(logits) + Gumbel noise) / temperature) over the
    last axis, the noise from ``u`` or ``generator`` (``sample_gumbel``)."""
    noise = sample_gumbel(logits.shape, generator, u=u).to(logits.device, logits.dtype)
    return F.softmax((F.log_softmax(logits, dim=-1) + noise) / temperature, dim=-1)


def gumbel_softmax(logits: torch.Tensor, temperature: float = 0.8, generator: Optional[torch.Generator] = None,
                   u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Straight-through: the one-hot of the soft sample's argmax forward, the
    soft sample's gradient backward."""
    y = gumbel_softmax_sample(logits, temperature, generator, u)
    y_hard = F.one_hot(y.argmax(dim=-1), y.shape[-1]).to(y.dtype)
    return (y_hard - y).detach() + y
