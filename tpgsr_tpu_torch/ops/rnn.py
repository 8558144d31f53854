"""Plain PyTorch bidirectional GRU (counterpart of tpgsr_tpu/ops/rnn.py).

``bigru`` is the plain version of kernel K1 (``ops.gru_seq``): the CPU path,
and what ``chip_smoke.py`` holds the kernel against on the card.  Gate math
and weight layout are torch's (order r, z, n; ``b_hn`` inside the r
product), so ``nn.GRU`` checkpoints load unchanged:

    r = sigmoid(x W_ir + b_ir + h W_hr + b_hr)
    z = sigmoid(x W_iz + b_iz + h W_hz + b_hz)
    n = tanh(x W_in + b_in + r * (h W_hn + b_hn))
    h' = (1 - z) * n + z * h

Weights per direction: ``w_ih`` [3H, C], ``w_hh`` [3H, H], ``b_ih`` and
``b_hh`` [3H].  The CRNN's BiLSTM is ``nn.LSTM`` (models/crnn.py).

``bigru_recurrence_backward`` is the plain version of K1's backward kernel
(``csrc/bigru_seq_bwd.cu``): BPTT of ``bigru_recurrence``, step by step.

``pad_hidden`` and ``unpad_output`` are how K1's wrapper runs a hidden size
between its kernels' sizes on the card (``ops.gru_seq.padded_hidden``):
zero units appended to each gate, their outputs sliced away.  A padded unit
sees xp = 0 and hp = 0, so r = z = sigmoid(0) = 1/2, n = tanh(0) = 0 and
h = 0 at every step, and its zero columns of W_hh feed nothing into the real
units; its gradients are exactly 0 too.  The CPU tests run the plain
recurrence so; the CPU path itself runs the real size.

Both recurrences take ``xp`` (and ``out``, ``grad_out``) in fp32 or bf16 and
compute in fp32 from those values, with W_hh and b_hh rounded to xp's dtype
(``rounded_to``), as the JAX layers cast weights to the activation dtype:
the state, the gates and every sum are fp32, as in the TPU kernel
(tpgsr_tpu/ops/pallas_gru.py:52-65), and only the outputs ``out`` and
``dxp`` are rounded to xp's dtype.  ``torch.autocast`` does not reach them.
The input projection runs in x's dtype.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

Params = Dict[str, torch.Tensor]


def rounded_to(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t``'s values rounded to ``dtype``, held in fp32 (``t`` itself when
    it is fp32 and ``dtype`` too)."""
    return t.to(dtype).float()


def bf16_split3(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """fp32 ``x`` as three bf16 terms, the largest first, each the rounding of
    what the earlier ones leave: x = t1 + t2 + t3 exactly (8 + 8 + 8
    significant bits, fp32's 24) for |x| >= 2^-110 and for zeros; below, the
    last term's bits under bf16's least subnormal (2^-133) are lost, within
    2^-134.  The plain version of how K1's bf16 kernels put an fp32 operand
    (the forward's h, the backward's dhp) on the tensor cores: each term's
    products with bf16 weights are exact in fp32."""
    rest = x.float()
    terms = []
    for _ in range(3):
        terms.append(rest.to(torch.bfloat16))
        rest = rest - terms[-1].float()
    return terms[0], terms[1], terms[2]


def input_projection(x: torch.Tensor, fw: Params, bw: Params) -> torch.Tensor:
    """[N, T, C] -> [N, T, 6H] in x's dtype: both directions' input
    projections in one matmul (fw gates r,z,n then bw gates r,z,n), outside
    the recurrence as at tpgsr_tpu/ops/pallas_gru.py:77-80, with the weights
    cast to x's dtype."""
    n, t, c = x.shape
    w_ih = torch.cat([fw["w_ih"], bw["w_ih"]], 0).to(x.dtype)  # [6H, C]
    b_ih = torch.cat([fw["b_ih"], bw["b_ih"]], 0).to(x.dtype)
    return torch.addmm(b_ih, x.reshape(n * t, c), w_ih.t()).view(n, t, -1)


def bigru_recurrence(xp: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor) -> torch.Tensor:
    """The recurrence K1 computes: ``xp`` [N, T, 6H] (from
    ``input_projection``), ``w_hh`` [2, 3H, H], ``b_hh`` [2, 3H] -> [N, T, 2H]
    in xp's dtype, from h0 = 0, forward direction over t = 0..T-1, backward
    over T-1..0; fp32 state and arithmetic."""
    with torch.autocast(xp.device.type, enabled=False):
        return _recurrence(xp.float(), rounded_to(w_hh, xp.dtype), rounded_to(b_hh, xp.dtype), xp.dtype)


def _recurrence(xp: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    n, t, g6 = xp.shape
    h = g6 // 6
    state = xp.new_zeros(2, n, h)
    out = xp.new_empty(n, t, 2 * h, dtype=out_dtype)
    for step in range(t):
        x_step = torch.stack([xp[:, step, : 3 * h], xp[:, t - 1 - step, 3 * h :]])
        hp = torch.baddbmm(b_hh[:, None, :], state, w_hh.transpose(1, 2))  # [2, N, 3H]
        xr, xz, xn = x_step.split(h, -1)
        hr, hz, hn = hp.split(h, -1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n_gate = torch.tanh(xn + r * hn)
        state = (1.0 - z) * n_gate + z * state
        out[:, step, :h] = state[0]
        out[:, t - 1 - step, h:] = state[1]
    return out


def bigru_recurrence_backward(xp: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor, out: torch.Tensor,
                              grad_out: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """BPTT of ``bigru_recurrence``: ``out`` is its output (every hidden
    state, so h_{t-1} is read, not stored), ``grad_out`` [N, T, 2H] the
    gradient of the loss with respect to it.  Returns (dxp [N, T, 6H] in
    xp's dtype, dw_hh [2, 3H, H] and db_hh [2, 3H] in fp32),
    computed in fp32 from the stored values (in bf16, h_{t-1} as ``out``
    rounded it).  Each direction runs its steps in reverse, recomputing the
    gates from h_{t-1}:

        dh = grad_out_t + dh_next;  dn = dh (1 - z);  dz = dh (h_{t-1} - n)
        dn^ = dn (1 - n^2);  dr^ = dn^ hn r (1 - r);  dz^ = dz z (1 - z)
        dxp_t = [dr^, dz^, dn^];  dhp_t = [dr^, dz^, dn^ r]
        dh_next = dh z + dhp_t W_hh;  dW_hh += dhp_t^T h_{t-1};  db_hh += dhp_t
    """
    with torch.autocast(xp.device.type, enabled=False):
        dxp, dw_hh, db_hh = _recurrence_backward(xp.float(), rounded_to(w_hh, xp.dtype), rounded_to(b_hh, xp.dtype),
                                                 out.float(), grad_out.float())
    return dxp.to(xp.dtype), dw_hh, db_hh


def _recurrence_backward(xp: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor, out: torch.Tensor,
                         grad_out: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    n, t, g6 = xp.shape
    h = g6 // 6
    dxp = torch.empty_like(xp)
    dw_hh = torch.zeros_like(w_hh)
    db_hh = torch.zeros_like(b_hh)
    dh_next = xp.new_zeros(2, n, h)
    zeros = xp.new_zeros(n, h)
    for step in reversed(range(t)):
        tf, tb = step, t - 1 - step  # the time each direction reaches at this step
        x_step = torch.stack([xp[:, tf, : 3 * h], xp[:, tb, 3 * h :]])
        h_prev = torch.stack([out[:, tf - 1, :h] if step else zeros, out[:, tb + 1, h:] if step else zeros])
        hp = torch.baddbmm(b_hh[:, None, :], h_prev, w_hh.transpose(1, 2))  # [2, N, 3H]
        xr, xz, xn = x_step.split(h, -1)
        hr, hz, hn = hp.split(h, -1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n_gate = torch.tanh(xn + r * hn)
        dh = torch.stack([grad_out[:, tf, :h], grad_out[:, tb, h:]]) + dh_next
        dn_hat = dh * (1.0 - z) * (1.0 - n_gate * n_gate)
        dr_hat = dn_hat * hn * r * (1.0 - r)
        dz_hat = dh * (h_prev - n_gate) * z * (1.0 - z)
        dx_step = torch.cat([dr_hat, dz_hat, dn_hat], -1)
        dhp = torch.cat([dr_hat, dz_hat, dn_hat * r], -1)  # [2, N, 3H]
        dxp[:, tf, : 3 * h] = dx_step[0]
        dxp[:, tb, 3 * h :] = dx_step[1]
        dw_hh += torch.bmm(dhp.transpose(1, 2), h_prev)
        db_hh += dhp.sum(1)
        dh_next = dh * z + torch.bmm(dhp, w_hh)
    return dxp, dw_hh, db_hh


def pad_hidden(params: Params, hidden: int) -> Params:
    """One direction's ``w_ih`` [3H, C], ``w_hh`` [3H, H], ``b_ih``, ``b_hh``
    [3H] with zero units appended to each gate up to ``hidden``: [3Hp, C],
    [3Hp, Hp], [3Hp].  Differentiable, so autograd returns the gradients at
    the real shapes."""
    h = params["w_hh"].shape[-1]
    if hidden < h:
        raise ValueError(f"cannot pad hidden size {h} to {hidden}")
    extra = hidden - h

    def rows(t: torch.Tensor) -> torch.Tensor:  # [3H, ...] -> [3Hp, ...], zeros after each gate's H rows
        g = t.reshape(3, h, -1)
        return torch.nn.functional.pad(g, (0, 0, 0, extra)).reshape(3 * hidden, *t.shape[1:])

    return {"w_ih": rows(params["w_ih"]),
            "w_hh": torch.nn.functional.pad(rows(params["w_hh"]), (0, extra)),
            "b_ih": rows(params["b_ih"]), "b_hh": rows(params["b_hh"])}


def unpad_output(out: torch.Tensor, hidden: int) -> torch.Tensor:
    """[N, T, 2Hp] -> [N, T, 2H]: each direction's first ``hidden`` units."""
    hp = out.shape[-1] // 2
    return torch.cat([out[..., :hidden], out[..., hp:hp + hidden]], -1)


def bigru(x: torch.Tensor, fw: Params, bw: Params) -> torch.Tensor:
    """Bidirectional GRU [N, T, C] -> [N, T, 2H] (``nn.GRU(bidirectional=True,
    batch_first=True)`` semantics)."""
    xp = input_projection(x, fw, bw)
    w_hh = torch.stack([fw["w_hh"], bw["w_hh"]])
    b_hh = torch.stack([fw["b_hh"], bw["b_hh"]])
    return bigru_recurrence(xp, w_hh, b_hh)
