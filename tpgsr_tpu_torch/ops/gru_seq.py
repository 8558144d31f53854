"""K1's wrapper: the bidirectional GRU with the recurrence and its BPTT as
CUDA kernels.

Counterpart of tpgsr_tpu/ops/pallas_gru.py (``bigru_pallas``).  The kernel
sources are ``csrc/bigru_seq.cu`` (forward) and ``csrc/bigru_seq_bwd.cu``
(backward); their plain versions are ``ops.rnn.bigru_recurrence`` and
``ops.rnn.bigru_recurrence_backward``.

* A tensor on the CPU takes the plain versions, for that reason only.
* A CUDA tensor launches the kernels or raises; nothing falls back.
* ``LAUNCHES`` and ``BACKWARD_LAUNCHES`` count kernel launches, so a run can
  show that its main path went through the kernels.
* Each kernel's launch configuration (rows a thread, grid) comes from
  ``launch_config``, a pure function of the shape and the card's limits,
  fed that kernel's own occupancy.
* The backward kernel writes dxp, and dhp and h_{t-1} laid out per
  direction; dW_hh and db_hh are one batched GEMM and one sum outside it
  (``recurrent_weight_grads``), and the input projection's gradients come
  from autograd of its addmm.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Mapping, NamedTuple, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from tpgsr_tpu_torch.ops import rnn
from tpgsr_tpu_torch.ops.rnn import Params

LAUNCHES = 0
BACKWARD_LAUNCHES = 0
SUPPORTED_HIDDEN = (8, 16, 32)
THREADS = 128  # threads a block: H hidden units x 128 / H row groups
RPTS = (1, 2, 4)  # rows a thread, the kernel's instantiations
RING_STAGES = 4  # steps of xp in the kernel's shared-memory ring (kStages)
GEMM_CHUNK = 256  # row-steps a batch of the dW_hh GEMM sums over
_PARAM_KEYS = ("w_ih", "w_hh", "b_ih", "b_hh")


class LaunchConfig(NamedTuple):
    rpt: int  # rows a thread
    blocks: int  # grid size, both directions
    blocks_per_sm: int
    waves: int


def launch_config(n: int, hidden: int, sms: int, blocks_per_sm: Mapping[int, int]) -> LaunchConfig:
    """The smallest rows-a-thread whose grid of ``2 * ceil(n / rows)`` blocks
    fits one wave of ``sms * blocks_per_sm[rpt]``; the largest when none does."""
    if n < 1 or hidden not in SUPPORTED_HIDDEN:
        raise ValueError(f"need n >= 1 and hidden in {SUPPORTED_HIDDEN}, got n={n} hidden={hidden}")
    for rpt in RPTS:
        if blocks_per_sm[rpt] < 1:
            raise ValueError(f"K1 at hidden {hidden}, {rpt} rows a thread fits no block on an SM")
    configs = []
    for rpt in RPTS:
        rows = THREADS // hidden * rpt
        blocks = 2 * -(-n // rows)
        per_wave = sms * blocks_per_sm[rpt]
        configs.append(LaunchConfig(rpt, blocks, blocks_per_sm[rpt], -(-blocks // per_wave)))
    return next((c for c in configs if c.waves == 1), configs[-1])


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from tpgsr_tpu_torch.ops import _build

    lib = _build.load("bigru_seq")
    lib.tpgsr_bigru_seq_forward.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.tpgsr_bigru_seq_forward.restype = ctypes.c_int
    lib.tpgsr_bigru_seq_occupancy.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)]
    lib.tpgsr_bigru_seq_occupancy.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    from tpgsr_tpu_torch.ops import _build

    lib = _build.load("bigru_seq_bwd")
    lib.tpgsr_bigru_seq_backward.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.tpgsr_bigru_seq_backward.restype = ctypes.c_int
    lib.tpgsr_bigru_seq_backward_occupancy.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)]
    lib.tpgsr_bigru_seq_backward_occupancy.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _device_limits(index: int, hidden: int, backward: bool) -> Tuple[int, Tuple[Tuple[int, int], ...]]:
    """(SMs, ((rpt, resident blocks an SM), ...)) of card ``index`` for the
    forward kernel, or the backward's with ``backward``."""
    query = _bwd_lib().tpgsr_bigru_seq_backward_occupancy if backward else _lib().tpgsr_bigru_seq_occupancy
    occupancy = []
    with torch.cuda.device(index):
        for rpt in RPTS:
            blocks = ctypes.c_int(0)
            err = query(hidden, rpt, ctypes.byref(blocks))
            if err != 0:
                raise RuntimeError(f"K1 occupancy query failed: cudaError {err}")
            occupancy.append((rpt, blocks.value))
    return torch.cuda.get_device_properties(index).multi_processor_count, tuple(occupancy)


def config_for(n: int, hidden: int, device: torch.device, backward: bool = False) -> LaunchConfig:
    """The launch configuration K1's forward (or, with ``backward``, its
    backward) takes for ``n`` rows on CUDA ``device``."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return _config(index, n, hidden, backward)


@functools.lru_cache(maxsize=1024)
def _config(index: int, n: int, hidden: int, backward: bool) -> LaunchConfig:
    sms, occupancy = _device_limits(index, hidden, backward)
    return launch_config(n, hidden, sms, dict(occupancy))


def _check(x: torch.Tensor, fw: Params, bw: Params) -> None:
    if x.dim() != 3:
        raise ValueError(f"x must be [N, T, C], got shape {tuple(x.shape)}")
    n, t, c = x.shape
    if n == 0 or t == 0:
        raise ValueError(f"x must have N >= 1 and T >= 1, got shape {tuple(x.shape)}")
    h = fw["w_hh"].shape[-1]
    want = {"w_ih": (3 * h, c), "w_hh": (3 * h, h), "b_ih": (3 * h,), "b_hh": (3 * h,)}
    for d in (fw, bw):
        for k in _PARAM_KEYS:
            p = d[k]
            if tuple(p.shape) != want[k]:
                raise ValueError(f"{k} must have shape {want[k]}, got {tuple(p.shape)}")
            if p.device != x.device or p.dtype != x.dtype:
                raise ValueError(f"{k} is {p.dtype} on {p.device}; x is {x.dtype} on {x.device}")


def _recurrence(xp: torch.Tensor, w_t: torch.Tensor, b_hh: torch.Tensor,
                config: Optional[LaunchConfig] = None) -> torch.Tensor:
    """Run K1 on [N, T, 6H] projections with ``w_t`` [2, H, 3H] (W_hh
    transposed per direction); returns [N, T, 2H].  ``config`` overrides
    ``config_for`` (the tests use it to reach every instantiation)."""
    global LAUNCHES
    n, t, g6 = xp.shape
    h = g6 // 6
    if xp.dtype != torch.float32:
        raise TypeError(f"K1 takes float32, got {xp.dtype}")
    if h not in SUPPORTED_HIDDEN:
        raise ValueError(f"K1 supports hidden sizes {SUPPORTED_HIDDEN}, got {h}")
    if tuple(w_t.shape) != (2, h, 3 * h) or tuple(b_hh.shape) != (2, 3 * h):
        raise ValueError(f"w_t must be {(2, h, 3 * h)} and b_hh {(2, 3 * h)}, "
                         f"got {tuple(w_t.shape)} and {tuple(b_hh.shape)}")
    for name, tensor in (("xp", xp), ("w_t", w_t), ("b_hh", b_hh)):
        if not tensor.is_contiguous() or tensor.device != xp.device or tensor.dtype != xp.dtype:
            raise ValueError(f"{name} must be contiguous {xp.dtype} on {xp.device}")
    if xp.data_ptr() % 16:
        raise ValueError("xp must be 16-byte aligned (the kernel copies it 16 bytes a thread)")
    if config is None:
        config = config_for(n, h, xp.device)
    fn = _lib().tpgsr_bigru_seq_forward
    out = torch.empty(n, t, 2 * h, device=xp.device, dtype=xp.dtype)
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream(xp.device).cuda_stream
        err = fn(xp.data_ptr(), w_t.data_ptr(), b_hh.data_ptr(), out.data_ptr(), n, t, h, config.rpt, stream)
    if err != 0:
        raise RuntimeError(f"K1 bigru_seq launch failed: cudaError {err}")
    LAUNCHES += 1
    return out


def _launch(xp: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor) -> torch.Tensor:
    """Run K1 on [N, T, 6H] projections with ``w_hh`` [2, 3H, H] in torch
    layout; returns [N, T, 2H]."""
    return _recurrence(xp, w_hh.transpose(1, 2).contiguous(), b_hh)


def _chunk_rows(t: int) -> int:
    """Rows a batch of the dW_hh GEMM: about GEMM_CHUNK row-steps."""
    return max(1, GEMM_CHUNK // t)


def _backward_kernel(xp: torch.Tensor, w_t: torch.Tensor, b_hh: torch.Tensor, out: torch.Tensor,
                     grad_out: torch.Tensor, config: Optional[LaunchConfig] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run K1's backward kernel: ``xp`` [N, T, 6H], ``w_t`` [2, H, 3H], ``b_hh``
    [2, 3H], the forward's ``out`` and ``grad_out`` [N, T, 2H] -> (dxp [N, T,
    6H], dhp [2, Np, T, 3H], h_{t-1} [2, Np, T, H]), N padded with zero rows
    to Np, a multiple of the GEMM's chunk of rows.  ``config`` overrides
    ``config_for(..., backward=True)`` (the tests use it to reach every
    instantiation)."""
    global BACKWARD_LAUNCHES
    n, t, g6 = xp.shape
    h = g6 // 6
    if xp.dtype != torch.float32:
        raise TypeError(f"K1's backward takes float32, got {xp.dtype}")
    if h not in SUPPORTED_HIDDEN:
        raise ValueError(f"K1 supports hidden sizes {SUPPORTED_HIDDEN}, got {h}")
    want = {"w_t": (2, h, 3 * h), "b_hh": (2, 3 * h), "out": (n, t, 2 * h), "grad_out": (n, t, 2 * h)}
    for name, tensor in (("xp", xp), ("w_t", w_t), ("b_hh", b_hh), ("out", out), ("grad_out", grad_out)):
        if name in want and tuple(tensor.shape) != want[name]:
            raise ValueError(f"{name} must have shape {want[name]}, got {tuple(tensor.shape)}")
        if not tensor.is_contiguous() or tensor.device != xp.device or tensor.dtype != xp.dtype:
            raise ValueError(f"{name} must be contiguous {xp.dtype} on {xp.device}")
        if tensor.data_ptr() % 4:
            raise ValueError(f"{name} must be 4-byte aligned (the kernel reads fp32 scalars)")
    if config is None:
        config = config_for(n, h, xp.device, backward=True)
    rows = _chunk_rows(t)
    n_pad = -(-n // rows) * rows
    if (n_pad + 64) * t * 6 * h >= 2**31:
        raise ValueError(f"K1's backward indexes with 32-bit offsets: N={n}, T={t}, H={h} is too large")
    dxp = torch.empty_like(xp)
    dhp = xp.new_empty(2, n_pad, t, 3 * h)
    h_prev = xp.new_empty(2, n_pad, t, h)
    if n_pad > n:
        dhp[:, n:].zero_()
        h_prev[:, n:].zero_()
    fn = _bwd_lib().tpgsr_bigru_seq_backward
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream(xp.device).cuda_stream
        err = fn(xp.data_ptr(), w_t.data_ptr(), b_hh.data_ptr(), out.data_ptr(), grad_out.data_ptr(),
                 dxp.data_ptr(), dhp.data_ptr(), h_prev.data_ptr(), n, n_pad, t, h, config.rpt, stream)
    if err != 0:
        raise RuntimeError(f"K1 bigru_seq backward launch failed: cudaError {err}")
    BACKWARD_LAUNCHES += 1
    return dxp, dhp, h_prev


def recurrent_weight_grads(dhp: torch.Tensor, h_prev: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """dW_hh [2, 3H, H] = sum_t dhp_t^T h_{t-1} and db_hh [2, 3H] = sum_t dhp_t
    from ``dhp`` [2, Np, T, 3H] and ``h_prev`` [2, Np, T, H].  Both sums run
    over chunks of ``_chunk_rows`` rows (one chunk when they do not divide
    Np), then over the chunks: summed whole, a [3H, Np*T] x [Np*T, H] product
    is one output tile that cuBLAS runs on a handful of SMs, and a reduction
    to 2 x 3H outputs has as little parallelism."""
    _, n_pad, t, g3 = dhp.shape
    h = h_prev.shape[-1]
    rows = _chunk_rows(t) if n_pad % _chunk_rows(t) == 0 else n_pad
    chunks = dhp.reshape(2 * n_pad // rows, rows * t, g3)
    dw_hh = torch.bmm(chunks.transpose(1, 2), h_prev.reshape(-1, rows * t, h))
    return dw_hh.view(2, -1, g3, h).sum(1), chunks.sum(1).view(2, -1, g3).sum(1)


def recurrence_backward(xp: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor, out: torch.Tensor,
                        grad_out: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dxp, dw_hh, db_hh) of the recurrence on CUDA tensors: K1's backward
    kernel, then ``recurrent_weight_grads``.  ``w_hh`` [2, 3H, H] in torch
    layout, as ``rnn.bigru_recurrence_backward`` takes it."""
    dxp, dhp, h_prev = _backward_kernel(xp, w_hh.transpose(1, 2).contiguous(), b_hh, out, grad_out)
    dw_hh, db_hh = recurrent_weight_grads(dhp, h_prev)
    return dxp, dw_hh, db_hh


class _BiGRUSeq(torch.autograd.Function):
    """xp [N, T, 6H], w_hh [2, 3H, H], b_hh [2, 3H] -> out [N, T, 2H]; the
    kernels on CUDA tensors, the plain versions on CPU ones."""

    @staticmethod
    def forward(ctx, xp, w_hh, b_hh):
        out = rnn.bigru_recurrence(xp, w_hh, b_hh) if xp.device.type == "cpu" else _launch(xp, w_hh, b_hh)
        ctx.save_for_backward(xp, w_hh, b_hh, out)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        xp, w_hh, b_hh, out = ctx.saved_tensors
        grad_out = grad_out.contiguous()
        if xp.device.type == "cpu":
            return rnn.bigru_recurrence_backward(xp, w_hh, b_hh, out, grad_out)
        return recurrence_backward(xp, w_hh, b_hh, out, grad_out)


def bigru(x: torch.Tensor, fw: Params, bw: Params) -> torch.Tensor:
    """Bidirectional GRU [N, T, C] -> [N, T, 2H]; ``fw``/``bw`` hold
    ``w_ih`` [3H, C], ``w_hh`` [3H, H], ``b_ih``, ``b_hh`` [3H] in torch layout."""
    _check(x, fw, bw)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"K1 runs on CUDA or (plain) CPU tensors, got {x.device}")
    xp = rnn.input_projection(x, fw, bw).contiguous()
    w_hh = torch.stack([fw["w_hh"], bw["w_hh"]])
    b_hh = torch.stack([fw["b_hh"], bw["b_hh"]])
    return _BiGRUSeq.apply(xp, w_hh, b_hh)
