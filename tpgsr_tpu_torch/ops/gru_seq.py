"""K1's wrapper: the bidirectional GRU with the recurrence and its BPTT as
CUDA kernels.

Counterpart of tpgsr_tpu/ops/pallas_gru.py (``bigru_pallas``).  The kernel
sources are ``csrc/bigru_seq.cu`` and ``csrc/bigru_seq_bwd.cu`` (forward and
backward, fp32) and ``csrc/bigru_seq_bf16.cu`` and
``csrc/bigru_seq_bwd_bf16.cu`` (bf16, on the tensor cores) at hidden sizes
8, 16 and 32 (``NARROW_HIDDEN``: a row within a warp), and
``csrc/bigru_seq_wide.cu`` (both ways, fp32 or bf16 storage) at 64 and 128
(``WIDE_HIDDEN``); their plain versions are ``ops.rnn.bigru_recurrence``
and ``ops.rnn.bigru_recurrence_backward``.

* Every hidden size from 1 to ``MAX_HIDDEN`` runs on the card: ``bigru``
  pads it with zero units to the next instantiated size
  (``padded_hidden``, ``rnn.pad_hidden``) and slices the output back.  A
  padded unit is exactly 0 at every step and feeds nothing into the real
  ones, so the padding changes no value; autograd of the padding returns
  the parameters' gradients at their real shapes.  The slice costs one copy
  of the output at a padded size only: every kernel keeps one layout for
  any H.

* ``x`` is fp32 or bf16 (``SUPPORTED_DTYPES``), its parameters fp32.  In
  bf16 the kernels read and write xp, out, grad_out and dxp in bf16 and
  keep the state and every sum in fp32; W_hh and b_hh reach
  them rounded to bf16 and held as fp32, as the JAX layers cast weights to
  the activation dtype (tpgsr_tpu/models/layers.py:231).  The gradients
  return in each input's dtype: bf16 for xp, fp32 for the parameters.
* A tensor on the CPU takes the plain versions, for that reason only.
* A CUDA tensor launches the kernels or raises; nothing falls back.
* ``LAUNCHES`` and ``BACKWARD_LAUNCHES`` count kernel launches, so a run can
  show that its main path went through the kernels: every K1 launch,
  ``WIDE_LAUNCHES`` and ``WIDE_BACKWARD_LAUNCHES`` those of them on the
  wide kernels.  ``LAUNCH_SHAPES``, set to a list, collects each forward
  call's (N, T, H) at the real H, with the FLOPs its padding adds to the
  input projection, for a FLOP count (``utils.cost``).
* Each kernel's launch configuration comes from a pure function of the
  shape and the card's limits, fed that kernel's own occupancy:
  ``launch_config`` (rows a thread, grid) for the fp32 kernels and the
  wide ones, ``tile_config`` (rows an m-tile, grid) for the bf16 tensor-core
  ones.
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
WIDE_LAUNCHES = 0
WIDE_BACKWARD_LAUNCHES = 0
# (N, T, H, padding FLOPs) of each forward call on the card while a FLOP
# count runs (utils.cost): the kernel is reached through ctypes, which
# torch's FLOP counter cannot see, and at a padded H the counter sees the
# input projection's products on the padded units
LAUNCH_SHAPES: Optional[list] = None
NARROW_HIDDEN = (8, 16, 32)  # csrc/bigru_seq*.cu: a row within a warp
WIDE_HIDDEN = (64, 128)  # csrc/bigru_seq_wide.cu: a row across H / 32 warps
SUPPORTED_HIDDEN = NARROW_HIDDEN + WIDE_HIDDEN  # the instantiated sizes; any other pads to the next
MAX_HIDDEN = SUPPORTED_HIDDEN[-1]  # an fp32 W_hh of H = 256 (786 KB a direction) fits no SM's shared memory
SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)  # the storage types of xp, out, grad_out and dxp
THREADS = 128  # threads a block of the narrow kernels: H hidden units x 128 / H row groups
WIDE_GROUPS = 4  # row groups a block of the wide kernels (kGroups): H x 4 threads
RPTS = (1, 2, 4)  # rows a thread, the fp32 and wide kernels' instantiations
RING_STAGES = 4  # steps of xp in the kernel's shared-memory ring (kStages)
TILE_ROWS = (8, 16)  # rows an m-tile, the bf16 kernels' instantiations
TILE_WARPS = 4  # warps a block of the bf16 kernels, H / 8 an m-tile (kWarps)
BF16_RING_STAGES = 3  # steps of the inputs in the bf16 kernels' rings (kStages)
SUB_PARTITIONS = 4  # warp schedulers an SM
SMALL_TILE_WARPS = 2  # warps a sub-partition up to which the bf16 forward takes 8-row m-tiles
GEMM_CHUNK = 256  # row-steps a batch of the dW_hh GEMM sums over
_PARAM_KEYS = ("w_ih", "w_hh", "b_ih", "b_hh")


def padded_hidden(hidden: int) -> int:
    """The instantiated size K1 runs ``hidden`` at on the card: the smallest
    of ``SUPPORTED_HIDDEN`` that holds it."""
    if not 1 <= hidden <= MAX_HIDDEN:
        raise ValueError(f"K1 takes hidden sizes 1 to {MAX_HIDDEN} on the card, got {hidden}")
    return next(h for h in SUPPORTED_HIDDEN if h >= hidden)


def block_rows(hidden: int, rpt: int) -> int:
    """Rows a block of the fp32 or wide kernels at ``rpt`` rows a thread:
    128 / H row groups of H threads at H <= 32, four groups above."""
    return (WIDE_GROUPS if hidden in WIDE_HIDDEN else THREADS // hidden) * rpt


class LaunchConfig(NamedTuple):
    rpt: int  # rows a thread
    blocks: int  # grid size, both directions
    blocks_per_sm: int
    waves: int


def launch_config(n: int, hidden: int, sms: int, blocks_per_sm: Mapping[int, int]) -> LaunchConfig:
    """The smallest rows-a-thread whose grid of ``2 * ceil(n / rows)`` blocks
    (``rows``: ``block_rows``) fits one wave of ``sms *
    blocks_per_sm[rpt]``; the largest when none does.  The fp32 kernels and,
    in both storage types, the wide ones."""
    if n < 1 or hidden not in SUPPORTED_HIDDEN:
        raise ValueError(f"need n >= 1 and hidden in {SUPPORTED_HIDDEN}, got n={n} hidden={hidden}")
    for rpt in RPTS:
        if blocks_per_sm[rpt] < 1:
            raise ValueError(f"K1 at hidden {hidden}, {rpt} rows a thread fits no block on an SM")
    configs = []
    for rpt in RPTS:
        rows = block_rows(hidden, rpt)
        blocks = 2 * -(-n // rows)
        per_wave = sms * blocks_per_sm[rpt]
        configs.append(LaunchConfig(rpt, blocks, blocks_per_sm[rpt], -(-blocks // per_wave)))
    return next((c for c in configs if c.waves == 1), configs[-1])


class TileConfig(NamedTuple):
    rows: int  # rows an m-tile
    blocks: int  # grid size, both directions
    blocks_per_sm: int
    waves: int


def tile_config(n: int, hidden: int, sms: int, blocks_per_sm: Mapping[int, int],
                backward: bool = False) -> TileConfig:
    """The bf16 kernels' geometry: each m-tile of rows runs on ``hidden / 8``
    warps (one 8-unit tile each), ``TILE_WARPS`` warps a block.  m-tiles of 8
    rows, each warp's chain of steps carrying half the gates: always in the
    backward (its only instantiation), whose steps carry the most; in the
    forward where the grid's warps at 8 rows, ``2 * ceil(n / 8) * hidden /
    8``, come to at most ``SMALL_TILE_WARPS`` a sub-partition of the card
    (the flagship's sweep over W), else 16 rows (fewer warps, each product's
    rows all used: over H and at batch 512).  Measured on an H100 at H = 32
    (PERF.md).  The tensor-core kernels' sizes only (``NARROW_HIDDEN``); bf16
    at ``WIDE_HIDDEN`` takes ``launch_config``."""
    if n < 1 or hidden not in NARROW_HIDDEN:
        raise ValueError(f"need n >= 1 and hidden in {NARROW_HIDDEN}, got n={n} hidden={hidden}")
    tile_warps = hidden // 8
    small = TILE_ROWS[0]
    fits = 2 * -(-n // small) * tile_warps <= SMALL_TILE_WARPS * SUB_PARTITIONS * sms
    rows = small if backward or fits else TILE_ROWS[-1]
    if blocks_per_sm[rows] < 1:
        raise ValueError(f"K1 bf16 at hidden {hidden}, {rows} rows an m-tile fits no block on an SM")
    blocks = 2 * -(-n // (rows * (TILE_WARPS // tile_warps)))
    return TileConfig(rows, blocks, blocks_per_sm[rows], -(-blocks // (sms * blocks_per_sm[rows])))


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
def _bf16_lib() -> ctypes.CDLL:
    from tpgsr_tpu_torch.ops import _build

    lib = _build.load("bigru_seq_bf16")
    lib.tpgsr_bigru_seq_bf16_forward.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.tpgsr_bigru_seq_bf16_forward.restype = ctypes.c_int
    lib.tpgsr_bigru_seq_bf16_occupancy.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)]
    lib.tpgsr_bigru_seq_bf16_occupancy.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_bf16_lib() -> ctypes.CDLL:
    from tpgsr_tpu_torch.ops import _build

    lib = _build.load("bigru_seq_bwd_bf16")
    lib.tpgsr_bigru_seq_bf16_backward.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.tpgsr_bigru_seq_bf16_backward.restype = ctypes.c_int
    lib.tpgsr_bigru_seq_bf16_backward_occupancy.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)]
    lib.tpgsr_bigru_seq_bf16_backward_occupancy.restype = ctypes.c_int
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
def _wide_lib() -> ctypes.CDLL:
    from tpgsr_tpu_torch.ops import _build

    lib = _build.load("bigru_seq_wide")
    lib.tpgsr_bigru_wide_forward.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.tpgsr_bigru_wide_forward.restype = ctypes.c_int
    lib.tpgsr_bigru_wide_backward.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.tpgsr_bigru_wide_backward.restype = ctypes.c_int
    lib.tpgsr_bigru_wide_occupancy.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    lib.tpgsr_bigru_wide_occupancy.restype = ctypes.c_int
    return lib


def _bf16_flag(dtype: torch.dtype) -> int:
    """The kernels' storage-type argument: 0 for fp32, 1 for bf16."""
    if dtype not in SUPPORTED_DTYPES:
        raise TypeError(f"K1 takes {SUPPORTED_DTYPES}, got {dtype}")
    return int(dtype == torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _device_limits(index: int, hidden: int, backward: bool, bf16: int) -> Tuple[int, Tuple[Tuple[int, int], ...]]:
    """(SMs, ((instantiation, resident blocks an SM), ...)) of card ``index``
    for the forward kernel, or the backward's with ``backward``, in fp32
    storage or with ``bf16`` in bf16 (their registers and shared memory
    differ); an instantiation is a rows a thread (``RPTS``), or in bf16 at
    ``NARROW_HIDDEN`` a rows an m-tile (``TILE_ROWS``; the backward's 8
    only)."""
    if hidden in WIDE_HIDDEN:
        lib = _wide_lib().tpgsr_bigru_wide_occupancy
        query, kinds = (lambda rpt, blocks: lib(hidden, rpt, bf16, int(backward), blocks)), RPTS
    elif bf16 and backward:  # one instantiation a hidden size, 8 rows an m-tile
        lib = _bwd_bf16_lib().tpgsr_bigru_seq_bf16_backward_occupancy
        query, kinds = (lambda rows, blocks: lib(hidden, blocks)), TILE_ROWS[:1]
    elif bf16:
        query, kinds = functools.partial(_bf16_lib().tpgsr_bigru_seq_bf16_occupancy, hidden), TILE_ROWS
    else:
        lib = _bwd_lib().tpgsr_bigru_seq_backward_occupancy if backward else _lib().tpgsr_bigru_seq_occupancy
        query, kinds = functools.partial(lib, hidden), RPTS
    occupancy = []
    with torch.cuda.device(index):
        for kind in kinds:
            blocks = ctypes.c_int(0)
            err = query(kind, ctypes.byref(blocks))
            if err != 0:
                raise RuntimeError(f"K1 occupancy query failed: cudaError {err}")
            occupancy.append((kind, blocks.value))
    return torch.cuda.get_device_properties(index).multi_processor_count, tuple(occupancy)


def config_for(n: int, hidden: int, device: torch.device, backward: bool = False,
               dtype: torch.dtype = torch.float32) -> "LaunchConfig | TileConfig":
    """The launch configuration K1's forward (or, with ``backward``, its
    backward) takes for ``n`` rows of storage type ``dtype`` on CUDA
    ``device``: a ``TileConfig`` for the bf16 tensor-core kernels
    (``NARROW_HIDDEN``), a ``LaunchConfig`` for the others."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return _config(index, n, hidden, backward, _bf16_flag(dtype))


@functools.lru_cache(maxsize=1024)
def _config(index: int, n: int, hidden: int, backward: bool, bf16: int) -> "LaunchConfig | TileConfig":
    sms, occupancy = _device_limits(index, hidden, backward, bf16)
    if bf16 and hidden in NARROW_HIDDEN:
        return tile_config(n, hidden, sms, dict(occupancy), backward=backward)
    return launch_config(n, hidden, sms, dict(occupancy))


def _check(x: torch.Tensor, fw: Params, bw: Params) -> None:
    if x.dim() != 3:
        raise ValueError(f"x must be [N, T, C], got shape {tuple(x.shape)}")
    n, t, c = x.shape
    if n == 0 or t == 0:
        raise ValueError(f"x must have N >= 1 and T >= 1, got shape {tuple(x.shape)}")
    if x.dtype not in SUPPORTED_DTYPES:
        raise TypeError(f"K1 takes x in {SUPPORTED_DTYPES}, got {x.dtype}")
    h = fw["w_hh"].shape[-1]
    want = {"w_ih": (3 * h, c), "w_hh": (3 * h, h), "b_ih": (3 * h,), "b_hh": (3 * h,)}
    for d in (fw, bw):
        for k in _PARAM_KEYS:
            p = d[k]
            if tuple(p.shape) != want[k]:
                raise ValueError(f"{k} must have shape {want[k]}, got {tuple(p.shape)}")
            if p.device != x.device or p.dtype != torch.float32:
                raise ValueError(f"{k} must be float32 on {x.device}, got {p.dtype} on {p.device}")


def _check_weights(xp: torch.Tensor, h: int, w_t: torch.Tensor, b_hh: torch.Tensor) -> None:
    """``w_t`` [2, H, 3H] and ``b_hh`` [2, 3H], contiguous float32 on xp's
    device, as the kernels take them."""
    if tuple(w_t.shape) != (2, h, 3 * h) or tuple(b_hh.shape) != (2, 3 * h):
        raise ValueError(f"w_t must be {(2, h, 3 * h)} and b_hh {(2, 3 * h)}, "
                         f"got {tuple(w_t.shape)} and {tuple(b_hh.shape)}")
    for name, tensor in (("w_t", w_t), ("b_hh", b_hh)):
        if not tensor.is_contiguous() or tensor.device != xp.device or tensor.dtype != torch.float32:
            raise ValueError(f"{name} must be contiguous float32 on {xp.device}, "
                             f"got {tensor.dtype} on {tensor.device}")


def _kernel_weights(xp: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``w_hh`` [2, 3H, H] in torch layout and ``b_hh`` as the kernels take
    them: rounded to xp's storage type and held in fp32 (no copy in fp32),
    W_hh transposed per direction to [2, H, 3H]."""
    return (rnn.rounded_to(w_hh, xp.dtype).transpose(1, 2).contiguous(),
            rnn.rounded_to(b_hh, xp.dtype).contiguous())


def _recurrence(xp: torch.Tensor, w_t: torch.Tensor, b_hh: torch.Tensor,
                config: "Optional[LaunchConfig | TileConfig]" = None) -> torch.Tensor:
    """Run K1 on [N, T, 6H] projections with ``w_t`` [2, H, 3H] (W_hh
    transposed per direction) and ``b_hh`` [2, 3H] in fp32, holding values of
    xp's dtype (``_kernel_weights``); returns [N, T, 2H] in xp's dtype: at
    ``NARROW_HIDDEN`` the fp32 kernel for fp32 and the tensor-core kernel for
    bf16, at ``WIDE_HIDDEN`` the wide kernel in either.  ``config``
    overrides ``config_for`` (the tests use it to reach every
    instantiation)."""
    global LAUNCHES, WIDE_LAUNCHES
    n, t, g6 = xp.shape
    h = g6 // 6
    bf16 = _bf16_flag(xp.dtype)
    if h not in SUPPORTED_HIDDEN:
        raise ValueError(f"K1 supports hidden sizes {SUPPORTED_HIDDEN}, got {h}")
    if not xp.is_contiguous():
        raise ValueError("xp must be contiguous")
    _check_weights(xp, h, w_t, b_hh)
    if xp.data_ptr() % 16:
        raise ValueError("xp must be 16-byte aligned (the kernel copies it 16 bytes a thread)")
    if config is None:
        config = config_for(n, h, xp.device, dtype=xp.dtype)
    wide = h in WIDE_HIDDEN
    if bf16 and not wide and (n + TILE_ROWS[-1]) * t * 6 * h >= 2**31:
        raise ValueError(f"K1's bf16 forward indexes with 32-bit offsets: N={n}, T={t}, H={h} is too large")
    out = torch.empty(n, t, 2 * h, device=xp.device, dtype=xp.dtype)
    args = [xp.data_ptr(), w_t.data_ptr(), b_hh.data_ptr(), out.data_ptr(), n, t, h]
    if wide:
        fn = _wide_lib().tpgsr_bigru_wide_forward
        args += [config.rpt, bf16]
    elif bf16:
        fn = _bf16_lib().tpgsr_bigru_seq_bf16_forward
        args.append(config.rows)
    else:
        fn = _lib().tpgsr_bigru_seq_forward
        args.append(config.rpt)
    with torch.cuda.device(xp.device):
        err = fn(*args, torch.cuda.current_stream(xp.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K1 bigru_seq launch failed: cudaError {err}")
    LAUNCHES += 1
    WIDE_LAUNCHES += int(wide)
    return out


def _launch(xp: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor) -> torch.Tensor:
    """Run K1 on [N, T, 6H] projections with ``w_hh`` [2, 3H, H] in torch
    layout (fp32); returns [N, T, 2H] in xp's dtype."""
    return _recurrence(xp, *_kernel_weights(xp, w_hh, b_hh))


def _chunk_rows(t: int) -> int:
    """Rows a batch of the dW_hh GEMM: about GEMM_CHUNK row-steps."""
    return max(1, GEMM_CHUNK // t)


def _backward_kernel(xp: torch.Tensor, w_t: torch.Tensor, b_hh: torch.Tensor, out: torch.Tensor,
                     grad_out: torch.Tensor, config: "Optional[LaunchConfig | TileConfig]" = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run K1's backward kernel (at ``NARROW_HIDDEN`` the fp32 kernel, or
    the tensor-core kernel in bf16; at ``WIDE_HIDDEN`` the wide kernel):
    ``xp`` [N, T, 6H], the forward's ``out`` and ``grad_out`` [N, T, 2H], all
    fp32 or all bf16, with ``w_t`` [2, H, 3H] and ``b_hh`` [2, 3H] in fp32
    holding values of xp's dtype (``_kernel_weights``) -> (dxp [N, T, 6H] in
    xp's dtype, and in fp32 dhp [2, Np, T, 3H] and h_{t-1} [2, Np, T, H]), N
    padded with zero rows to Np, a multiple of the GEMM's chunk of rows.
    ``config`` overrides ``config_for(..., backward=True)`` (the tests use it
    to reach every instantiation)."""
    global BACKWARD_LAUNCHES, WIDE_BACKWARD_LAUNCHES
    n, t, g6 = xp.shape
    h = g6 // 6
    bf16 = _bf16_flag(xp.dtype)
    if h not in SUPPORTED_HIDDEN:
        raise ValueError(f"K1 supports hidden sizes {SUPPORTED_HIDDEN}, got {h}")
    _check_weights(xp, h, w_t, b_hh)
    want = {"out": (n, t, 2 * h), "grad_out": (n, t, 2 * h)}
    for name, tensor in (("xp", xp), ("out", out), ("grad_out", grad_out)):
        if name in want and tuple(tensor.shape) != want[name]:
            raise ValueError(f"{name} must have shape {want[name]}, got {tuple(tensor.shape)}")
        if not tensor.is_contiguous() or tensor.device != xp.device or tensor.dtype != xp.dtype:
            raise ValueError(f"{name} must be contiguous {xp.dtype} on {xp.device}")
        if tensor.data_ptr() % tensor.element_size():
            raise ValueError(f"{name} must be aligned to its element size")
        if bf16 and tensor.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the bf16 kernel copies it 16 bytes a thread)")
    if out.data_ptr() % 4:
        raise ValueError("out must be 4-byte aligned (the kernel copies h_{t-1} from it 4 bytes at a time)")
    if config is None:
        config = config_for(n, h, xp.device, backward=True, dtype=xp.dtype)
    wide = h in WIDE_HIDDEN
    rows = _chunk_rows(t)
    n_pad = -(-n // rows) * rows
    if not wide and (n_pad + 64) * t * 6 * h >= 2**31:
        raise ValueError(f"K1's backward indexes with 32-bit offsets: N={n}, T={t}, H={h} is too large")
    dxp = torch.empty_like(xp)
    dhp = xp.new_empty(2, n_pad, t, 3 * h, dtype=torch.float32)
    h_prev = xp.new_empty(2, n_pad, t, h, dtype=torch.float32)
    if n_pad > n:
        dhp[:, n:].zero_()
        h_prev[:, n:].zero_()
    if bf16 and not wide and config.rows != TILE_ROWS[0]:
        raise ValueError(f"K1's bf16 backward runs {TILE_ROWS[0]} rows an m-tile, got {config.rows}")
    args = [xp.data_ptr(), w_t.data_ptr(), b_hh.data_ptr(), out.data_ptr(), grad_out.data_ptr(),
            dxp.data_ptr(), dhp.data_ptr(), h_prev.data_ptr(), n, n_pad, t, h]
    if wide:
        fn = _wide_lib().tpgsr_bigru_wide_backward
        args += [config.rpt, bf16]
    elif bf16:
        fn = _bwd_bf16_lib().tpgsr_bigru_seq_bf16_backward
    else:
        fn = _bwd_lib().tpgsr_bigru_seq_backward
        args.append(config.rpt)
    with torch.cuda.device(xp.device):
        err = fn(*args, torch.cuda.current_stream(xp.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K1 bigru_seq backward launch failed: cudaError {err}")
    BACKWARD_LAUNCHES += 1
    WIDE_BACKWARD_LAUNCHES += int(wide)
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
    kernel, then ``recurrent_weight_grads`` in fp32.  ``w_hh`` [2, 3H, H] in
    torch layout, as ``rnn.bigru_recurrence_backward`` takes it."""
    dxp, dhp, h_prev = _backward_kernel(xp, *_kernel_weights(xp, w_hh, b_hh), out, grad_out)
    dw_hh, db_hh = recurrent_weight_grads(dhp, h_prev)
    return dxp, dw_hh, db_hh


class _BiGRUSeq(torch.autograd.Function):
    """xp [N, T, 6H] (fp32 or bf16), w_hh [2, 3H, H], b_hh [2, 3H] (fp32)
    -> out [N, T, 2H] in xp's dtype; the kernels on CUDA tensors, the plain
    versions on CPU ones."""

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
        if grad_out.data_ptr() % 16:  # a view into a larger buffer: the kernels copy 16 bytes a thread
            grad_out = grad_out.clone()
        if xp.device.type == "cpu":
            return rnn.bigru_recurrence_backward(xp, w_hh, b_hh, out, grad_out)
        return recurrence_backward(xp, w_hh, b_hh, out, grad_out)


def bigru(x: torch.Tensor, fw: Params, bw: Params) -> torch.Tensor:
    """Bidirectional GRU [N, T, C] -> [N, T, 2H] in x's dtype (fp32 or
    bf16); ``fw``/``bw`` hold ``w_ih`` [3H, C], ``w_hh`` [3H, H], ``b_ih``,
    ``b_hh`` [3H] in torch layout, fp32.  The input projection runs in x's
    dtype, with its weights cast to it.  On the card a hidden size between
    the instantiated ones runs padded with zero units (``padded_hidden``);
    on the CPU the plain versions run at the real size."""
    _check(x, fw, bw)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"K1 runs on CUDA or (plain) CPU tensors, got {x.device}")
    n, t, c = x.shape
    h = fw["w_hh"].shape[-1]
    hp = h if x.device.type == "cpu" else padded_hidden(h)
    if hp != h:
        fw, bw = rnn.pad_hidden(fw, hp), rnn.pad_hidden(bw, hp)
    xp = rnn.input_projection(x, fw, bw).contiguous()
    w_hh = torch.stack([fw["w_hh"], bw["w_hh"]])
    b_hh = torch.stack([fw["b_hh"], bw["b_hh"]])
    out = _BiGRUSeq.apply(xp, w_hh, b_hh)
    if LAUNCH_SHAPES is not None and x.device.type == "cuda":
        # the counter sees the padded projection's 2 N T C 6 (Hp - H) FLOPs
        LAUNCH_SHAPES.append((n, t, h, 2 * n * t * c * 6 * (hp - h)))
    return out if hp == h else rnn.unpad_output(out, h)
