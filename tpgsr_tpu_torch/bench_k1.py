"""Device times of kernel K1 at the flagship's two sweeps, on one NVIDIA card.

    python -m tpgsr_tpu_torch.bench_k1 [--bf16] [--batch B] [--hidden H]

For each sweep at batch B, 48 by default (over W: N = 16 B, T = 64; over H:
N = 64 B, T = 16; C = 2H, H = 32 by default, the flagship's ``--hd_u``;
64 and 128 run the wide kernels, any other size up to 128 runs padded)
it prints one JSON line: K1 alone on a
precomputed projection (``gru_seq._launch``), the wrapper (projection + K1,
``gru_seq.bigru``) and ``nn.GRU`` (cuDNN) on the same input, each the mean
device time of calls queued back to back (``device_ms``), with K1's error
against its plain version.  A second line times K1's backward the same way:
the kernel alone, with the GEMM for dW_hh (``gru_seq.recurrence_backward``),
and the forward + backward of the wrapper and of ``nn.GRU``.  With
``--bf16`` the input is bf16 (the kernels' bf16 storage), and each line
also times the kernel alone on weights already rounded and transposed
(``kernel_only_ms``); ``nn.GRU`` in bf16 is None where the host cannot
queue its calls ahead of the card.

The script uses only ``gru_seq._launch``, ``gru_seq.bigru`` and ``rnn``
(and in bf16 ``gru_seq._kernel_weights``), so the same file, copied into
another checkout's ``tpgsr_tpu_torch/`` and run there, times that
checkout's K1 by the same method: put an earlier tree under ``build/`` and
run both in turns within one call to the card.
"""

from __future__ import annotations

import argparse
import inspect
import json
import re
import subprocess

import numpy as np
import torch

from tpgsr_tpu_torch.ops import gru_seq, rnn

SWEEPS = (("over W", 768, 64), ("over H", 3072, 16))  # (label, N, T) at batch 48
C, H = 64, 32  # the flagship's sweeps: C = 2H


def device_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` calls queued back to back
    behind a spin kernel, so that the host's enqueue time is hidden; raises
    if the card reached the first call before the last was queued."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    cycles = int(5e7)
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        held = not start.query()
        torch.cuda.synchronize()
        if held:
            return start.elapsed_time(end) / iters
        cycles *= 4
    raise RuntimeError("device_ms: the host could not queue the calls ahead of the card")


def ptxas_entries(log: str):
    """(mangled kernel name, registers, spilled bytes, stack bytes) of each
    kernel in an -Xptxas -v log."""
    rows, spill, stack = [], 0, 0
    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            stack, spill = int(m.group(1)), int(m.group(2)) + int(m.group(3))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append({"kernel": name, "registers": int(m.group(1)), "spill_bytes": spill, "stack_bytes": stack})
            name = None
    return rows


# the storage type's template argument, as the Itanium ABI mangles it
_MANGLED_DTYPES = {"f": "fp32", "13__nv_bfloat16": "bf16"}


def _padded(values: int) -> int:
    """A bf16 ring row of the tensor-core kernels: padded to an odd number of
    16-byte chunks (``padded`` in csrc/bigru_seq_bwd_bf16.cu)."""
    return values + (8 if (values // 8) % 2 == 0 else 0)


def _tile_smem(h: int, rows: int, backward: bool) -> int:
    """Dynamic shared memory of a tensor-core kernel's block: each m-tile's
    two buffers of bf16 fragments (three terms of h, or in the backward of
    dhp_t's 3H columns), and each warp's ring of bf16 slots (its xp slice; in
    the backward also its grad_out slice, then each m-tile's ring of h_{t-1}
    and at H = 128 W_hh^T in bf16)."""
    tiles, warps = h // 8, gru_seq.tile_block_warps(h)
    groups = warps // tiles
    words = 2 * 3 * (rows // 8) * (3 * tiles if backward else tiles) * 32
    if not backward:
        return 4 * groups * words + 2 * warps * gru_seq.BF16_RING_STAGES * rows * 24
    stages = gru_seq.BF16_BWD_RING_STAGES
    weights = h * _padded(3 * h) if h >= 128 else 0
    return 4 * groups * words + 2 * (stages * rows * (warps * 32 + groups * _padded(h)) + weights)


def _wide_smem(h: int, rpt: int, backward: bool) -> int:
    """Dynamic shared memory of a wide kernel's block (csrc/bigru_seq_wide.cu):
    W_hh^T at a row stride of 3H + 1 floats, then the forward's two h
    buffers or the backward's h_{t-1} and dhp_t, each the block's rows."""
    rows = gru_seq.block_rows(h, rpt)
    return 4 * (h * (3 * h + 1) + (4 * rows * h if backward else 2 * rows * h))


def ptxas_report(log: str, backward: bool = False):
    """Registers and spilled bytes of each instantiation of K1's forward (or,
    with ``backward``, its backward) from -Xptxas -v, with the dynamic shared
    memory the launcher asks for.  fp32 (csrc/bigru_seq.cu,
    csrc/bigru_seq_bwd.cu), by hidden size and rows a thread (``rpt``): the
    forward's xp ring and fp32 h buffers, the backward's h_{t-1} buffers (of
    the storage type where the kernel copies them by cp.async, at four rows a
    thread, else fp32).  bf16 (csrc/bigru_seq_bf16.cu,
    csrc/bigru_seq_bwd_bf16.cu), by hidden size and rows an m-tile
    (``rows``; 8 in the backward): ``_tile_smem``.  The wide kernels
    (csrc/bigru_seq_wide.cu, fp32), by hidden size and rows a thread,
    marked ``"wide": True``: ``_wide_smem``."""
    kernel = "bigru_seq_backward_kernel" if backward else "bigru_seq_kernel"
    wide = "bigru_wide_backward_kernel" if backward else "bigru_wide_forward_kernel"
    # the bf16 forward's template arguments: hidden, rows an m-tile; the backward's: hidden (8 rows)
    tile = r"bigru_seq_bwd_bf16_kernelILi(\d+)E()E" if backward else r"bigru_seq_bf16_kernelILi(\d+)ELi(\d+)E"
    rows = []
    for e in ptxas_entries(log):
        kept = {"registers": e["registers"], "spill_bytes": e["spill_bytes"], "stack_bytes": e["stack_bytes"]}
        t = re.search(kernel + r"I(f|13__nv_bfloat16)Li(\d+)ELi(\d+)E", e["kernel"])
        tiled = re.search(tile, e["kernel"])
        w = re.search(wide + r"ILi(\d+)ELi(\d+)E", e["kernel"])
        if w:
            h, rpt = int(w.group(1)), int(w.group(2))
            rows.append({"dtype": "fp32", "H": h, "rpt": rpt, "wide": True, **kept,
                         "smem_bytes": _wide_smem(h, rpt, backward)})
        elif t:
            dtype = _MANGLED_DTYPES[t.group(1)]
            h, rpt = int(t.group(2)), int(t.group(3))
            size = 2 if dtype == "bf16" else 4
            rows_blk = gru_seq.THREADS // h * rpt
            if backward:  # two buffers at every rows a thread
                staged = rpt == 4 or (rpt == 2 and dtype == "bf16")
                smem = (size if staged else 4) * 2 * rows_blk * h
            else:
                smem = size * gru_seq.RING_STAGES * rows_blk * 3 * h + 4 * 2 * rows_blk * h
            rows.append({"dtype": dtype, "H": h, "rpt": rpt, **kept, "smem_bytes": smem})
        elif tiled:
            h, m = int(tiled.group(1)), int(tiled.group(2) or 8)
            rows.append({"dtype": "bf16", "H": h, "rows": m, **kept, "smem_bytes": _tile_smem(h, m, backward)})
    return rows


def case(seed: int, n: int, t: int, c: int = C, h: int = H):
    """x [N, T, C] and both directions' weights in nn.GRU's init range, on the card."""
    rng = np.random.default_rng(seed)
    bound = 1.0 / np.sqrt(h)
    x = torch.from_numpy(rng.standard_normal((n, t, c)).astype(np.float32)).cuda()

    def direction():
        return {k: torch.from_numpy(rng.uniform(-bound, bound, shape).astype(np.float32)).cuda()
                for k, shape in (("w_ih", (3 * h, c)), ("w_hh", (3 * h, h)),
                                 ("b_ih", (3 * h,)), ("b_hh", (3 * h,)))}

    return x, direction(), direction()


def sweeps(batch: int):
    """(label, N, T) of the flagship's two sweeps at ``batch``."""
    return (("over W", 16 * batch, 64), ("over H", 64 * batch, 16))


def _maybe_ms(fn):
    """``device_ms`` of ``fn``, or None where the host cannot queue its calls
    ahead of the card (``nn.GRU`` in bf16; the wrapper's forward and
    backward at a padded size, whose padding and slices are small ops)."""
    try:
        return device_ms(fn)
    except RuntimeError:
        return None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--bf16", action="store_true", help="bf16 input: K1's bf16 kernels")
    parser.add_argument("--batch", type=int, default=48, help="the flagship's batch the sweeps follow")
    parser.add_argument("--hidden", type=int, default=H, help="K1's hidden size (--hd_u); the input is 2H wide")
    args = parser.parse_args(argv)
    h, c = args.hidden, 2 * args.hidden
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    if not torch.cuda.is_available():
        raise SystemExit("bench_k1: needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    torch.cuda._sleep(int(2e9))  # about a second of spinning, so that the first timing finds the clocks up
    for i, (label, n, t) in enumerate(sweeps(args.batch)):
        x, fw, bw = case(i, n, t, c, h)
        x = x.to(dtype)
        # K1 alone runs at the instantiated size: a padded H's projection and weights
        hp = gru_seq.padded_hidden(h) if hasattr(gru_seq, "padded_hidden") else h
        pfw, pbw = (rnn.pad_hidden(d, hp) for d in (fw, bw)) if hp != h else (fw, bw)
        xp = rnn.input_projection(x, pfw, pbw).contiguous()
        w_hh = torch.stack([pfw["w_hh"], pbw["w_hh"]]).contiguous()
        b_hh = torch.stack([pfw["b_hh"], pbw["b_hh"]]).contiguous()
        lib = torch.nn.GRU(c, h, bidirectional=True, batch_first=True).cuda()
        with torch.no_grad():
            for sfx, d in (("", fw), ("_reverse", bw)):
                for ours, theirs in (("w_ih", "weight_ih_l0"), ("w_hh", "weight_hh_l0"),
                                     ("b_ih", "bias_ih_l0"), ("b_hh", "bias_hh_l0")):
                    getattr(lib, theirs + sfx).copy_(d[ours])
            lib = lib.to(dtype)
            err = float((gru_seq._launch(xp, w_hh, b_hh).float()
                         - rnn.bigru_recurrence(xp, w_hh, b_hh).float()).abs().max())
            row = {"sweep": label, "batch": args.batch, "dtype": str(dtype), "N": n, "T": t, "C": c, "H": h, "Hp": hp,
                   "max_abs_err": err,
                   "k1_ms": device_ms(lambda: gru_seq._launch(xp, w_hh, b_hh)),
                   "wrapper_ms": device_ms(lambda: gru_seq.bigru(x, fw, bw)),
                   "nn_gru_ms": _maybe_ms(lambda: lib(x))}
            if args.bf16:
                kernel_args = (xp, *gru_seq._kernel_weights(xp, w_hh, b_hh))
                row["kernel_only_ms"] = device_ms(lambda: gru_seq._recurrence(*kernel_args))
        print("bench_k1 " + json.dumps(row), flush=True)
        if hasattr(gru_seq, "recurrence_backward"):  # trees before the backward kernel lack it
            print("bench_k1 backward " + json.dumps(backward_row(label, x, fw, bw, xp, w_hh, b_hh, lib)), flush=True)
    return 0


def backward_row(label, x, fw, bw, xp, w_hh, b_hh, lib):
    """Device times of K1's backward: the kernel alone, with the dW_hh GEMM
    (both at the instantiated size, on ``xp``, ``w_hh`` and ``b_hh``), the
    wrapper's forward + backward and nn.GRU's, on one cotangent."""
    n, t, c = x.shape
    h, hp = fw["w_hh"].shape[-1], w_hh.shape[-1]
    out = gru_seq._launch(xp, w_hh, b_hh)
    grad_out = torch.from_numpy(np.random.default_rng(n).standard_normal((n, t, 2 * hp)).astype(np.float32))
    grad_out = grad_out.to("cuda", x.dtype)
    if x.dtype == torch.float32:
        w_t, b_k = w_hh.transpose(1, 2).contiguous(), b_hh
    else:
        w_t, b_k = gru_seq._kernel_weights(xp, w_hh, b_hh)
    leaves = [x.clone().requires_grad_(True), *({k: v.clone().requires_grad_(True) for k, v in d.items()}
                                                for d in (fw, bw))]
    x_lib = x.clone().requires_grad_(True)
    grad_real = grad_out if hp == h else rnn.unpad_output(grad_out, h).contiguous()
    got = gru_seq.recurrence_backward(xp, w_hh, b_hh, out, grad_out)[0]
    want = rnn.bigru_recurrence_backward(xp, w_hh, b_hh, out, grad_out)[0]
    config = {}
    params = inspect.signature(gru_seq.config_for).parameters
    if "backward" in params:  # older trees configure the forward only
        dtype = {"dtype": x.dtype} if "dtype" in params else {}
        config = gru_seq.config_for(n, hp, x.device, backward=True, **dtype)._asdict()
    return {"sweep": label, "dtype": str(x.dtype), "N": n, "T": t, "C": c, "H": h, "Hp": hp, **config,
            "dxp_max_abs_err": float((got.float() - want.float()).abs().max()),
            "kernel_ms": device_ms(lambda: gru_seq._backward_kernel(xp, w_t, b_k, out, grad_out)),
            "backward_ms": device_ms(lambda: gru_seq.recurrence_backward(xp, w_hh, b_hh, out, grad_out)),
            "wrapper_fwd_bwd_ms": _maybe_ms(lambda: gru_seq.bigru(*leaves).backward(grad_real)),
            "nn_gru_fwd_bwd_ms": _maybe_ms(lambda: lib(x_lib)[0].backward(grad_real))}


if __name__ == "__main__":
    raise SystemExit(main())
