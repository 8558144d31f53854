"""Device times of kernel K1 at the flagship's two sweeps, on one NVIDIA card.

    python -m tpgsr_tpu_torch.bench_k1

For each sweep at batch 48 (over W: N = 768, T = 64; over H: N = 3,072,
T = 16; C = 64, H = 32) it prints one JSON line: K1 alone on a precomputed
projection (``gru_seq._launch``), the wrapper (projection + K1,
``gru_seq.bigru``) and ``nn.GRU`` (cuDNN) on the same input, each the mean
device time of calls queued back to back (``device_ms``), with K1's error
against its plain version.  A second line times K1's backward the same way:
the kernel alone, with the GEMM for dW_hh (``gru_seq.recurrence_backward``),
and the forward + backward of the wrapper and of ``nn.GRU``.

The script uses only ``gru_seq._launch``, ``gru_seq.bigru`` and ``rnn``, so
the same file, copied into another checkout's ``tpgsr_tpu_torch/`` and run
there, times that checkout's K1 by the same method: put an earlier tree
under ``build/`` and run both in turns within one call to the card.
"""

from __future__ import annotations

import inspect
import json
import re
import subprocess

import numpy as np
import torch

from tpgsr_tpu_torch.ops import gru_seq, rnn

SWEEPS = (("over W", 768, 64), ("over H", 3072, 16))  # (label, N, T) at batch 48
C, H = 64, 32


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


def ptxas_report(log: str, backward: bool = False):
    """Registers and spilled bytes of each instantiation of K1's forward (or,
    with ``backward``, its backward), from -Xptxas -v, with the dynamic
    shared memory the launcher asks for: the forward's xp ring and h
    buffers, the backward's h_{t-1} buffers."""
    kernel = "bigru_seq_backward_kernel" if backward else "bigru_seq_kernel"
    rows = []
    for e in ptxas_entries(log):
        t = re.search(kernel + r"ILi(\d+)ELi(\d+)E", e["kernel"])
        if t:
            h, rpt = (int(v) for v in t.groups())
            rows_blk = gru_seq.THREADS // h * rpt
            ring = 0 if backward else gru_seq.RING_STAGES * rows_blk * 3 * h
            rows.append({"H": h, "rpt": rpt, "registers": e["registers"], "spill_bytes": e["spill_bytes"],
                         "stack_bytes": e["stack_bytes"], "smem_bytes": 4 * (ring + 2 * rows_blk * h)})
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


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("bench_k1: needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    torch.cuda._sleep(int(2e9))  # about a second of spinning, so that the first timing finds the clocks up
    for i, (label, n, t) in enumerate(SWEEPS):
        x, fw, bw = case(i, n, t)
        xp = rnn.input_projection(x, fw, bw).contiguous()
        w_hh = torch.stack([fw["w_hh"], bw["w_hh"]]).contiguous()
        b_hh = torch.stack([fw["b_hh"], bw["b_hh"]]).contiguous()
        lib = torch.nn.GRU(C, H, bidirectional=True, batch_first=True).cuda()
        with torch.no_grad():
            for sfx, d in (("", fw), ("_reverse", bw)):
                for ours, theirs in (("w_ih", "weight_ih_l0"), ("w_hh", "weight_hh_l0"),
                                     ("b_ih", "bias_ih_l0"), ("b_hh", "bias_hh_l0")):
                    getattr(lib, theirs + sfx).copy_(d[ours])
            err = float((gru_seq._launch(xp, w_hh, b_hh) - rnn.bigru_recurrence(xp, w_hh, b_hh)).abs().max())
            row = {"sweep": label, "N": n, "T": t, "C": C, "H": H, "max_abs_err": err,
                   "k1_ms": device_ms(lambda: gru_seq._launch(xp, w_hh, b_hh)),
                   "wrapper_ms": device_ms(lambda: gru_seq.bigru(x, fw, bw)),
                   "nn_gru_ms": device_ms(lambda: lib(x))}
        print("bench_k1 " + json.dumps(row), flush=True)
        if hasattr(gru_seq, "recurrence_backward"):  # trees before the backward kernel lack it
            print("bench_k1 backward " + json.dumps(backward_row(label, x, fw, bw, xp, w_hh, b_hh, lib)), flush=True)
    return 0


def backward_row(label, x, fw, bw, xp, w_hh, b_hh, lib):
    """Device times of K1's backward: the kernel alone, with the dW_hh GEMM,
    the wrapper's forward + backward and nn.GRU's, on one cotangent."""
    n, t, _ = x.shape
    out = gru_seq._launch(xp, w_hh, b_hh)
    grad_out = torch.from_numpy(np.random.default_rng(n).standard_normal((n, t, 2 * H)).astype(np.float32)).cuda()
    w_t = w_hh.transpose(1, 2).contiguous()
    leaves = [x.clone().requires_grad_(True), *({k: v.clone().requires_grad_(True) for k, v in d.items()}
                                                for d in (fw, bw))]
    x_lib = x.clone().requires_grad_(True)
    got = gru_seq.recurrence_backward(xp, w_hh, b_hh, out, grad_out)[0]
    want = rnn.bigru_recurrence_backward(xp, w_hh, b_hh, out, grad_out)[0]
    config = {}
    if "backward" in inspect.signature(gru_seq.config_for).parameters:  # older trees configure the forward only
        config = gru_seq.config_for(n, H, x.device, backward=True)._asdict()
    return {"sweep": label, "N": n, "T": t, "C": C, "H": H, **config,
            "dxp_max_abs_err": float((got - want).abs().max()),
            "kernel_ms": device_ms(lambda: gru_seq._backward_kernel(xp, w_t, b_hh, out, grad_out)),
            "backward_ms": device_ms(lambda: gru_seq.recurrence_backward(xp, w_hh, b_hh, out, grad_out)),
            "wrapper_fwd_bwd_ms": device_ms(lambda: gru_seq.bigru(*leaves).backward(grad_out)),
            "nn_gru_fwd_bwd_ms": device_ms(lambda: lib(x_lib)[0].backward(grad_out))}


if __name__ == "__main__":
    raise SystemExit(main())
