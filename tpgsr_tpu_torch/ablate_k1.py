"""Where K1's time goes: variants of csrc/bigru_seq.cu (or, with
``--backward``, of csrc/bigru_seq_bwd.cu; with ``--bf16``, of the tensor-core
forward csrc/bigru_seq_bf16.cu), each with one part taken out, timed at the
flagship's two sweeps on one NVIDIA card.

    python -m tpgsr_tpu_torch.ablate_k1 [--backward | --bf16] [--hidden H]

The card's profilers do not run on the machines this port is measured on, so
this stands in for them.  Each variant is the kernel's source with a text
substitution (or an nvcc flag), built into ``build/ablate/``; its results are
wrong by design, and only its time is read.  The difference between a
variant's time and the full kernel's is what the removed part costs on the
critical path.  Every substitution must match the source once, so an edit of
the kernel that moves one of them stops this script instead of timing the
wrong thing.  It times the fp32 instantiations, or with ``--bf16`` the bf16
ones, at hidden size ``--hidden`` (32 by default, the flagship's; 8 and 16
are the sources' other sizes, and with ``--bf16`` also 64 and 128) with C =
2H.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from tpgsr_tpu_torch.bench_k1 import H, SWEEPS, case, device_ms, ptxas_report
from tpgsr_tpu_torch.ops import _build, gru_seq, rnn

OUT_DIR = _build.BUILD_DIR.parent / "ablate"

_PARTIALS = "kPartials = 2;"
_H_LOAD = "const float4 h4 = *reinterpret_cast<const float4*>(hb + (g * RPT + i) * H + k);"
# name -> (substitutions, extra nvcc flags, what it removes)
VARIANTS = {
    "full": ((), (), "nothing"),
    "fast_math": ((), ("--use_fast_math",), "accurate expf, tanhf and division (fast approximations instead)"),
    "no_matvec": ((("for (int k = 0; k < H; k += 4) {", "for (int k = 0; k < 0; k += 4) {"),), (),
                  "the recurrent mat-vec h W_hh^T"),
    "no_gates": ((("const float rg = sigmoid_f32(to_f32(x[j]) + sr);", "const float rg = to_f32(x[j]) + sr;"),
                  ("const float zg = sigmoid_f32(to_f32(x[H + j]) + sz);", "const float zg = to_f32(x[H + j]) + sz;"),
                  ("const float ng = tanhf(to_f32(x[2 * H + j]) + rg * sn);",
                   "const float ng = to_f32(x[2 * H + j]) + rg * sn;")),
                 (), "the gates' sigmoid and tanh"),
    "no_out_store": ((("if (row < n) out[", "if (row < n && t == t_len - 1) out["),), (),
                     "the store of out at every step but the last"),
    "no_ring_refill": ((("if (t + S - 1 < t_len) stage(t + S - 1);", ""),), (),
                       "the cp.async refill of the ring inside the loop"),
    "block_barrier": ((("cp_async_wait<S - 2>();\n    __syncwarp();", "cp_async_wait<S - 2>();\n    __syncthreads();"),), (),
                      "nothing: a block barrier a step instead of a warp barrier"),
    "no_register_cap": ((("constexpr int kMinBlocks = 3;", "constexpr int kMinBlocks = 1;"),), (),
                        "the register cap of three blocks an SM"),
    "sigmoid_exp_div": ((("return fmaf(0.5f, tanhf(0.5f * x), 0.5f);", "return 1.0f / (1.0f + expf(-x));"),), (),
                        "nothing: sigmoid as 1 / (1 + expf(-x)) instead of through tanhf"),
    "no_h_loads": (((_H_LOAD, "const float4 h4 = make_float4(h[i], h[i], h[i], h[i]);"),), (),
                   "the shared-memory loads of h in the mat-vec (the FMAs stay)"),
    "h_loads_32bit": (((_H_LOAD, "const float* hp = hb + (g * RPT + i) * H + k;\n"
                                 "      const float4 h4 = make_float4(hp[0], hp[1], hp[2], hp[3]);"),), (),
                      "nothing: h read 4 bytes a load instead of 16"),
    "unskewed": ((("constexpr int RA = RPT / 2;", "constexpr int RA = 0;"),), (),
                 "the skew: every row's mat-vec, then every row's gates"),
    **{f"partials_{p}": (((_PARTIALS, f"kPartials = {p};"),), (),
                         f"nothing: {p} partial sums a gate at every rows a thread")
       for p in (1, 4)},
}

_BWD_STORES = "if ((valid >> i) & 1u) {"
# the same for the backward kernel, csrc/bigru_seq_bwd.cu
BACKWARD_VARIANTS = {
    "full": ((), (), "nothing"),
    "fast_math": ((), ("--use_fast_math",), "accurate tanhf (fast approximations instead)"),
    "no_shuffles": ((("return __shfl_xor_sync(kFullMask, x, lane_mask);", "return x;"),), (),
                    "the reduce-scatter's shuffles for W_hh^T dhp (its FMAs and adds stay)"),
    "no_recompute": ((("for (int a = 0; a < H / 4; ++a) {", "for (int a = 0; a < 0; ++a) {"),), (),
                     "the recompute's mat-vec W_hh h_{t-1} and its h loads (the gates stay)"),
    "no_stores": (((_BWD_STORES, "if (((valid >> i) & 1u) && s == 0) {"),), (),
                  "the dxp, dhp and h_{t-1} stores at every step but the last"),
}


_PRODUCTS = "for (int p = 0; p < Sh::kProducts; ++p) {"
_PRODUCT_BLOCKS = "for (int kb = 0; kb < Sh::kBlocksK; ++kb)\n#pragma unroll\n      for (int p = 0;"
# the same for the bf16 forward on the tensor cores, csrc/bigru_seq_bf16.cu
BF16_VARIANTS = {
    "full": ((), (), "nothing"),
    "fast_math": ((), ("--use_fast_math",), "accurate tanhf (fast approximations instead)"),
    "one_product": (((_PRODUCTS, _PRODUCTS.replace("p < Sh::kProducts", "p < 1")),), (),
                    "the products of h's third bf16 term (and at 16 rows an m-tile its second)"),
    "no_products": (((_PRODUCT_BLOCKS, _PRODUCT_BLOCKS.replace("kb < Sh::kBlocksK", "kb < 0")),), (),
                    "the recurrent products h W_hh^T and their fragments' loads"),
    "no_out_store": ((("if (row0 + r < n) *reinterpret_cast<uint32_t*>(out",
                       "if (row0 + r < n && t == t_len - 1) *reinterpret_cast<uint32_t*>(out"),), (),
                     "the store of out at every step but the last"),
}


def _kernel(backward: bool, bf16: bool = False):
    """(source file, its variants) of K1's forward or backward, or the bf16 forward."""
    if bf16:
        return "bigru_seq_bf16.cu", BF16_VARIANTS
    return ("bigru_seq_bwd.cu", BACKWARD_VARIANTS) if backward else ("bigru_seq.cu", VARIANTS)


def variant_sources(backward: bool = False, bf16: bool = False):
    """name -> (source text, extra nvcc flags) of every variant."""
    file, variants = _kernel(backward, bf16)
    source = (_build.CSRC / file).read_text()
    out = {}
    for name, (subs, flags, _) in variants.items():
        text = source
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} occurs {text.count(old)} times in {file}")
            text = text.replace(old, new)
        out[name] = (text, flags)
    return out


def build_variants(backward: bool = False, bf16: bool = False, hidden: int = H):
    out_dir = OUT_DIR / ("backward" if backward else "forward_bf16" if bf16 else "forward")
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, (text, flags) in variant_sources(backward, bf16).items():
        src, lib = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
        src.write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(lib), str(src)]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        regs = {f"rows{r['rows']}" if bf16 else f"rpt{r['rpt']}": [r["registers"], r["spill_bytes"]]
                for r in ptxas_report(log, backward) if r["H"] == hidden and r["dtype"] == ("bf16" if bf16 else "fp32")}
        libs[name] = (ctypes.CDLL(str(lib)), regs)
    return libs


def _forward_calls(lib, stream, h: int = H):
    """[(label, call(rpt), rpt of the launch configuration)] at both sweeps."""
    fn = lib.tpgsr_bigru_seq_forward
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    calls = []
    for i, (label, n, t) in enumerate(SWEEPS):
        x, fw, bw = case(i, n, t, 2 * h, h)
        xp = rnn.input_projection(x, fw, bw).contiguous()
        w_t = torch.stack([fw["w_hh"].t(), bw["w_hh"].t()]).contiguous()
        b_hh = torch.stack([fw["b_hh"], bw["b_hh"]]).contiguous()
        out = torch.empty(n, t, 2 * h, device="cuda")

        def call(rpt, n=n, t=t, args=(xp, w_t, b_hh, out)):
            return fn(*(a.data_ptr() for a in args), n, t, h, rpt, stream)

        calls.append((label, call, gru_seq.config_for(n, h, x.device).rpt))
    return calls


def _bf16_forward_calls(lib, stream, h: int = H):
    """As ``_forward_calls``, for the bf16 forward: xp and out in bf16, the
    weights rounded to bf16 values; the m-tile's rows in place of rpt."""
    fn = lib.tpgsr_bigru_seq_bf16_forward
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    calls = []
    for i, (label, n, t) in enumerate(SWEEPS):
        x, fw, bw = case(i, n, t, 2 * h, h)
        xp = rnn.input_projection(x.bfloat16(), fw, bw).contiguous()
        w_hh = torch.stack([fw["w_hh"], bw["w_hh"]])
        b_hh = torch.stack([fw["b_hh"], bw["b_hh"]])
        w_t, b_k = gru_seq._kernel_weights(xp, w_hh, b_hh)
        out = torch.empty(n, t, 2 * h, device="cuda", dtype=torch.bfloat16)

        def call(rows, n=n, t=t, args=(xp, w_t, b_k, out)):
            return fn(*(a.data_ptr() for a in args), n, t, h, rows, stream)

        calls.append((label, call, gru_seq.config_for(n, h, x.device, dtype=torch.bfloat16).rows))
    return calls


def _backward_calls(lib, stream, h: int = H):
    """As ``_forward_calls``, for the backward kernel on the forward's output
    and a random cotangent."""
    fn = lib.tpgsr_bigru_seq_backward
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    calls = []
    for i, (label, n, t) in enumerate(SWEEPS):
        x, fw, bw = case(i, n, t, 2 * h, h)
        xp = rnn.input_projection(x, fw, bw).contiguous()
        w_hh = torch.stack([fw["w_hh"], bw["w_hh"]]).contiguous()
        w_t = w_hh.transpose(1, 2).contiguous()
        b_hh = torch.stack([fw["b_hh"], bw["b_hh"]]).contiguous()
        out = gru_seq._launch(xp, w_hh, b_hh)
        grad_out = torch.randn(n, t, 2 * h, device="cuda", generator=torch.Generator("cuda").manual_seed(i))
        n_pad = -(-n // gru_seq._chunk_rows(t)) * gru_seq._chunk_rows(t)
        dxp, dhp, h_prev = torch.empty_like(xp), xp.new_zeros(2, n_pad, t, 3 * h), xp.new_zeros(2, n_pad, t, h)

        def call(rpt, n=n, t=t, n_pad=n_pad, args=(xp, w_t, b_hh, out, grad_out, dxp, dhp, h_prev)):
            return fn(*(a.data_ptr() for a in args), n, n_pad, t, h, rpt, stream)

        calls.append((label, call, gru_seq.config_for(n, h, x.device, backward=True).rpt))
    return calls


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--backward", action="store_true", help="ablate the backward kernel")
    parser.add_argument("--bf16", action="store_true", help="ablate the bf16 forward on the tensor cores")
    parser.add_argument("--hidden", type=int, default=H, choices=gru_seq.SUPPORTED_HIDDEN,
                        help="the hidden size of the instantiations timed (the ablated sources' sizes)")
    args = parser.parse_args()
    backward, bf16, hidden = args.backward, args.bf16, args.hidden
    if backward and bf16:
        parser.error("--bf16 ablates the bf16 forward only")
    if not bf16 and hidden not in gru_seq.NARROW_HIDDEN:
        parser.error(f"the fp32 sources ablated here hold H = {gru_seq.NARROW_HIDDEN}; --bf16 also 64 and 128")
    if not torch.cuda.is_available():
        raise SystemExit("ablate_k1: needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    libs = build_variants(backward, bf16, hidden)
    torch.cuda._sleep(int(2e9))  # about a second of spinning, to read the clock under load
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
                             "--format=csv,noheader"], capture_output=True, text=True, timeout=60).stdout.strip()
    torch.cuda.synchronize()
    print(f"clocks under a spin kernel (sm, max sm, power): {clocks}", flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    variants = _kernel(backward, bf16)[1]
    tag = "ablate_k1 backward " if backward else "ablate_k1 bf16 " if bf16 else "ablate_k1 "
    for name, (lib, regs) in libs.items():
        calls = (_backward_calls if backward else _bf16_forward_calls if bf16 else _forward_calls)(lib, stream, hidden)

        def run(call, rpt):
            err = call(rpt)
            if err:
                raise RuntimeError(f"variant {name}: cudaError {err}")

        kind = "rows" if bf16 else "rpt"
        row = {"variant": name, "removes": variants[name][2]}
        for label, call, rpt in calls:
            row[f"{label} ms"] = device_ms(lambda: run(call, rpt))
            row[f"{label} {kind}"] = rpt
        row[f"registers, spilled bytes at H={hidden}"] = regs
        print(tag + json.dumps(row), flush=True)
        if name == "full":  # the full kernel at every instantiation
            for rpt in gru_seq.TILE_ROWS if bf16 else gru_seq.RPTS:
                forced = {"variant": f"full, {rpt} rows an m-tile" if bf16 else f"full, {rpt} rows a thread"}
                for label, call, _ in calls:
                    forced[f"{label} ms"] = device_ms(lambda: run(call, rpt))
                print(tag + json.dumps(forced), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
