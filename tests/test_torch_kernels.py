"""K1's wrapper (``tpgsr_tpu_torch.ops.gru_seq``) against its plain version.

Imports no JAX, so the card's tests run where only PyTorch is installed:

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -p no:cacheprovider

Tests marked ``cuda`` skip themselves where there is no card."""

import numpy as np
import pytest
import torch

from tpgsr_tpu_torch import ablate_k1
from tpgsr_tpu_torch.bench_k1 import ptxas_report
from tpgsr_tpu_torch.ops import _build, gru_seq, rnn

# (N, T, C, H): the tests/test_rnn.py case, a ragged N, T = 1, the widest hidden
GRU_CASES = [(24, 16, 12, 8), (7, 5, 6, 16), (5, 1, 8, 8), (13, 9, 16, 32)]
# the flagship's two sweeps at batch 48, and a ragged N at their width
MAIN_PATH_CASES = [(768, 64, 64, 32), (3072, 16, 64, 32), (771, 64, 64, 32)]
# the ring's and the rows-a-thread edges at the flagship's width: two rows a
# thread (ragged), four rows a thread (ragged), T < S, T not a multiple of S
EDGE_CASES = [(1500, 16, 64, 32), (3070, 16, 64, 32), (37, 3, 64, 32), (45, 13, 64, 32)]
H100 = {"sms": 132, "blocks_per_sm": dict.fromkeys(gru_seq.RPTS, 3)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def gru_params(rng, c, h, scale=0.3):
    def one():
        return {
            "w_ih": rng.standard_normal((3 * h, c)).astype(np.float32) * scale,
            "w_hh": rng.standard_normal((3 * h, h)).astype(np.float32) * scale,
            "b_ih": rng.standard_normal((3 * h,)).astype(np.float32) * scale,
            "b_hh": rng.standard_normal((3 * h,)).astype(np.float32) * scale,
        }

    return one(), one()


def torch_params(p, device="cpu"):
    return {k: torch.from_numpy(v).to(device) for k, v in p.items()}


def test_bigru_wrapper_cpu_takes_plain_version():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.random((6, 4, 8), dtype=np.float32))
    fw, bw = (torch_params(p) for p in gru_params(rng, 8, 8))
    before = gru_seq.LAUNCHES
    got = gru_seq.bigru(x, fw, bw)
    assert gru_seq.LAUNCHES == before
    torch.testing.assert_close(got, rnn.bigru(x, fw, bw), rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["rank", "empty", "w_ih_shape", "dtype"])
def test_bigru_wrapper_rejects_bad_input(bad):
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.random((6, 4, 8), dtype=np.float32))
    fw, bw = (torch_params(p) for p in gru_params(rng, 8, 8))
    if bad == "rank":
        x = x[0]
    elif bad == "empty":
        x = x[:0]
    elif bad == "w_ih_shape":
        fw["w_ih"] = fw["w_ih"][:, :4]
    else:
        bw["b_hh"] = bw["b_hh"].double()
    with pytest.raises(ValueError):
        gru_seq.bigru(x, fw, bw)


@pytest.mark.parametrize("n,rpt,blocks", [(768, 1, 384), (3072, 4, 384)])
def test_launch_config_flagship_sweeps_take_one_wave(n, rpt, blocks):
    """At batch 48, over W (N = 768) and over H (N = 3,072), H = 32."""
    cfg = gru_seq.launch_config(n, 32, **H100)
    assert (cfg.rpt, cfg.blocks, cfg.waves) == (rpt, blocks, 1)


@pytest.mark.parametrize("h", gru_seq.SUPPORTED_HIDDEN)
@pytest.mark.parametrize("n", [1, 5, 37, 771, 1500, 3070, 3072, 100_000])
def test_launch_config_covers_every_row_with_no_idle_block(n, h):
    cfg = gru_seq.launch_config(n, h, **H100)
    rows = gru_seq.THREADS // h * cfg.rpt
    assert cfg.blocks % 2 == 0
    assert (cfg.blocks // 2) * rows >= n > (cfg.blocks // 2 - 1) * rows
    assert cfg.waves == -(-cfg.blocks // (132 * 3))


@pytest.mark.parametrize("n,h,want", [(792, 32, 1), (793, 32, 2), (1584, 32, 2), (1585, 32, 4),
                                      (3168, 32, 4), (6336, 8, 2), (6337, 8, 4), (3168, 16, 2)])
def test_launch_config_takes_the_smallest_rpt_that_fits(n, h, want):
    cfg = gru_seq.launch_config(n, h, **H100)
    assert cfg.rpt == want and cfg.waves == 1
    for smaller in gru_seq.RPTS[: gru_seq.RPTS.index(want)]:
        assert 2 * -(-n // (gru_seq.THREADS // h * smaller)) > 132 * 3


@pytest.mark.parametrize("n", [3169, 50_000])
def test_launch_config_too_many_rows_take_the_largest_rpt(n):
    cfg = gru_seq.launch_config(n, 32, **H100)
    assert cfg.rpt == max(gru_seq.RPTS) and cfg.waves > 1


def test_launch_config_backward_takes_one_wave_over_h():
    """The backward's occupancy at three blocks an SM for every rows a
    thread: the flagship's sweep over H (N = 3,072, H = 32) takes 4 rows a
    thread and 384 blocks, one wave on 132 SMs; over W, 1 row a thread."""
    backward = {1: 3, 2: 3, 4: 3}
    assert gru_seq.launch_config(3072, 32, 132, backward) == gru_seq.LaunchConfig(4, 384, 3, 1)
    assert gru_seq.launch_config(768, 32, 132, backward) == gru_seq.LaunchConfig(1, 384, 3, 1)


def test_launch_config_backward_falls_back_when_four_rows_fit_fewer_blocks():
    """Where 4 rows a thread fit two blocks an SM, no rows a thread gives one
    wave over H, and the largest is taken with the waves it needs."""
    assert gru_seq.launch_config(3072, 32, 132, {1: 3, 2: 3, 4: 2}) == gru_seq.LaunchConfig(4, 384, 2, 2)


def test_backward_config_reads_the_backward_occupancy(monkeypatch):
    """``config_for`` feeds ``launch_config`` the occupancy of the kernel it
    configures, and caches the two directions and the two storage types
    apart."""
    calls = []

    def limits(index, hidden, backward=False, bf16=0):
        calls.append((backward, bf16))
        return 132, ((1, 3), (2, 3), (4, 2 if backward or bf16 else 3))

    monkeypatch.setattr(gru_seq, "_device_limits", limits)
    gru_seq._config.cache_clear()
    try:
        dev = torch.device("cuda", 0)
        assert gru_seq.config_for(3072, 32, dev) == gru_seq.LaunchConfig(4, 384, 3, 1)
        assert gru_seq.config_for(3072, 32, dev, backward=True) == gru_seq.LaunchConfig(4, 384, 2, 2)
        assert gru_seq.config_for(3072, 32, dev, backward=True).waves == 2
        assert gru_seq.config_for(3072, 32, dev, dtype=torch.bfloat16) == gru_seq.LaunchConfig(4, 384, 2, 2)
        assert calls == [(False, 0), (True, 0), (False, 1)]
        with pytest.raises(TypeError):
            gru_seq.config_for(3072, 32, dev, dtype=torch.float16)
    finally:
        gru_seq._config.cache_clear()


def test_launch_config_follows_the_occupancy_of_each_rpt():
    cfg = gru_seq.launch_config(3072, 32, 132, {1: 4, 2: 4, 4: 2})
    assert (cfg.rpt, cfg.blocks_per_sm, cfg.waves) == (4, 2, 2)
    with pytest.raises(ValueError):
        gru_seq.launch_config(3072, 32, 132, {1: 3, 2: 3, 4: 0})


@pytest.mark.cuda
@pytest.mark.parametrize("n,t,c,h", GRU_CASES + MAIN_PATH_CASES + EDGE_CASES)
def test_bigru_kernel_matches_plain_on_card(cuda, n, t, c, h):
    """K1 against its plain version on the card; 2e-5 at T = 64, where 64
    dependent steps compound the differently ordered fp32 sums."""
    rng = np.random.default_rng(n + t)
    x = torch.from_numpy(rng.random((n, t, c), dtype=np.float32)).to(cuda)
    fw, bw = (torch_params(p, cuda) for p in gru_params(rng, c, h))
    before = gru_seq.LAUNCHES
    got = gru_seq.bigru(x, fw, bw)
    torch.cuda.synchronize()
    assert gru_seq.LAUNCHES == before + 1
    torch.testing.assert_close(got, rnn.bigru(x, fw, bw), rtol=0, atol=2e-5 if t >= 64 else 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("rpt", gru_seq.RPTS)
@pytest.mark.parametrize("h", gru_seq.SUPPORTED_HIDDEN)
def test_bigru_kernel_every_instantiation_matches_plain(cuda, h, rpt):
    """Each (H, rows a thread) on a ragged N with T = 13 (not a multiple of
    the ring's 4 slots) and T = 3 (fewer steps than slots)."""
    rng = np.random.default_rng(h * rpt)
    fw, bw = (torch_params(p, cuda) for p in gru_params(rng, 16, h))
    w_t = torch.stack([fw["w_hh"].t(), bw["w_hh"].t()]).contiguous()
    b_hh = torch.stack([fw["b_hh"], bw["b_hh"]])
    rows = gru_seq.THREADS // h * rpt
    for n, t in ((2 * rows + 3, 13), (rows - 1, 3)):
        x = torch.from_numpy(rng.random((n, t, 16), dtype=np.float32)).to(cuda)
        xp = rnn.input_projection(x, fw, bw).contiguous()
        cfg = gru_seq.LaunchConfig(rpt, 0, 0, 0)
        got = gru_seq._recurrence(xp, w_t, b_hh, config=cfg)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, rnn.bigru_recurrence(xp, torch.stack([fw["w_hh"], bw["w_hh"]]), b_hh),
                                   rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_bigru_kernel_rejects_unsupported_hidden(cuda):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.random((4, 3, 8), dtype=np.float32)).to(cuda)
    fw, bw = (torch_params(p, cuda) for p in gru_params(rng, 8, 12))
    with pytest.raises(ValueError):
        gru_seq.bigru(x, fw, bw)


def backward_case(rng, n, t, c, h, device, dtype=torch.float32):
    """Projections, weights, the forward's output and a cotangent for K1's
    backward, on ``device``: x, xp, out and the cotangent in ``dtype``, the
    weights in fp32."""
    x = torch.from_numpy(rng.random((n, t, c), dtype=np.float32)).to(device, dtype)
    fw, bw = (torch_params(p, device) for p in gru_params(rng, c, h))
    xp = rnn.input_projection(x, fw, bw).contiguous()
    w_hh = torch.stack([fw["w_hh"], bw["w_hh"]]).contiguous()
    b_hh = torch.stack([fw["b_hh"], bw["b_hh"]]).contiguous()
    out = rnn.bigru_recurrence(xp, w_hh, b_hh)
    grad_out = torch.from_numpy(rng.standard_normal((n, t, 2 * h)).astype(np.float32)).to(device, dtype)
    return xp, w_hh, b_hh, out, grad_out


@pytest.mark.cuda
@pytest.mark.parametrize("n,t,c,h", GRU_CASES + MAIN_PATH_CASES + EDGE_CASES)
def test_bigru_kernel_backward_matches_plain_on_card(cuda, n, t, c, h):
    """K1's backward kernel (and the GEMM for dW_hh, db_hh) against the plain
    BPTT on the card.  dxp at 2e-5, 5e-5 at T = 64 where the reverse chain
    compounds differently ordered sums over 64 steps; dW_hh and db_hh, sums
    over N * T steps, relative to their largest entry at 1e-5."""
    rng = np.random.default_rng(10 * n + t)
    xp, w_hh, b_hh, out, grad_out = backward_case(rng, n, t, c, h, cuda)
    before = gru_seq.BACKWARD_LAUNCHES
    got = gru_seq.recurrence_backward(xp, w_hh, b_hh, out, grad_out)
    torch.cuda.synchronize()
    assert gru_seq.BACKWARD_LAUNCHES == before + 1
    want = rnn.bigru_recurrence_backward(xp, w_hh, b_hh, out, grad_out)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=5e-5 if t >= 64 else 2e-5)
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5 * float(w.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("rpt", gru_seq.RPTS)
@pytest.mark.parametrize("h", gru_seq.SUPPORTED_HIDDEN)
def test_bigru_kernel_backward_every_instantiation_matches_plain(cuda, h, rpt):
    """Each (H, rows a thread) of the backward kernel, forced, on a ragged N
    with T = 13 and T = 3, against the plain BPTT at the tolerances above;
    one launch a call."""
    rng = np.random.default_rng(100 * h + rpt)
    rows = gru_seq.THREADS // h * rpt
    for n, t in ((2 * rows + 3, 13), (rows - 1, 3)):
        xp, w_hh, b_hh, out, grad_out = backward_case(rng, n, t, 16, h, cuda)
        w_t = w_hh.transpose(1, 2).contiguous()
        before = gru_seq.BACKWARD_LAUNCHES
        dxp, dhp, h_prev = gru_seq._backward_kernel(xp, w_t, b_hh, out, grad_out,
                                                    config=gru_seq.LaunchConfig(rpt, 0, 0, 0))
        got = (dxp, *gru_seq.recurrent_weight_grads(dhp, h_prev))
        torch.cuda.synchronize()
        assert gru_seq.BACKWARD_LAUNCHES == before + 1
        want = rnn.bigru_recurrence_backward(xp, w_hh, b_hh, out, grad_out)
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=2e-5)
        for g, w in zip(got[1:], want[1:]):
            torch.testing.assert_close(g, w, rtol=0, atol=1e-5 * float(w.abs().max()))


@pytest.mark.cuda
def test_bigru_autograd_on_card_launches_both_kernels(cuda):
    """The wrapper's gradients on the card through both kernels, against
    autograd through the plain version on the same card."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.random((37, 13, 16), dtype=np.float32)).to(cuda)
    fw, bw = (torch_params(p, cuda) for p in gru_params(rng, 16, 16))
    grads = []
    for fn in (gru_seq.bigru, rnn.bigru):
        leaves = [x.clone().requires_grad_(True)] + [
            {k: v.clone().requires_grad_(True) for k, v in d.items()} for d in (fw, bw)]
        before = (gru_seq.LAUNCHES, gru_seq.BACKWARD_LAUNCHES)
        fn(*leaves).square().sum().backward()
        torch.cuda.synchronize()
        launched = (gru_seq.LAUNCHES - before[0], gru_seq.BACKWARD_LAUNCHES - before[1])
        assert launched == ((1, 1) if fn is gru_seq.bigru else (0, 0))
        grads.append([leaves[0].grad] + [d[k].grad for d in leaves[1:] for k in sorted(d)])
    for g, w in zip(*grads):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


def bf16_ulp(t):
    """The spacing of bf16 values at each element of ``t``: 2^(e - 7) for |t|
    in [2^e, 2^(e+1))."""
    mag = t.float().abs().clamp_min(2.0**-126)
    return torch.finfo(torch.bfloat16).eps * torch.exp2(torch.floor(torch.log2(mag)))


def assert_within_bf16_ulp(got, want, atol):
    """Each element of ``got`` (bf16) within one bf16 ulp of ``want`` plus
    ``atol``: the fp32 states of kernel and plain version differ by the order
    of their sums (``atol``, the fp32 tests' tolerance), which can move the
    rounding to bf16 by one ulp."""
    assert got.dtype == want.dtype == torch.bfloat16
    diff = (got.float() - want.float()).abs()
    bound = bf16_ulp(want) + atol
    assert bool((diff <= bound).all()), f"max excess {float((diff - bound).max()):.3g}"


@pytest.mark.cuda
@pytest.mark.parametrize("n,t,c,h", GRU_CASES + MAIN_PATH_CASES + EDGE_CASES)
def test_bigru_kernel_bf16_matches_plain_on_card(cuda, n, t, c, h):
    """K1 in bf16 (bf16 x, fp32 parameters) against its bf16 plain version on
    the card: out within one bf16 ulp; one launch."""
    rng = np.random.default_rng(n + t + 1)
    x = torch.from_numpy(rng.random((n, t, c), dtype=np.float32)).to(cuda).bfloat16()
    fw, bw = (torch_params(p, cuda) for p in gru_params(rng, c, h))
    before = gru_seq.LAUNCHES
    got = gru_seq.bigru(x, fw, bw)
    torch.cuda.synchronize()
    assert gru_seq.LAUNCHES == before + 1
    assert_within_bf16_ulp(got, rnn.bigru(x, fw, bw), atol=2e-5 if t >= 64 else 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("rpt", gru_seq.RPTS)
@pytest.mark.parametrize("h", gru_seq.SUPPORTED_HIDDEN)
def test_bigru_kernel_bf16_every_instantiation_matches_plain(cuda, h, rpt):
    """Each bf16 (H, rows a thread), forced, on a ragged N with T = 13 and T = 3."""
    rng = np.random.default_rng(h * rpt + 1)
    fw, bw = (torch_params(p, cuda) for p in gru_params(rng, 16, h))
    w_hh = torch.stack([fw["w_hh"], bw["w_hh"]])
    b_hh = torch.stack([fw["b_hh"], bw["b_hh"]])
    rows = gru_seq.THREADS // h * rpt
    for n, t in ((2 * rows + 3, 13), (rows - 1, 3)):
        x = torch.from_numpy(rng.random((n, t, 16), dtype=np.float32)).to(cuda).bfloat16()
        xp = rnn.input_projection(x, fw, bw).contiguous()
        got = gru_seq._recurrence(xp, *gru_seq._kernel_weights(xp, w_hh, b_hh),
                                  config=gru_seq.LaunchConfig(rpt, 0, 0, 0))
        torch.cuda.synchronize()
        assert_within_bf16_ulp(got, rnn.bigru_recurrence(xp, w_hh, b_hh), atol=1e-5)


def assert_backward_bf16_close(got, want, atol):
    """dxp within one bf16 ulp plus ``atol``; dW_hh and db_hh, fp32 sums of
    fp32 terms, at 1e-4 of their largest entry."""
    assert_within_bf16_ulp(got[0], want[0], atol)
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == w.dtype == torch.float32
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * float(w.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("n,t,c,h", GRU_CASES + MAIN_PATH_CASES + EDGE_CASES)
def test_bigru_kernel_bf16_backward_matches_plain_on_card(cuda, n, t, c, h):
    """K1's backward in bf16 (xp, out, grad_out and dxp in bf16) and the fp32
    GEMM for dW_hh, db_hh, against the bf16 plain BPTT on the card."""
    rng = np.random.default_rng(10 * n + t + 1)
    xp, w_hh, b_hh, out, grad_out = backward_case(rng, n, t, c, h, cuda, torch.bfloat16)
    before = gru_seq.BACKWARD_LAUNCHES
    got = gru_seq.recurrence_backward(xp, w_hh, b_hh, out, grad_out)
    torch.cuda.synchronize()
    assert gru_seq.BACKWARD_LAUNCHES == before + 1
    assert_backward_bf16_close(got, rnn.bigru_recurrence_backward(xp, w_hh, b_hh, out, grad_out),
                               atol=5e-5 if t >= 64 else 2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("rpt", gru_seq.RPTS)
@pytest.mark.parametrize("h", gru_seq.SUPPORTED_HIDDEN)
def test_bigru_kernel_bf16_backward_every_instantiation_matches_plain(cuda, h, rpt):
    """Each bf16 (H, rows a thread) of the backward kernel, forced, on a
    ragged N with T = 13 and T = 3 (at four rows a thread h_{t-1} passes
    through shared memory in bf16, copied two columns an even lane)."""
    rng = np.random.default_rng(100 * h + rpt + 1)
    rows = gru_seq.THREADS // h * rpt
    for n, t in ((2 * rows + 3, 13), (rows - 1, 3)):
        xp, w_hh, b_hh, out, grad_out = backward_case(rng, n, t, 16, h, cuda, torch.bfloat16)
        dxp, dhp, h_prev = gru_seq._backward_kernel(xp, *gru_seq._kernel_weights(xp, w_hh, b_hh), out, grad_out,
                                                    config=gru_seq.LaunchConfig(rpt, 0, 0, 0))
        got = (dxp, *gru_seq.recurrent_weight_grads(dhp, h_prev))
        torch.cuda.synchronize()
        assert_backward_bf16_close(got, rnn.bigru_recurrence_backward(xp, w_hh, b_hh, out, grad_out), atol=2e-5)


@pytest.mark.cuda
def test_bigru_autograd_bf16_on_card_launches_both_kernels(cuda):
    """The wrapper in bf16 on the card: x's gradient in bf16, the fp32
    parameters' in fp32, each within 1e-2 relative L2 of autograd through the
    bf16 plain version, which recomputes from its fp32 state where the
    kernel reads out's bf16 values."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.random((37, 13, 16), dtype=np.float32)).to(cuda).bfloat16()
    fw, bw = (torch_params(p, cuda) for p in gru_params(rng, 16, 16))
    grads = []
    for fn in (gru_seq.bigru, rnn.bigru):
        leaves = [x.clone().requires_grad_(True)] + [
            {k: v.clone().requires_grad_(True) for k, v in d.items()} for d in (fw, bw)]
        before = (gru_seq.LAUNCHES, gru_seq.BACKWARD_LAUNCHES)
        fn(*leaves).float().square().sum().backward()
        torch.cuda.synchronize()
        launched = (gru_seq.LAUNCHES - before[0], gru_seq.BACKWARD_LAUNCHES - before[1])
        assert launched == ((1, 1) if fn is gru_seq.bigru else (0, 0))
        grads.append([leaves[0].grad] + [d[k].grad for d in leaves[1:] for k in sorted(d)])
    assert grads[0][0].dtype == torch.bfloat16 and all(g.dtype == torch.float32 for g in grads[0][1:])
    for g, w in zip(*grads):
        rel = float((g.float() - w.float()).norm() / w.float().norm())
        assert rel <= 1e-2, rel


PTXAS_LOG = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116bigru_seq_kernelIfLi32ELi4EEEvPKT_PKfS6_PS3_ii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116bigru_seq_kernelIfLi32ELi4EEEvPKT_PKfS6_PS3_ii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116bigru_seq_kernelI13__nv_bfloat16Li8ELi1EEEvPKT_PKfS7_PS4_ii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116bigru_seq_kernelI13__nv_bfloat16Li8ELi1EEEvPKT_PKfS7_PS4_ii
    16 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 61 registers, used 1 barriers, 400 bytes cmem[0]
"""


def test_ptxas_report_reads_each_instantiation():
    """Each instantiation by storage type, with its xp ring (4 slots of the
    storage type) and two fp32 h buffers as shared memory."""
    assert ptxas_report(PTXAS_LOG) == [
        {"dtype": "fp32", "H": 32, "rpt": 4, "registers": 168, "spill_bytes": 0, "stack_bytes": 0,
         "smem_bytes": 4 * (4 * 16 * 96 + 2 * 16 * 32)},
        {"dtype": "bf16", "H": 8, "rpt": 1, "registers": 61, "spill_bytes": 12, "stack_bytes": 16,
         "smem_bytes": 2 * 4 * 16 * 24 + 4 * 2 * 16 * 8},
    ]


BWD_PTXAS_LOG = """ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_125bigru_seq_backward_kernelIfLi32ELi4EEEvPKT_PKfS6_S4_S4_PS2_PfS8_iii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_125bigru_seq_backward_kernelIfLi32ELi4EEEvPKT_PKfS6_S4_S4_PS2_PfS8_iii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 166 registers, used 0 barriers, 432 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_125bigru_seq_backward_kernelI13__nv_bfloat16Li32ELi4EEEvPKT_PKfS7_S5_S5_PS3_PfS9_iii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_125bigru_seq_backward_kernelI13__nv_bfloat16Li32ELi4EEEvPKT_PKfS7_S5_S5_PS3_PfS9_iii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 160 registers, used 0 barriers, 432 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_125bigru_seq_backward_kernelI13__nv_bfloat16Li32ELi1EEEvPKT_PKfS7_S5_S5_PS3_PfS9_iii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_125bigru_seq_backward_kernelI13__nv_bfloat16Li32ELi1EEEvPKT_PKfS7_S5_S5_PS3_PfS9_iii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 150 registers, used 0 barriers, 432 bytes cmem[0]
"""


def test_ptxas_report_reads_the_backward():
    """The backward's instantiations, with its two h_{t-1} buffers as shared
    memory: of the storage type at four rows a thread (copied by cp.async),
    fp32 below; the forward's report skips them, and the reverse."""
    assert ptxas_report(BWD_PTXAS_LOG, backward=True) == [
        {"dtype": "fp32", "H": 32, "rpt": 4, "registers": 166, "spill_bytes": 0, "stack_bytes": 0,
         "smem_bytes": 4 * 2 * 16 * 32},
        {"dtype": "bf16", "H": 32, "rpt": 4, "registers": 160, "spill_bytes": 0, "stack_bytes": 0,
         "smem_bytes": 2 * 2 * 16 * 32},
        {"dtype": "bf16", "H": 32, "rpt": 1, "registers": 150, "spill_bytes": 0, "stack_bytes": 0,
         "smem_bytes": 4 * 2 * 4 * 32}]
    assert ptxas_report(BWD_PTXAS_LOG) == []
    assert ptxas_report(PTXAS_LOG, backward=True) == []


def _check_ablation_variants(backward):
    file, table = ablate_k1._kernel(backward)
    source = (_build.CSRC / file).read_text()
    variants = ablate_k1.variant_sources(backward)
    assert set(variants) == set(table)
    for name, (text, flags) in variants.items():
        changed = text != source
        assert changed == bool(table[name][0]), name
        assert changed or flags or name == "full", name


def test_ablation_variants_match_the_kernel_source():
    """Each variant's substitutions occur once in csrc/bigru_seq.cu, so the
    ablation times what it says it removes."""
    _check_ablation_variants(backward=False)


def test_backward_ablation_variants_match_the_kernel_source():
    """The same for the backward's variants in csrc/bigru_seq_bwd.cu; at most
    four besides the full kernel."""
    assert len(ablate_k1.BACKWARD_VARIANTS) <= 5
    _check_ablation_variants(backward=True)
