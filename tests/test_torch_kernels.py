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
    configures, and caches the two directions apart."""
    calls = []

    def limits(index, hidden, backward=False):
        calls.append(backward)
        return 132, ((1, 3), (2, 3), (4, 2 if backward else 3))

    monkeypatch.setattr(gru_seq, "_device_limits", limits)
    gru_seq._config.cache_clear()
    try:
        dev = torch.device("cuda", 0)
        assert gru_seq.config_for(3072, 32, dev) == gru_seq.LaunchConfig(4, 384, 3, 1)
        assert gru_seq.config_for(3072, 32, dev, backward=True) == gru_seq.LaunchConfig(4, 384, 2, 2)
        assert gru_seq.config_for(3072, 32, dev, backward=True).waves == 2
        assert calls == [False, True]
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


def backward_case(rng, n, t, c, h, device):
    """Projections, weights, the forward's output and a cotangent for K1's
    backward, on ``device``."""
    x = torch.from_numpy(rng.random((n, t, c), dtype=np.float32)).to(device)
    fw, bw = (torch_params(p, device) for p in gru_params(rng, c, h))
    xp = rnn.input_projection(x, fw, bw).contiguous()
    w_hh = torch.stack([fw["w_hh"], bw["w_hh"]]).contiguous()
    b_hh = torch.stack([fw["b_hh"], bw["b_hh"]]).contiguous()
    out = rnn.bigru_recurrence(xp, w_hh, b_hh)
    grad_out = torch.from_numpy(rng.standard_normal((n, t, 2 * h)).astype(np.float32)).to(device)
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


PTXAS_LOG = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116bigru_seq_kernelILi32ELi4EEEvPKfS2_S2_Pfii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116bigru_seq_kernelILi32ELi4EEEvPKfS2_S2_Pfii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116bigru_seq_kernelILi8ELi1EEEvPKfS2_S2_Pfii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116bigru_seq_kernelILi8ELi1EEEvPKfS2_S2_Pfii
    16 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 61 registers, used 1 barriers, 400 bytes cmem[0]
"""


def test_ptxas_report_reads_each_instantiation():
    assert ptxas_report(PTXAS_LOG) == [
        {"H": 32, "rpt": 4, "registers": 168, "spill_bytes": 0, "stack_bytes": 0,
         "smem_bytes": 4 * (4 * 16 * 96 + 2 * 16 * 32)},
        {"H": 8, "rpt": 1, "registers": 61, "spill_bytes": 12, "stack_bytes": 16,
         "smem_bytes": 4 * (4 * 16 * 24 + 2 * 16 * 8)},
    ]


BWD_PTXAS_LOG = """ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_125bigru_seq_backward_kernelILi32ELi4EEEvPKfS2_S2_S2_S2_PfS3_S3_iii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_125bigru_seq_backward_kernelILi32ELi4EEEvPKfS2_S2_S2_S2_PfS3_S3_iii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 166 registers, used 0 barriers, 432 bytes cmem[0]
"""


def test_ptxas_report_reads_the_backward():
    """The backward's instantiations, with its two h_{t-1} buffers as shared
    memory; the forward's report skips them, and the reverse."""
    assert ptxas_report(BWD_PTXAS_LOG, backward=True) == [
        {"H": 32, "rpt": 4, "registers": 166, "spill_bytes": 0, "stack_bytes": 0, "smem_bytes": 4 * 2 * 16 * 32}]
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
