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
# the flagship's two sweeps at batch 512 (the bf16 kernels')
BATCH_512_CASES = [(8192, 64, 64, 32), (32768, 16, 64, 32)]
# the wide kernels: the flagship's sweeps at --hd_u 64 and 128 (C = 2H) at
# batch 48, a ragged N and T = 1; hidden sizes padded to an instantiated one
WIDE_CASES = [(768, 64, 128, 64), (3072, 16, 128, 64), (768, 64, 256, 128), (3072, 16, 256, 128),
              (771, 13, 128, 64), (37, 1, 256, 128)]
PADDED_CASES = [(100, 20, 2, 1), (100, 20, 24, 12), (100, 20, 40, 20), (100, 20, 80, 40), (100, 20, 200, 100)]
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
    rows = gru_seq.block_rows(h, cfg.rpt)
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
        if bf16:
            return 132, ((8, 3), (16, 1 if backward else 2))
        return 132, ((1, 3), (2, 3), (4, 2 if backward else 3))

    monkeypatch.setattr(gru_seq, "_device_limits", limits)
    gru_seq._config.cache_clear()
    try:
        dev = torch.device("cuda", 0)
        assert gru_seq.config_for(3072, 32, dev) == gru_seq.LaunchConfig(4, 384, 3, 1)
        assert gru_seq.config_for(3072, 32, dev, backward=True) == gru_seq.LaunchConfig(4, 384, 2, 2)
        assert gru_seq.config_for(3072, 32, dev, backward=True).waves == 2
        assert gru_seq.config_for(3072, 32, dev, dtype=torch.bfloat16) == gru_seq.TileConfig(16, 384, 2, 2)
        assert gru_seq.config_for(3072, 32, dev, backward=True, dtype=torch.bfloat16) == gru_seq.TileConfig(8, 768, 3, 2)
        assert calls == [(False, 0), (True, 0), (False, 1), (True, 1)]
        with pytest.raises(TypeError):
            gru_seq.config_for(3072, 32, dev, dtype=torch.float16)
    finally:
        gru_seq._config.cache_clear()


@pytest.mark.parametrize("n,h,occupancy,want", [
    (768, 64, {1: 3, 2: 3, 4: 2}, gru_seq.LaunchConfig(1, 384, 3, 1)),
    (3072, 64, {1: 3, 2: 3, 4: 2}, gru_seq.LaunchConfig(4, 384, 2, 2)),
    (768, 128, {1: 1, 2: 1, 4: 1}, gru_seq.LaunchConfig(4, 96, 1, 1)),
    (3072, 128, {1: 1, 2: 1, 4: 1}, gru_seq.LaunchConfig(4, 384, 1, 3)),
    (771, 64, {1: 3, 2: 3, 4: 2}, gru_seq.LaunchConfig(1, 386, 3, 1)),
    (800, 64, {1: 3, 2: 3, 4: 2}, gru_seq.LaunchConfig(2, 200, 3, 1)),
    (768, 64, {8: 2, 16: 2}, gru_seq.TileConfig(16, 96, 2, 1)),
    (3072, 64, {8: 2, 16: 2}, gru_seq.TileConfig(16, 384, 2, 2)),
    (768, 128, {8: 1, 16: 1}, gru_seq.TileConfig(16, 96, 1, 1)),
    (3072, 128, {8: 1, 16: 1}, gru_seq.TileConfig(16, 384, 1, 3)),
    (37, 128, {8: 1, 16: 1}, gru_seq.TileConfig(8, 10, 1, 1))])
def test_launch_config_of_the_wide_kernels(n, h, occupancy, want):
    """fp32 at H = 64 and 128 (csrc/bigru_seq_wide.cu, a ``LaunchConfig``):
    blocks of four row groups of H threads, so ``block_rows`` rows at RPT
    rows a thread: 4, 8 and 16.  At the flagship's sweeps at batch 48 (the
    occupancies an H100 reports for the forward: three, three and two blocks
    an SM at H = 64, one at 128): over W at H = 64 one row a thread in one
    wave; over H and at H = 128 four rows a thread, in the waves they need;
    past one wave at one row, two.  bf16 (the tensor-core kernels, a
    ``TileConfig``): a block is one m-tile of H / 8 warps, 16 rows at the
    flagship's sweeps (two and one blocks an SM at H = 64 and 128, as an
    H100 reports), 8 where the grid's warps at 8 rows fit two a
    sub-partition."""
    assert [gru_seq.block_rows(h, rpt) for rpt in gru_seq.RPTS] == [4, 8, 16]
    assert gru_seq.tile_block_warps(h) == h // 8
    if isinstance(want, gru_seq.TileConfig):
        assert gru_seq.tile_config(n, h, 132, occupancy) == want
    else:
        assert gru_seq.launch_config(n, h, 132, occupancy) == want


@pytest.mark.parametrize("hidden", [0, 129, 256])
def test_padded_hidden_raises_beyond_the_kernels(hidden):
    """K1 takes hidden sizes 1 to 128 on the card; ``bigru`` raises before
    it projects anything (the CPU's plain versions take any size)."""
    with pytest.raises(ValueError, match="1 to 128"):
        gru_seq.padded_hidden(hidden)


def test_padded_hidden_is_the_smallest_instantiated_size_that_holds_it():
    got = [gru_seq.padded_hidden(h) for h in range(1, gru_seq.MAX_HIDDEN + 1)]
    assert got == [min(s for s in gru_seq.SUPPORTED_HIDDEN if s >= h) for h in range(1, 129)]
    assert gru_seq.SUPPORTED_HIDDEN == gru_seq.NARROW_HIDDEN + gru_seq.WIDE_HIDDEN == (8, 16, 32, 64, 128)


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
    rows = gru_seq.block_rows(h, rpt)
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
    """Beyond 128 no kernel takes the hidden size: the wrapper raises before
    it launches anything."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.random((4, 3, 8), dtype=np.float32)).to(cuda)
    fw, bw = (torch_params(p, cuda) for p in gru_params(rng, 8, 129))
    before = gru_seq.LAUNCHES
    with pytest.raises(ValueError, match="1 to 128"):
        gru_seq.bigru(x, fw, bw)
    assert gru_seq.LAUNCHES == before


def padded_operands(x, fw, bw):
    """The wrapper's operands at the instantiated size: (xp, w_hh, b_hh)
    from the zero-padded weights."""
    hp = gru_seq.padded_hidden(fw["w_hh"].shape[-1])
    pfw, pbw = (rnn.pad_hidden(d, hp) for d in (fw, bw))
    return (rnn.input_projection(x, pfw, pbw).contiguous(), torch.stack([pfw["w_hh"], pbw["w_hh"]]),
            torch.stack([pfw["b_hh"], pbw["b_hh"]]))


def assert_fp64_rule(got, plain, fp64, scale=1.0):
    """The wide and padded cases' fp32 tolerance: the kernel's max gap to an
    fp64 recurrence on the same operands at most twice the plain fp32
    version's plus 1e-6, relative to ``scale`` (a fixed atol does not scale
    to sums of up to 3 x 128 terms)."""
    scale = max(scale, 1e-30)  # dW_hh is 0 at T = 1 (h_{t-1} = 0), on every side
    k = float((got.double() - fp64).abs().max()) / scale
    p = float((plain.double() - fp64).abs().max()) / scale
    assert k <= 2 * p + 1e-6, (k, p)


@pytest.mark.cuda
@pytest.mark.parametrize("n,t,c,h", WIDE_CASES + PADDED_CASES)
def test_bigru_wide_and_padded_match_plain_on_card(cuda, n, t, c, h):
    """At --hd_u 64 and 128 (the wide kernel) and at sizes padded to an
    instantiated one: the wrapper's output is the kernel's at the
    instantiated size sliced back, bit for bit, the padded units are 0, and
    the kernel holds the fp64 rule against the plain version; one launch,
    on the wide kernel where the instantiated size is wide."""
    rng = np.random.default_rng(n + t + h)
    x = torch.from_numpy(rng.random((n, t, c), dtype=np.float32)).to(cuda)
    fw, bw = (torch_params(p, cuda) for p in gru_params(rng, c, h, scale=float(1 / np.sqrt(h))))
    xp, w_hh, b_hh = padded_operands(x, fw, bw)
    hp = w_hh.shape[-1]
    before = (gru_seq.LAUNCHES, gru_seq.WIDE_LAUNCHES)
    got = gru_seq.bigru(x, fw, bw)
    torch.cuda.synchronize()
    assert (gru_seq.LAUNCHES - before[0], gru_seq.WIDE_LAUNCHES - before[1]) == (1, int(hp in gru_seq.WIDE_HIDDEN))
    kernel = gru_seq._launch(xp, w_hh, b_hh)
    assert torch.equal(got, rnn.unpad_output(kernel, h))
    assert not kernel.view(n, t, 2, hp)[..., h:].any()
    fp64 = rnn._recurrence(xp.double(), w_hh.double(), b_hh.double(), torch.float64)
    assert_fp64_rule(kernel, rnn.bigru_recurrence(xp, w_hh, b_hh), fp64)


@pytest.mark.cuda
@pytest.mark.parametrize("n,t,c,h", WIDE_CASES + PADDED_CASES)
def test_bigru_wide_and_padded_backward_match_plain_on_card(cuda, n, t, c, h):
    """The backward at the same sizes, on the kernel's own forward output
    and a cotangent zero on the padded units: dxp, dW_hh and db_hh 0 on the
    padded units and within the fp64 rule of the plain BPTT (dW_hh and
    db_hh relative to their largest entry); then the wrapper's gradients,
    through the padding's autograd at the real shapes, against its own on
    the CPU (the plain versions at the real H) at 1e-4 of each norm."""
    rng = np.random.default_rng(10 * n + t + h)
    x = torch.from_numpy(rng.random((n, t, c), dtype=np.float32)).to(cuda)
    fw, bw = (torch_params(p, cuda) for p in gru_params(rng, c, h, scale=float(1 / np.sqrt(h))))
    xp, w_hh, b_hh = padded_operands(x, fw, bw)
    hp = w_hh.shape[-1]
    out = gru_seq._launch(xp, w_hh, b_hh)
    g = torch.from_numpy(rng.standard_normal((n, t, 2 * h)).astype(np.float32)).to(cuda)
    grad_out = torch.zeros(n, t, 2, hp, device=cuda)
    grad_out[..., :h] = g.view(n, t, 2, h)
    grad_out = grad_out.view(n, t, 2 * hp)
    got = gru_seq.recurrence_backward(xp, w_hh, b_hh, out, grad_out)
    torch.cuda.synchronize()
    assert not got[0].view(n, t, 6, hp)[..., h:].any()
    assert not got[1].view(2, 3, hp, hp)[:, :, h:].any() and not got[1][..., h:].any()
    assert not got[2].view(2, 3, hp)[..., h:].any()
    want = rnn.bigru_recurrence_backward(xp, w_hh, b_hh, out, grad_out)
    fp64 = rnn._recurrence_backward(xp.double(), w_hh.double(), b_hh.double(), out.double(), grad_out.double())
    assert_fp64_rule(got[0], want[0], fp64[0])
    for k in (1, 2):
        assert_fp64_rule(got[k], want[k], fp64[k], float(fp64[k].abs().max()))
    grads = []
    for dev in (cuda, torch.device("cpu")):
        leaves = [x.detach().to(dev, copy=True).requires_grad_(True)] + [
            {k: v.detach().to(dev, copy=True).requires_grad_(True) for k, v in d.items()} for d in (fw, bw)]
        gru_seq.bigru(*leaves).backward(g.to(dev))
        grads.append([leaves[0].grad.cpu()] + [d[k].grad.cpu() for d in leaves[1:] for k in sorted(d)])
    for a, b in zip(*grads):
        assert a.shape == b.shape
        assert float((a - b).norm()) <= 1e-4 * float(b.norm()), float((a - b).norm() / b.norm())


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
    rows = gru_seq.block_rows(h, rpt)
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
@pytest.mark.parametrize("n,t,c,h", GRU_CASES + MAIN_PATH_CASES + EDGE_CASES + BATCH_512_CASES)
def test_bigru_kernel_bf16_matches_plain_on_card(cuda, n, t, c, h):
    """K1 in bf16 (bf16 x, fp32 parameters; the tensor-core kernel) against
    its bf16 plain version on the card: out within one bf16 ulp; one launch."""
    rng = np.random.default_rng(n + t + 1)
    x = torch.from_numpy(rng.random((n, t, c), dtype=np.float32)).to(cuda).bfloat16()
    fw, bw = (torch_params(p, cuda) for p in gru_params(rng, c, h))
    before = gru_seq.LAUNCHES
    got = gru_seq.bigru(x, fw, bw)
    torch.cuda.synchronize()
    assert gru_seq.LAUNCHES == before + 1
    assert_within_bf16_ulp(got, rnn.bigru(x, fw, bw), atol=2e-5 if t >= 64 else 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("n,t,c,h", WIDE_CASES + PADDED_CASES)
def test_bigru_wide_and_padded_bf16_match_plain_on_card(cuda, n, t, c, h):
    """bf16 at --hd_u 64 and 128 (the tensor-core kernels) and padded sizes:
    the wrapper's output is the kernel's sliced back, the padded units 0,
    the kernel within one bf16 ulp of the bf16 plain version on the same
    projection; one launch, on the tensor-core kernel at a wide size; then
    the backward on the kernel's output, dxp within one bf16 ulp and dW_hh,
    db_hh at 1e-4 of their largest entry."""
    rng = np.random.default_rng(n + t + h + 1)
    x = torch.from_numpy(rng.random((n, t, c), dtype=np.float32)).to(cuda).bfloat16()
    fw, bw = (torch_params(p, cuda) for p in gru_params(rng, c, h, scale=float(1 / np.sqrt(h))))
    xp, w_hh, b_hh = padded_operands(x, fw, bw)
    hp = w_hh.shape[-1]
    before = (gru_seq.LAUNCHES, gru_seq.WIDE_LAUNCHES, gru_seq.WIDE_MMA_LAUNCHES)
    got = gru_seq.bigru(x, fw, bw)
    torch.cuda.synchronize()
    wide = int(hp in gru_seq.WIDE_HIDDEN)
    assert (gru_seq.LAUNCHES - before[0], gru_seq.WIDE_LAUNCHES - before[1],
            gru_seq.WIDE_MMA_LAUNCHES - before[2]) == (1, wide, wide)
    kernel = gru_seq._launch(xp, w_hh, b_hh)
    torch.cuda.synchronize()
    assert torch.equal(got, rnn.unpad_output(kernel, h))
    assert_within_bf16_ulp(kernel, rnn.bigru_recurrence(xp, w_hh, b_hh), atol=2e-5 if t >= 64 else 1e-5)
    grad_out = torch.from_numpy(rng.standard_normal((n, t, 2 * hp)).astype(np.float32)).to(cuda).bfloat16()
    before = (gru_seq.WIDE_BACKWARD_LAUNCHES, gru_seq.WIDE_MMA_BACKWARD_LAUNCHES)
    back = gru_seq.recurrence_backward(xp, w_hh, b_hh, kernel, grad_out)
    torch.cuda.synchronize()
    assert (gru_seq.WIDE_BACKWARD_LAUNCHES - before[0], gru_seq.WIDE_MMA_BACKWARD_LAUNCHES - before[1]) == (wide, wide)
    assert_backward_bf16_close(back, rnn.bigru_recurrence_backward(xp, w_hh, b_hh, kernel, grad_out),
                               atol=5e-5 if t >= 64 else 2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("tile_rows", gru_seq.TILE_ROWS)
@pytest.mark.parametrize("h", gru_seq.SUPPORTED_HIDDEN)
def test_bigru_kernel_bf16_every_instantiation_matches_plain(cuda, h, tile_rows):
    """Each bf16 (H, rows a warp's m-tile), forced, on a ragged N with T = 13
    and T = 3."""
    rng = np.random.default_rng(h * tile_rows + 1)
    scale = 0.3 if h in gru_seq.NARROW_HIDDEN else float(1 / np.sqrt(h))
    fw, bw = (torch_params(p, cuda) for p in gru_params(rng, 16, h, scale=scale))
    w_hh = torch.stack([fw["w_hh"], bw["w_hh"]])
    b_hh = torch.stack([fw["b_hh"], bw["b_hh"]])
    rows = tile_rows * gru_seq.tile_block_warps(h) // (h // 8)  # rows a block
    for n, t in ((2 * rows + 3, 13), (rows - 1, 3)):
        x = torch.from_numpy(rng.random((n, t, 16), dtype=np.float32)).to(cuda).bfloat16()
        xp = rnn.input_projection(x, fw, bw).contiguous()
        got = gru_seq._recurrence(xp, *gru_seq._kernel_weights(xp, w_hh, b_hh),
                                  config=gru_seq.TileConfig(tile_rows, 0, 0, 0))
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
@pytest.mark.parametrize("n,t,c,h", GRU_CASES + MAIN_PATH_CASES + EDGE_CASES + BATCH_512_CASES)
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
@pytest.mark.parametrize("h", gru_seq.SUPPORTED_HIDDEN)
def test_bigru_kernel_bf16_backward_every_instantiation_matches_plain(cuda, h):
    """Each bf16 H of the tensor-core backward kernel (8 rows an m-tile, its
    one instantiation a hidden size), on a ragged N with T = 13 and T = 3."""
    rng = np.random.default_rng(100 * h + 9)
    rows = 8 * gru_seq.tile_block_warps(h) // (h // 8)  # rows a block
    for n, t in ((2 * rows + 3, 13), (rows - 1, 3)):
        xp, w_hh, b_hh, out, grad_out = backward_case(rng, n, t, 16, h, cuda, torch.bfloat16)
        dxp, dhp, h_prev = gru_seq._backward_kernel(xp, *gru_seq._kernel_weights(xp, w_hh, b_hh), out, grad_out,
                                                    config=gru_seq.TileConfig(8, 0, 0, 0))
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


TILE_PTXAS_LOG = """ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__39c08763_17_bigru_seq_bf16_cu_270809c921bigru_seq_bf16_kernelILi32ELi16EEEvPK13__nv_bfloat16PKfS5_PS1_ii' for 'sm_90a'
ptxas info    : Function properties for _ZN50_GLOBAL__N__39c08763_17_bigru_seq_bf16_cu_270809c921bigru_seq_bf16_kernelILi32ELi16EEEvPK13__nv_bfloat16PKfS5_PS1_ii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 16 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__39c08763_17_bigru_seq_bf16_cu_270809c921bigru_seq_bf16_kernelILi8ELi8EEEvPK13__nv_bfloat16PKfS5_PS1_ii' for 'sm_90a'
ptxas info    : Function properties for _ZN50_GLOBAL__N__39c08763_17_bigru_seq_bf16_cu_270809c921bigru_seq_bf16_kernelILi8ELi8EEEvPK13__nv_bfloat16PKfS5_PS1_ii
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 61 registers, used 16 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__39c08763_17_bigru_seq_bf16_cu_270809c921bigru_seq_bf16_kernelILi128ELi16EEEvPK13__nv_bfloat16PKfS5_PS1_ii' for 'sm_90a'
ptxas info    : Function properties for _ZN50_GLOBAL__N__39c08763_17_bigru_seq_bf16_cu_270809c921bigru_seq_bf16_kernelILi128ELi16EEEvPK13__nv_bfloat16PKfS5_PS1_ii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 16 barriers, 400 bytes cmem[0]
"""
TILE_BWD_PTXAS_LOG = """ptxas info    : Compiling entry function '_ZN54_GLOBAL__N__1a2b3c4d_21_bigru_seq_bwd_bf16_cu_5e6f7a8b25bigru_seq_bwd_bf16_kernelILi32EEEvPK13__nv_bfloat16PKfS5_S3_S3_PS1_PfS7_iii' for 'sm_90a'
ptxas info    : Function properties for _ZN54_GLOBAL__N__1a2b3c4d_21_bigru_seq_bwd_bf16_cu_5e6f7a8b25bigru_seq_bwd_bf16_kernelILi32EEEvPK13__nv_bfloat16PKfS5_S3_S3_PS1_PfS7_iii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 80 registers, used 16 barriers, 432 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN54_GLOBAL__N__1a2b3c4d_21_bigru_seq_bwd_bf16_cu_5e6f7a8b25bigru_seq_bwd_bf16_kernelILi128EEEvPK13__nv_bfloat16PKfS5_S3_S3_PS1_PfS7_iii' for 'sm_90a'
ptxas info    : Function properties for _ZN54_GLOBAL__N__1a2b3c4d_21_bigru_seq_bwd_bf16_cu_5e6f7a8b25bigru_seq_bwd_bf16_kernelILi128EEEvPK13__nv_bfloat16PKfS5_S3_S3_PS1_PfS7_iii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 16 barriers, 432 bytes cmem[0]
"""


def test_ptxas_report_reads_the_tensor_core_kernels():
    """The bf16 kernels' instantiations by hidden size and rows an m-tile
    (the backward's 8), with their rings and fragment buffers as shared
    memory (blocks of four warps up to H = 32, one m-tile of H / 8 warps
    above; the backward's rings of four slots, an m-tile's h_{t-1} ring,
    and at H = 128 W_hh^T in bf16 at a row stride of 3H + 8); the fp32
    reports skip them."""
    assert ptxas_report(TILE_PTXAS_LOG) == [
        {"dtype": "bf16", "H": 32, "rows": 16, "registers": 96, "spill_bytes": 0, "stack_bytes": 0,
         "smem_bytes": 4 * 2 * 3 * 2 * 4 * 32 + 2 * 4 * 3 * 16 * 24},
        {"dtype": "bf16", "H": 8, "rows": 8, "registers": 61, "spill_bytes": 8, "stack_bytes": 8,
         "smem_bytes": 4 * 4 * 2 * 3 * 1 * 32 + 2 * 4 * 3 * 8 * 24},
        {"dtype": "bf16", "H": 128, "rows": 16, "registers": 128, "spill_bytes": 0, "stack_bytes": 0,
         "smem_bytes": 4 * 2 * 3 * 2 * 16 * 32 + 2 * 16 * 3 * 16 * 24}]
    assert ptxas_report(TILE_BWD_PTXAS_LOG, backward=True) == [
        {"dtype": "bf16", "H": 32, "rows": 8, "registers": 80, "spill_bytes": 0, "stack_bytes": 0,
         "smem_bytes": 4 * 2 * 3 * 12 * 32 + 2 * 4 * 8 * (4 * (24 + 8) + 40)},
        {"dtype": "bf16", "H": 128, "rows": 8, "registers": 128, "spill_bytes": 0, "stack_bytes": 0,
         "smem_bytes": 4 * 2 * 3 * 48 * 32 + 2 * (4 * 8 * (16 * (24 + 8) + 136) + 128 * 392)}]
    assert ptxas_report(TILE_PTXAS_LOG, backward=True) == ptxas_report(TILE_BWD_PTXAS_LOG) == []


WIDE_PTXAS_LOG = """ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_125bigru_wide_forward_kernelILi128ELi4EEEvPKfS2_S2_Pfii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_125bigru_wide_forward_kernelILi128ELi4EEEvPKfS2_S2_Pfii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 108 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_126bigru_wide_backward_kernelILi64ELi1EEEvPKfS2_S2_S2_S2_PfS3_S3_iii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_126bigru_wide_backward_kernelILi64ELi1EEEvPKfS2_S2_S2_S2_PfS3_S3_iii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 432 bytes cmem[0]
"""


def test_ptxas_report_reads_the_wide_kernels():
    """csrc/bigru_seq_wide.cu's instantiations (fp32) by hidden size and
    rows a thread, with the weights at a row stride of 3H + 1 floats and
    the forward's two h buffers or the backward's h_{t-1} and dhp_t as
    shared memory (16 rows a block at four rows a thread, 4 at one); the
    narrow reports skip them."""
    assert ptxas_report(WIDE_PTXAS_LOG) == [
        {"dtype": "fp32", "H": 128, "rpt": 4, "wide": True, "registers": 108, "spill_bytes": 0, "stack_bytes": 0,
         "smem_bytes": 4 * (128 * 385 + 2 * 16 * 128)}]
    assert ptxas_report(WIDE_PTXAS_LOG, backward=True) == [
        {"dtype": "fp32", "H": 64, "rpt": 1, "wide": True, "registers": 80, "spill_bytes": 0, "stack_bytes": 0,
         "smem_bytes": 4 * (64 * 193 + 4 * 4 * 64)}]
    assert all(not r.get("wide") for log in (PTXAS_LOG, BWD_PTXAS_LOG, TILE_PTXAS_LOG)
               for b in (False, True) for r in ptxas_report(log, backward=b))


def _check_ablation_variants(backward, bf16=False):
    file, table = ablate_k1._kernel(backward, bf16)
    source = (_build.CSRC / file).read_text()
    variants = ablate_k1.variant_sources(backward, bf16)
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


def test_bf16_ablation_variants_match_the_kernel_source():
    """The same for the tensor-core forward's variants in
    csrc/bigru_seq_bf16.cu; at most four besides the full kernel."""
    assert len(ablate_k1.BF16_VARIANTS) <= 5
    _check_ablation_variants(backward=False, bf16=True)
