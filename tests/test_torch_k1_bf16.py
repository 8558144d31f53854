"""K1's bf16 kernels on the tensor cores (csrc/bigru_seq_bf16.cu,
csrc/bigru_seq_bwd_bf16.cu), held on the CPU: the three-term bf16 split
they put fp32 operands through, their arithmetic emulated against the plain
recurrences and the JAX package's TPU kernel, and their geometry
(``gru_seq.tile_config``); and the arithmetic of the wide kernel
(csrc/bigru_seq_wide.cu), which runs bf16 storage at H = 64 and 128 on the
fp32 cores.  The kernels themselves run in the ``cuda`` tests of
tests/test_torch_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpgsr_tpu.ops.pallas_gru import _bigru_pallas_impl
from tpgsr_tpu_torch.ops import gru_seq, rnn
from tests.test_torch_kernels import gru_params, torch_params
from tests.torch_suite import port_test_module  # noqa: F401  (the run's compile cache, no TensorBoard)

H100_SMS = 132


def _recombined(x: torch.Tensor) -> torch.Tensor:
    t1, t2, t3 = rnn.bf16_split3(x)
    assert t1.dtype == t2.dtype == t3.dtype == torch.bfloat16
    return t1.float() + t2.float() + t3.float()


def _f32(bits) -> torch.Tensor:
    return torch.tensor(np.array(bits, dtype=np.uint32).view(np.float32))


@pytest.mark.parametrize("kind", ["uniform", "zeros", "near_one", "tiny_normals"])
def test_bf16_split3_reconstructs_fp32_exactly(kind):
    """x = t1 + t2 + t3 bit for bit: random values in (-1, 1), +-0, the
    floats next to +-1 and below them, and normals down to 2^-110."""
    rng = np.random.default_rng(3)
    if kind == "uniform":
        x = torch.from_numpy(rng.uniform(-1, 1, 200_000).astype(np.float32))
    elif kind == "zeros":
        x = torch.tensor([0.0, -0.0])
    elif kind == "near_one":
        one = np.float32(1).view(np.uint32)
        x = torch.cat([_f32(one - np.arange(1, 4097, dtype=np.uint32)), -_f32(one - np.arange(1, 4097, dtype=np.uint32)),
                       torch.tensor([1.0, -1.0])])
    else:
        x = torch.from_numpy((rng.uniform(1, 2, 10_000) * 2.0 ** rng.integers(-110, 0, 10_000)).astype(np.float32))
        x = x * torch.from_numpy(rng.choice([-1.0, 1.0], 10_000).astype(np.float32))
    assert torch.equal(_recombined(x), x)


def test_bf16_split3_loses_at_most_half_the_least_bf16_subnormal_below_2_pow_110():
    """fp32 subnormals (and normals under 2^-110) keep bits below bf16's least
    subnormal, 2^-133: the split loses them, within 2^-134."""
    x = torch.cat([_f32(np.arange(1, 1 << 23, 997, dtype=np.uint32)),  # subnormals
                   _f32(np.float32(2.0 ** -126).view(np.uint32) + np.arange(0, 1 << 23, 991, dtype=np.uint32))])
    x = torch.cat([x, -x])
    err = (_recombined(x).double() - x.double()).abs()
    assert float(err.max()) <= 2.0 ** -134
    assert float(err.max()) > 0  # the domain's edge is real


def _emulated_recurrence(xp: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor) -> torch.Tensor:
    """The bf16 forward kernel's arithmetic in fp32: W_hh of bf16 values, h
    split into three bf16 terms, each term's products summed in fp32 by an
    accumulator of its own (the largest starting at b_hh), the three added
    smallest first."""
    n, t, _ = xp.shape
    h = w_hh.shape[-1]
    state = xp.new_zeros(2, n, h)
    out = xp.new_empty(n, t, 2 * h)
    for step in range(t):
        x_step = torch.stack([xp[:, step, : 3 * h], xp[:, t - 1 - step, 3 * h:]])
        p1, p2, p3 = (torch.bmm(term.float(), w_hh.transpose(1, 2)) for term in rnn.bf16_split3(state))
        hp = (b_hh[:, None, :] + p1) + (p2 + p3)
        xr, xz, xn = x_step.split(h, -1)
        hr, hz, hn = hp.split(h, -1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n_gate = torch.tanh(xn + r * hn)
        state = (1.0 - z) * n_gate + z * state
        out[:, step, :h] = state[0]
        out[:, t - 1 - step, h:] = state[1]
    return out


def _emulated_backward(xp, w_hh, b_hh, out, grad_out):
    """The bf16 backward kernel's arithmetic in fp32: the recompute from out's
    h_{t-1} (one term), dhp_t split into three bf16 terms, each term's
    products W_hh^T dhp_t summed by its own accumulator (the largest with
    dh z), the three added smallest first.  Returns dxp."""
    n, t, _ = xp.shape
    h = w_hh.shape[-1]
    dh_next = xp.new_zeros(2, n, h)
    dxp = torch.empty_like(xp)
    for step in reversed(range(t)):
        te = (step, t - 1 - step)
        x_step = torch.stack([xp[:, te[0], : 3 * h], xp[:, te[1], 3 * h:]])
        g_step = torch.stack([grad_out[:, te[0], :h], grad_out[:, te[1], h:]])
        h_prev = torch.stack([out[:, te[0] - 1, :h] if step else xp.new_zeros(n, h),
                              out[:, te[1] + 1, h:] if step else xp.new_zeros(n, h)])
        hp = torch.baddbmm(b_hh[:, None, :], h_prev, w_hh.transpose(1, 2))
        xr, xz, xn = x_step.split(h, -1)
        hr, hz, hn = hp.split(h, -1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n_gate = torch.tanh(xn + r * hn)
        dh = g_step + dh_next
        dn_hat = dh * (1.0 - z) * (1.0 - n_gate * n_gate)
        dr_hat = dn_hat * hn * r * (1.0 - r)
        dz_hat = dh * (h_prev - n_gate) * z * (1.0 - z)
        dhp = torch.cat([dr_hat, dz_hat, dn_hat * r], -1)
        terms = [torch.bmm(term.float(), w_hh) for term in rnn.bf16_split3(dhp)]
        dh_next = (dh * z + terms[0]) + (terms[1] + terms[2])
        d = torch.cat([dr_hat, dz_hat, dn_hat], -1)
        dxp[:, te[0], : 3 * h] = d[0]
        dxp[:, te[1], 3 * h:] = d[1]
    return dxp


def _bf16_valued(p):
    """fp32 parameters holding bf16 values, as the kernels receive W_hh and b_hh."""
    return {k: torch.from_numpy(v).to(torch.bfloat16).float().numpy() for k, v in p.items()}


@pytest.mark.parametrize("h", gru_seq.NARROW_HIDDEN)
def test_emulated_tensor_core_forward_matches_plain_and_the_pallas_kernel(h):
    """The forward's arithmetic (bf16-term products summed in fp32) within
    the fp32 tests' 1e-5 (tests/test_rnn.py:120) of the plain recurrence and
    of the TPU kernel in interpret mode, at H = 8, 16 and 32."""
    n, t, c = 11, 9, 2 * h
    rng = np.random.default_rng(h)
    x = rng.random((n, t, c), dtype=np.float32)
    fw, bw = (_bf16_valued(p) for p in gru_params(rng, c, h))
    tfw, tbw = torch_params(fw), torch_params(bw)
    xp = rnn.input_projection(torch.from_numpy(x), tfw, tbw)
    w_hh = torch.stack([tfw["w_hh"], tbw["w_hh"]])
    b_hh = torch.stack([tfw["b_hh"], tbw["b_hh"]])
    got = _emulated_recurrence(xp, w_hh, b_hh)
    torch.testing.assert_close(got, rnn.bigru_recurrence(xp, w_hh, b_hh), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(_bigru_pallas_impl(jnp.asarray(x), fw, bw, interpret=True)),
                               atol=1e-5)


@pytest.mark.parametrize("h", gru_seq.NARROW_HIDDEN)
def test_emulated_tensor_core_backward_matches_plain(h):
    """The backward's arithmetic (dhp_t's three bf16 terms, one accumulator
    each) within the fp32 backward tests' 2e-5 of the plain BPTT's dxp."""
    n, t = 11, 9
    rng = np.random.default_rng(10 + h)
    xp = torch.from_numpy(rng.standard_normal((n, t, 6 * h)).astype(np.float32))
    w_hh = torch.from_numpy(rng.uniform(-1, 1, (2, 3 * h, h)).astype(np.float32) / np.sqrt(h)).bfloat16().float()
    b_hh = torch.from_numpy(rng.uniform(-1, 1, (2, 3 * h)).astype(np.float32)).bfloat16().float()
    out = rnn.bigru_recurrence(xp, w_hh, b_hh)
    grad_out = torch.from_numpy(rng.standard_normal((n, t, 2 * h)).astype(np.float32))
    want = rnn.bigru_recurrence_backward(xp, w_hh, b_hh, out, grad_out)[0]
    torch.testing.assert_close(_emulated_backward(xp, w_hh, b_hh, out, grad_out), want, rtol=0, atol=2e-5)


def _wide_sums(h_rows: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The wide kernel's sums: for each output column, the terms
    ``h_rows[..., k] * w[:, k, :]`` added one k after another from 0, in
    fp32 (the kernel's FMAs round once a term, these twice: within the
    tolerances).  ``h_rows`` [2, N, K], ``w`` [2, K, M] -> [2, N, M]."""
    acc = h_rows.new_zeros(*h_rows.shape[:2], w.shape[-1])
    for k in range(w.shape[1]):
        acc = acc + h_rows[..., k:k + 1] * w[:, k:k + 1, :]
    return acc


def _emulated_wide_recurrence(xp: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor) -> torch.Tensor:
    """The wide forward's arithmetic in fp32: each gate's sum over k in
    order from 0, the bias added after it."""
    n, t, _ = xp.shape
    h = w_hh.shape[-1]
    state = xp.new_zeros(2, n, h)
    out = xp.new_empty(n, t, 2 * h)
    for step in range(t):
        x_step = torch.stack([xp[:, step, : 3 * h], xp[:, t - 1 - step, 3 * h:]])
        hp = _wide_sums(state, w_hh.transpose(1, 2)) + b_hh[:, None, :]
        xr, xz, xn = x_step.split(h, -1)
        hr, hz, hn = hp.split(h, -1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n_gate = torch.tanh(xn + r * hn)
        state = (1.0 - z) * n_gate + z * state
        out[:, step, :h] = state[0]
        out[:, t - 1 - step, h:] = state[1]
    return out


def _emulated_wide_backward(xp, w_hh, b_hh, out, grad_out):
    """The wide backward's arithmetic in fp32: the recompute's sums as the
    forward's, W_hh^T dhp_t summed over its 3H terms in order from 0 with dh
    z added after.  Returns dxp."""
    n, t, _ = xp.shape
    h = w_hh.shape[-1]
    dh_next = xp.new_zeros(2, n, h)
    dxp = torch.empty_like(xp)
    for step in reversed(range(t)):
        te = (step, t - 1 - step)
        x_step = torch.stack([xp[:, te[0], : 3 * h], xp[:, te[1], 3 * h:]])
        g_step = torch.stack([grad_out[:, te[0], :h], grad_out[:, te[1], h:]])
        h_prev = torch.stack([out[:, te[0] - 1, :h] if step else xp.new_zeros(n, h),
                              out[:, te[1] + 1, h:] if step else xp.new_zeros(n, h)])
        hp = _wide_sums(h_prev, w_hh.transpose(1, 2)) + b_hh[:, None, :]
        xr, xz, xn = x_step.split(h, -1)
        hr, hz, hn = hp.split(h, -1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n_gate = torch.tanh(xn + r * hn)
        dh = g_step + dh_next
        dn_hat = dh * (1.0 - z) * (1.0 - n_gate * n_gate)
        dr_hat = dn_hat * hn * r * (1.0 - r)
        dz_hat = dh * (h_prev - n_gate) * z * (1.0 - z)
        dhp = torch.cat([dr_hat, dz_hat, dn_hat * r], -1)
        dh_next = _wide_sums(dhp, w_hh) + dh * z
        d = torch.cat([dr_hat, dz_hat, dn_hat], -1)
        dxp[:, te[0], : 3 * h] = d[0]
        dxp[:, te[1], 3 * h:] = d[1]
    return dxp


@pytest.mark.parametrize("h", gru_seq.WIDE_HIDDEN)
def test_emulated_wide_forward_matches_plain_and_the_pallas_kernel(h):
    """The wide forward's arithmetic on bf16 values (fp32 sums in k order,
    the bias after) within the fp32 tests' 1e-5 of the plain recurrence and
    of the TPU kernel in interpret mode, at H = 64 and 128."""
    n, t, c = 5, 6, 16
    rng = np.random.default_rng(20 + h)
    x = torch.from_numpy(rng.random((n, t, c), dtype=np.float32)).bfloat16().float().numpy()
    fw, bw = (_bf16_valued(p) for p in gru_params(rng, c, h, scale=float(1 / np.sqrt(h))))
    tfw, tbw = torch_params(fw), torch_params(bw)
    xp = rnn.input_projection(torch.from_numpy(x), tfw, tbw)
    w_hh = torch.stack([tfw["w_hh"], tbw["w_hh"]])
    b_hh = torch.stack([tfw["b_hh"], tbw["b_hh"]])
    got = _emulated_wide_recurrence(xp, w_hh, b_hh)
    torch.testing.assert_close(got, rnn.bigru_recurrence(xp, w_hh, b_hh), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(_bigru_pallas_impl(jnp.asarray(x), fw, bw, interpret=True)),
                               atol=1e-5)


@pytest.mark.parametrize("h", gru_seq.WIDE_HIDDEN)
def test_emulated_wide_backward_matches_plain(h):
    """The wide backward's arithmetic on bf16 values within the fp32 backward
    tests' 2e-5 of the plain BPTT's dxp."""
    n, t = 5, 6
    rng = np.random.default_rng(30 + h)
    xp = torch.from_numpy(rng.standard_normal((n, t, 6 * h)).astype(np.float32)).bfloat16().float()
    w_hh = torch.from_numpy(rng.uniform(-1, 1, (2, 3 * h, h)).astype(np.float32) / np.sqrt(h)).bfloat16().float()
    b_hh = torch.from_numpy(rng.uniform(-1, 1, (2, 3 * h)).astype(np.float32)).bfloat16().float()
    out = rnn.bigru_recurrence(xp, w_hh, b_hh).bfloat16().float()
    grad_out = torch.from_numpy(rng.standard_normal((n, t, 2 * h)).astype(np.float32)).bfloat16().float()
    want = rnn.bigru_recurrence_backward(xp, w_hh, b_hh, out, grad_out)[0]
    torch.testing.assert_close(_emulated_wide_backward(xp, w_hh, b_hh, out, grad_out), want, rtol=0, atol=2e-5)


TILE_OCCUPANCY = {8: 2, 16: 2}


@pytest.mark.parametrize("n,rows,blocks,waves", [(768, 8, 192, 1), (3072, 16, 384, 2),
                                                 (8192, 16, 1024, 4), (32768, 16, 4096, 16)])
def test_tile_config_flagship_and_batch_512_sweeps(n, rows, blocks, waves):
    """H = 32, an m-tile a block of four warps.  At batch 48 over W (N =
    768) 8-row m-tiles: 768 warps, within two a sub-partition of 132 SMs;
    over H (N = 3,072) and at batch 512 (N = 8,192 over W, 32,768 over H)
    16 rows."""
    cfg = gru_seq.tile_config(n, 32, H100_SMS, TILE_OCCUPANCY)
    assert cfg == gru_seq.TileConfig(rows, blocks, 2, waves)


@pytest.mark.parametrize("h", gru_seq.NARROW_HIDDEN)
@pytest.mark.parametrize("n", [1, 5, 37, 771, 1500, 3070, 3072, 8192, 32768, 100_001])
def test_tile_config_covers_every_row_with_no_idle_block(n, h):
    cfg = gru_seq.tile_config(n, h, H100_SMS, TILE_OCCUPANCY)
    rows_a_block = cfg.rows * gru_seq.TILE_WARPS // (h // 8)  # H/8 warps an m-tile
    assert cfg.rows in gru_seq.TILE_ROWS and cfg.blocks % 2 == 0
    assert (cfg.blocks // 2) * rows_a_block >= n > (cfg.blocks // 2 - 1) * rows_a_block
    assert cfg.waves == -(-cfg.blocks // (H100_SMS * 2))
    assert (cfg.rows == 8) == (2 * -(-n // 8) * h // 8 <= 2 * gru_seq.SUB_PARTITIONS * H100_SMS)


@pytest.mark.parametrize("n", [768, 3072, 8192, 32768])
def test_tile_config_backward_takes_8_row_tiles(n):
    """The backward's steps carry the most per pair: 8 rows an m-tile, its
    one instantiation, at every size."""
    cfg = gru_seq.tile_config(n, 32, H100_SMS, TILE_OCCUPANCY, backward=True)
    assert cfg == gru_seq.TileConfig(8, 2 * -(-n // 8), 2, -(-2 * -(-n // 8) // (2 * H100_SMS)))


def test_tile_config_rejects_what_fits_no_block():
    """A zero occupancy of the instantiation the geometry picks raises."""
    with pytest.raises(ValueError):
        gru_seq.tile_config(3072, 32, H100_SMS, {8: 2, 16: 0})
    with pytest.raises(ValueError):
        gru_seq.tile_config(3072, 32, H100_SMS, {8: 0}, backward=True)
    with pytest.raises(ValueError):
        gru_seq.tile_config(768, 12, H100_SMS, TILE_OCCUPANCY)
