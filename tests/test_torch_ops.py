"""The port's ops held to the JAX package's: the BiGRU (K1's plain version),
resizes, image metrics, CTC decode, priors and charset.

Inputs come from numpy seeds and go through both packages.  Tolerances are
fp32 noise unless stated."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpgsr_tpu import charset as jax_charset
from tpgsr_tpu.ops import ctc as jax_ctc
from tpgsr_tpu.ops import image as jax_image
from tpgsr_tpu.ops import resize as jax_resize
from tpgsr_tpu.ops.pallas_gru import _bigru_pallas_impl
from tpgsr_tpu.ops.rnn import bigru_fused
from tpgsr_tpu.train import priors as jax_priors
from tpgsr_tpu_torch import charset
from tpgsr_tpu_torch.ops import ctc, image, resize, rnn
from tpgsr_tpu_torch.train import priors
from tests.test_torch_kernels import GRU_CASES, gru_params, torch_params
from tests.torch_suite import port_test_module  # noqa: F401  (the run's compile cache, no TensorBoard)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("n,t,c,h", GRU_CASES)
def test_bigru_plain_matches_jax(n, t, c, h):
    """Plain ``bigru`` against JAX ``bigru_fused`` and the Pallas kernel in
    interpret mode, at the 1e-5 of tests/test_rnn.py:120."""
    rng = np.random.default_rng(n * 100 + t)
    x = rng.random((n, t, c), dtype=np.float32)
    fw, bw = gru_params(rng, c, h)
    got = rnn.bigru(torch.from_numpy(x), torch_params(fw), torch_params(bw)).numpy()
    assert got.shape == (n, t, 2 * h)
    np.testing.assert_allclose(got, np.asarray(bigru_fused(x, fw, bw)), atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(_bigru_pallas_impl(x, fw, bw, interpret=True)), atol=1e-5)


@pytest.mark.parametrize(
    "mode,src,dst,align",
    [
        ("bicubic", (16, 64), (32, 100), False),  # parse_crnn_data on the LR
        ("bicubic", (32, 128), (32, 100), False),  # ... on SR/HR (downscale, no antialias)
        ("bilinear", (1, 203), (16, 64), True),  # the InfoGen map to the LR size
        ("bilinear", (5, 9), (12, 7), False),
    ],
)
def test_resize_matches_jax(mode, src, dst, align):
    x = np.random.default_rng(4).random((2, *src, 3), dtype=np.float32)
    fn_jax = getattr(jax_resize, f"interpolate_{mode}")
    fn = getattr(resize, f"interpolate_{mode}")
    ref = np.asarray(fn_jax(x, dst, align_corners=align))
    got = fn(torch.from_numpy(x).permute(0, 3, 1, 2), dst, align_corners=align).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_image_metrics_match_jax():
    rng = np.random.default_rng(5)
    a = rng.random((3, 32, 64, 4), dtype=np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape).astype(np.float32), 0, 1)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(image.ssim(ta, tb, size_average=False).numpy(),
                               np.asarray(jax_image.ssim(a, b, size_average=False)), atol=1e-5)
    np.testing.assert_allclose(float(image.ssim(ta, tb)), float(jax_image.ssim(a, b)), atol=1e-5)
    np.testing.assert_allclose(float(image.calculate_psnr(ta, tb)),
                               float(jax_image.calculate_psnr(a, b)), rtol=1e-5)
    np.testing.assert_allclose(image.rgb_to_gray(ta).numpy(), np.asarray(jax_image.rgb_to_gray(a)), atol=1e-6)


def test_ctc_decode_matches_jax():
    quirk = np.array([[1, 1, 0, 1, 1, 2, 0, 0, 3, 3]]).T  # 'aa-aa' style repeats
    assert ctc.ctc_ids_to_strings(quirk) == jax_ctc.ctc_ids_to_strings(quirk) == ["0012"]
    logits = np.random.default_rng(6).standard_normal((26, 5, 37)).astype(np.float32)
    ids = ctc.ctc_greedy_ids(torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(ids, np.asarray(jax_ctc.ctc_greedy_ids(logits)))
    assert ctc.decode_crnn(torch.from_numpy(logits)) == jax_ctc.ctc_ids_to_strings(ids)


def test_priors_match_jax():
    rng = np.random.default_rng(7)
    img = rng.random((4, 16, 64, 4), dtype=np.float32)
    for width in (100, 64):
        np.testing.assert_allclose(priors.parse_crnn_data(torch.from_numpy(img), width).numpy(),
                                   np.asarray(jax_priors.parse_crnn_data(img, width)), atol=1e-5)
    logits = rng.standard_normal((26, 4, 37)).astype(np.float32)
    prior = priors.logits_to_prior(torch.from_numpy(logits))
    np.testing.assert_allclose(prior.numpy(), np.asarray(jax_priors.logits_to_prior(logits)), atol=1e-6)
    np.testing.assert_allclose(priors.prior_dropout_first_quarter(prior).numpy(),
                               np.asarray(jax_priors.prior_dropout_first_quarter(jnp.asarray(prior.numpy()))),
                               atol=0)


def test_charset_matches_jax():
    assert charset.CTC_CHARS == jax_charset.CTC_CHARS
    assert charset.CTC_NUM_CLASSES == jax_charset.CTC_NUM_CLASSES == 37
    for s in ("Hello, World!", "ÄbC-12", ""):
        for voc in ("digit", "lower", "upper", "all"):
            assert charset.str_filt(s, voc) == jax_charset.str_filt(s, voc)
