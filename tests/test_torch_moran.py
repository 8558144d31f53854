"""The port's MORAN (``tpgsr_tpu_torch.models.moran``) held to the JAX
package's on the CPU, module by module, on the same weights (JAX ``init``
from a seed, rescaled as tests/torch_recognizers.py says, then
``interop.from_jax.moran_state_dict``) and the same grayscale images in
[0, 1] drawn from a seed: batch 4 at MORAN's fixed 32x100 and widths.

Tolerances, against the JAX package in fp32 on the CPU (measured there):

* MORN's rectified image at ``RECTIFY_ATOL`` (measured 3.4e-6): the
  offsets come from a 5-conv CNN and are sampled twice, so a coordinate
  error of e moves a pixel's value by up to e x 16 px x the image's range;
* the L2R and R2L logits of the same rectified image at ``LOGIT_ATOL``
  (measured 5.8e-6), and of the whole model on the raw image at
  ``END_TO_END_ATOL`` (measured 7.4e-6);
* the greedy ids (each step's argmax, fed back as the next target) exactly,
  where every step's top two logits are ``MARGIN`` apart, more than 10
  times their error: the tests assert that they are and print the margins.
"""

import jax
import numpy as np
import pytest
import torch

from tests.torch_recognizers import greedy_margins, jax_moran, nchw, numpy_tree, port_moran
from tests.torch_suite import port_test_module  # noqa: F401  (the run's compile cache, no TensorBoard)
from tpgsr_tpu.interop.torch_import import import_moran
from tpgsr_tpu.models.moran import ASRN as JaxASRN
from tpgsr_tpu.models.moran import MORN as JaxMORN
from tpgsr_tpu.models.moran import decode_moran_ids as jax_decode_moran_ids
from tpgsr_tpu_torch.interop import from_jax
from tpgsr_tpu_torch.models.moran import MORAN_CHARS, MORAN_NCLASS, decode_moran_ids

B = 4
RECTIFY_ATOL = 2e-5
LOGIT_ATOL = 2e-5
END_TO_END_ATOL = 5e-5
MARGIN = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _sub(variables, name):
    return {"params": variables["params"][name], "batch_stats": variables["batch_stats"][name]}


@pytest.fixture(scope="module")
def moran():
    model, variables = jax_moran()
    x = np.random.default_rng(0).random((B, 32, 100, 1), dtype=np.float32)
    morn, asrn = JaxMORN(), JaxASRN()
    jax_fns = {
        "morn": jax.jit(lambda v, x: morn.apply(v, x, train=False)),
        "asrn": jax.jit(lambda v, x: asrn.apply(v, x, train=False)),
        "moran": jax.jit(lambda v, x: model.apply(v, x, train=False)),
    }
    rect = np.array(jax_fns["morn"](_sub(variables, "MORN"), x))
    return {"jax": jax_fns, "vars": variables, "port": port_moran(variables), "x": x, "rect": rect}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().numpy()


def test_state_dict_round_trips_through_import_moran(moran):
    """``from_jax.moran_state_dict`` then ``import_moran`` gives the JAX
    variables back bit for bit, and the port loads the same dict strictly."""
    sd = from_jax.moran_state_dict(moran["vars"])
    assert sorted(sd) == sorted(moran["port"].state_dict())
    back = jax.tree_util.tree_flatten_with_path(numpy_tree(import_moran({k: v.numpy() for k, v in sd.items()})))[0]
    want = dict(jax.tree_util.tree_flatten_with_path(moran["vars"])[0])
    assert len(back) == len(want)
    for path, leaf in back:
        assert np.array_equal(leaf, want[path]), jax.tree_util.keystr(path)


def test_morn_rectifies_as_jax(moran):
    with torch.no_grad():
        got = _np(moran["port"].MORN(nchw(moran["x"]))).transpose(0, 2, 3, 1)
    err = np.abs(got - moran["rect"]).max()
    print("MORN max_abs_err", err, "moved", np.abs(moran["rect"] - moran["x"]).max())
    assert np.abs(moran["rect"] - moran["x"]).max() > 0.1  # the offsets move the image
    np.testing.assert_allclose(got, moran["rect"], atol=RECTIFY_ATOL)


def _check_logits(got_pair, want_pair, atol, what):
    for got, want, side in zip(got_pair, want_pair, ("L2R", "R2L")):
        got, want = _np(got), np.asarray(want)
        assert got.shape == want.shape == (B, 20, MORAN_NCLASS)
        margins = greedy_margins(want)
        print(f"{what} {side} max_abs_err", np.abs(got - want).max(), "margins", margins)
        np.testing.assert_allclose(got, want, atol=atol)
        assert (margins > MARGIN).all(), margins
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_asrn_logits(moran):
    """ASRN on the same rectified image: both decoders' logits, then their
    greedy ids."""
    want = moran["jax"]["asrn"](_sub(moran["vars"], "ASRN"), moran["rect"])
    with torch.no_grad():
        got = moran["port"].ASRN(nchw(moran["rect"]))
    _check_logits(got, want, LOGIT_ATOL, "ASRN")


def test_moran_end_to_end(moran):
    want = moran["jax"]["moran"](moran["vars"], moran["x"])
    with torch.no_grad():
        got = moran["port"](nchw(moran["x"]))
    _check_logits(got, want, END_TO_END_ATOL, "MORAN")
    assert len(set(decode_moran_ids(got[0]))) > 1  # the images read differently


def test_decode_moran_ids_matches_jax():
    """Fixed logits whose argmax rows hold '$' mid-row, at the start and
    nowhere: the port's strings are JAX's, cut at the first '$'."""
    rows = ["ab$cd", "$xyz0", "hello", "9$$$$"]
    logits = np.zeros((len(rows), 5, MORAN_NCLASS), np.float32)
    for i, word in enumerate(rows):
        for t, ch in enumerate(word):
            logits[i, t, MORAN_CHARS.index(ch)] = 1.0
    want = jax_decode_moran_ids(logits)
    assert want == ["ab", "", "hello", "9"]
    assert decode_moran_ids(logits) == want
    assert decode_moran_ids(torch.from_numpy(logits)) == want
