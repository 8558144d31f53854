"""The port's ASTER (``tpgsr_tpu_torch.models.aster``) held to the JAX
package's on the CPU, module by module, on the same weights (JAX ``init``
from a seed, rescaled as tests/torch_recognizers.py says, then
``interop.from_jax.aster_state_dict``) and the same images in [-1, 1] drawn
from a seed: batch 4, ``max_len_labels`` 12, the full widths (ASTER has no
width to cut).

Tolerances, against the JAX package in fp32 on the CPU (measured there):

* control points at 1e-5, the STN head's bound in tests/test_torch_train.py;
* the rectified image at ``RECTIFY_ATOL`` (measured 2.2e-4): the TPS's
  source coordinates agree to 2e-5 (tests/test_torch_train.py), which the
  sampler turns into up to 2e-5 x 64 px x 2 (the input's range) on a
  128-wide random image;
* encoder features of the same rectified image at ``FEATURE_ATOL``
  (measured 2.3e-5 of values up to 0.47): 45 convolutions and two BiLSTM
  layers of reordered fp32 sums;
* decoder logits of the same features at ``LOGIT_ATOL`` (measured 7.2e-6),
  and the best beam's score at ``SCORE_ATOL`` (measured 6.7e-6);
* greedy and beam ids exactly, where every decision is ``MARGIN`` clear of
  the next candidate, more than 10 times the error of what decides it: the
  tests assert that it is and print the margins.  A near-tie that flipped
  on one side would change every later step.
"""

import jax
import numpy as np
import pytest
import torch

from tests.torch_recognizers import greedy_margins, jax_aster, nchw, numpy_tree, port_aster
from tests.torch_suite import port_test_module  # noqa: F401  (the run's compile cache, no TensorBoard)
from tpgsr_tpu.interop.torch_import import import_aster
from tpgsr_tpu.models.aster import decode_aster_ids as jax_decode_aster_ids
from tpgsr_tpu.ops.resize import interpolate_bilinear as jax_interpolate_bilinear
from tpgsr_tpu_torch.charset import AsterInfo
from tpgsr_tpu_torch.interop import from_jax
from tpgsr_tpu_torch.models.aster import decode_aster_ids
from tpgsr_tpu_torch.ops.resize import interpolate_bilinear

B, MAX_LEN = 4, 12
RECTIFY_ATOL = 1e-3
FEATURE_ATOL = 1e-4
LOGIT_ATOL = 2e-5
SCORE_ATOL = 1e-4
MARGIN = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def aster():
    model, variables, info = jax_aster(MAX_LEN)
    x = np.random.default_rng(0).uniform(-1.0, 1.0, (B, 32, 128, 3)).astype(np.float32)

    def jit(fn):
        return jax.jit(lambda v, *a: model.apply(v, *a, method=fn))

    jax_fns = {
        "ctrl": jit(lambda m, x: m.stn_head(jax_interpolate_bilinear(x, (32, 64), align_corners=True),
                                            train=False)[1]),
        "rectify": jit(lambda m, x: m.rectify(x)),
        "encoder": jit(lambda m, x: m.encoder(x)),
        "logits": jit(lambda m, f, t: m.decoder(f, t)),
        "sample": jit(lambda m, f: m.decoder.sample(f)),
        "beam": jit(lambda m, f: m.decoder.beam_search(f, 5, info.char2id[info.EOS])[0]),
        "forward": jax.jit(lambda v, x: model.apply(v, x)["output"]["pred_rec"]),
    }
    return {"jax": jax_fns, "vars": variables, "port": port_aster(variables, info, MAX_LEN), "info": info, "x": x}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().numpy()


def test_state_dict_round_trips_through_import_aster(aster):
    """``from_jax.aster_state_dict`` then ``import_aster`` gives the JAX
    variables back bit for bit, and the port loads the same dict strictly."""
    sd = from_jax.aster_state_dict(aster["vars"])
    assert sorted(sd) == sorted(aster["port"].state_dict())
    back = numpy_tree(import_aster({k: v.numpy() for k, v in sd.items()}))
    want = aster["vars"]
    flat_back = jax.tree_util.tree_flatten_with_path(back)[0]
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert len(flat_back) == len(flat_want)
    for path, leaf in flat_back:
        assert np.array_equal(leaf, flat_want[path]), jax.tree_util.keystr(path)


def test_stn_control_points_and_rectified_image(aster):
    x, port = aster["x"], aster["port"]
    with torch.no_grad():
        _, ctrl = port.stn_head(interpolate_bilinear(nchw(x), (32, 64), align_corners=True))
        rect = port.rectify(nchw(x))
    want_ctrl = np.asarray(aster["jax"]["ctrl"](aster["vars"], x))
    assert np.ptp(want_ctrl, axis=0).max() > 1e-3  # the points depend on the image
    np.testing.assert_allclose(_np(ctrl), want_ctrl, atol=1e-5)
    want = np.asarray(aster["jax"]["rectify"](aster["vars"], x))
    print("rectified max_abs_err", np.abs(_np(rect).transpose(0, 2, 3, 1) - want).max())
    np.testing.assert_allclose(_np(rect).transpose(0, 2, 3, 1), want, atol=RECTIFY_ATOL)


@pytest.fixture(scope="module")
def features(aster):
    """The JAX encoder's features of the JAX-rectified image, and the port's
    of the same image."""
    rect = np.asarray(aster["jax"]["rectify"](aster["vars"], aster["x"]))
    want = np.array(aster["jax"]["encoder"](aster["vars"], rect))  # writable, for torch.from_numpy
    with torch.no_grad():
        got = _np(aster["port"].encoder(nchw(rect)))
    return got, want


def test_encoder_features(features):
    got, want = features
    assert got.shape == want.shape == (B, 25, 512)
    print("encoder max_abs_err", np.abs(got - want).max(), "max_abs", np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=FEATURE_ATOL)


def test_teacher_forced_logits(aster, features):
    _, feats = features
    targets = np.random.default_rng(1).integers(0, aster["info"].rec_num_classes, (B, MAX_LEN)).astype(np.int32)
    want = np.asarray(aster["jax"]["logits"](aster["vars"], feats, targets))
    with torch.no_grad():
        got = _np(aster["port"].decoder(torch.from_numpy(feats), torch.from_numpy(targets).long()))
    print("teacher-forced logits max_abs_err", np.abs(got - want).max())
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL)


def test_greedy_sample(aster, features):
    """Greedy ids equal where every step's top two logits are ``MARGIN``
    apart, read from the JAX logits teacher-forced on those ids; their
    probabilities at ``LOGIT_ATOL``."""
    _, feats = features
    want_ids, want_p = (np.asarray(a) for a in aster["jax"]["sample"](aster["vars"], feats))
    with torch.no_grad():
        ids, p = aster["port"].decoder.sample(torch.from_numpy(feats))
    logits = np.asarray(aster["jax"]["logits"](aster["vars"], feats, want_ids))
    margins = greedy_margins(logits)
    print("greedy margins", margins)
    assert (margins > MARGIN).all(), margins
    np.testing.assert_array_equal(_np(ids), want_ids)
    np.testing.assert_allclose(_np(p), want_p, atol=LOGIT_ATOL)


def _sequence_score(logits: np.ndarray, ids: np.ndarray, eos: int) -> np.ndarray:
    """Log-probability of each row of ``ids`` up to its first EOS, from
    teacher-forced logits: a beam's score (finished beams add 0)."""
    logp = logits - logits.max(-1, keepdims=True)
    logp = logp - np.log(np.exp(logp).sum(-1, keepdims=True))
    picked = np.take_along_axis(logp, ids[..., None], -1)[..., 0]
    live = np.cumsum(ids == eos, axis=1) - (ids == eos) == 0  # up to and including the first EOS
    return (picked * live).sum(-1)


def test_beam_search(aster, features):
    """Beam width 5: the best beam's score against the JAX decoder's
    teacher-forced score of the same ids, then the ids exactly, where every
    selection is ``MARGIN`` clear of the next candidate."""
    _, feats = features
    eos = aster["info"].char2id[aster["info"].EOS]
    with torch.no_grad():
        res = aster["port"].decoder.beam_search(torch.from_numpy(feats), 5, eos)
    ids = _np(res.ids)
    logits = np.asarray(aster["jax"]["logits"](aster["vars"], feats, ids.astype(np.int32)))
    want_scores = _sequence_score(logits, ids, eos)
    print("beam scores", _np(res.scores), "max_abs_err", np.abs(_np(res.scores) - want_scores).max(),
          "margins", _np(res.margins))
    np.testing.assert_allclose(_np(res.scores), want_scores, atol=SCORE_ATOL)
    assert (_np(res.margins) > MARGIN).all()
    np.testing.assert_array_equal(ids, np.asarray(aster["jax"]["beam"](aster["vars"], feats)))


def test_recognizer_end_to_end(aster):
    """The whole model on the [-1, 1] image: the port's ids are JAX's, where
    the port's beam margins clear ``MARGIN``."""
    x, port = aster["x"], aster["port"]
    with torch.no_grad():
        ids = _np(port(nchw(x)))
        res = port.decoder.beam_search(port.encoder(port.rectify(nchw(x))), 5, port.eos_id)
    print("end-to-end margins", _np(res.margins))
    assert (_np(res.margins) > MARGIN).all()
    np.testing.assert_array_equal(ids, _np(res.ids))
    np.testing.assert_array_equal(ids, np.asarray(aster["jax"]["forward"](aster["vars"], x)))


def test_decode_aster_ids_matches_jax():
    """Fixed ids holding EOS, UNKNOWN, PADDING, punctuation and capitals:
    the port's strings are JAX's; PADDING drops whole and EOS ends a row."""
    info = AsterInfo("all")
    eos, pad, unk = info.char2id["EOS"], info.char2id["PADDING"], info.char2id["UNKNOWN"]
    c = info.char2id
    ids = np.array([[c["H"], c["i"], pad, c["!"], c["7"], eos, c["x"]],
                    [unk, c["a"], unk, c["B"], c["c"], c["D"], pad],
                    [eos, c["z"], c["z"], eos, pad, unk, c["q"]]], np.int64)
    from tpgsr_tpu.charset import AsterInfo as JaxAsterInfo

    want = jax_decode_aster_ids(ids, JaxAsterInfo("all"))
    assert want == ["hi7", "abcd", ""]
    assert decode_aster_ids(ids, info) == want
    assert decode_aster_ids(torch.from_numpy(ids), info) == want
