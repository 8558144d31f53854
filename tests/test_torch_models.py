"""The port's modules held to the flax modules on the same weights, carried
over by ``tpgsr_tpu_torch.interop.from_jax``; and the round trip back through
``tpgsr_tpu.interop.torch_import``.

Batch statistics are drawn at random so BatchNorm in eval mode is not the
identity.  Tolerances: 1e-5 for single blocks, 2e-4 for the CRNN and 5e-4
for the full TSRN_TL (tests/test_models_parity.py:35,101), where the
reordered fp32 sums of many layers add up."""

import jax
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from tests.torch_suite import port_test_module  # noqa: F401  (the run's compile cache, no TensorBoard)

from tpgsr_tpu.interop import torch_import as ti
from tpgsr_tpu.models import crnn as jax_crnn
from tpgsr_tpu.models import layers as jax_layers
from tpgsr_tpu.models import tsrn as jax_tsrn
from tpgsr_tpu_torch.interop import from_jax
from tpgsr_tpu_torch.models.crnn import CRNN
from tpgsr_tpu_torch.models.layers import GruBlock
from tpgsr_tpu_torch.models.tsrn import TSRN_TL, InfoGen, RecurrentResidualBlockTL


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _numpy_tree(variables):
    return jax.tree_util.tree_map(np.asarray, unfreeze(variables))


def _random_stats(variables, seed):
    """Replace every BatchNorm mean/var with random values (var > 0)."""
    rng = np.random.default_rng(seed)
    v = _numpy_tree(variables)

    def walk(node):
        for k, val in node.items():
            if isinstance(val, dict):
                walk(val)
            elif k == "mean":
                node[k] = (0.1 * rng.standard_normal(val.shape)).astype(np.float32)
            elif k == "var":
                node[k] = rng.uniform(0.5, 1.5, val.shape).astype(np.float32)

    walk(v.get("batch_stats", {}))
    return v


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _load(module, sd):
    module.load_state_dict(sd, strict=True)
    return module.eval()


@pytest.mark.parametrize("c_in,c_out", [(12, 16), (24, 32)])
def test_grublock_matches_flax(c_in, c_out):
    x = np.random.default_rng(0).random((2, 6, 10, c_in), dtype=np.float32)
    flax_block = jax_layers.GruBlock(c_out)
    v = _numpy_tree(flax_block.init(jax.random.PRNGKey(0), x))
    sd = {}
    from_jax._conv(sd, v["params"]["conv1"], "conv1")
    from_jax._rnn(sd, v["params"]["gru"], "gru")
    port = _load(GruBlock(c_in, c_out), sd)
    with torch.no_grad():
        got = _nhwc(port(_nchw(x)))
    np.testing.assert_allclose(got, np.asarray(flax_block.apply(v, x)), atol=1e-5)


def test_infogen_matches_flax():
    t = np.random.default_rng(1).random((2, 1, 26, 37), dtype=np.float32)
    flax_ig = jax_tsrn.InfoGen(37, 32)
    v = _random_stats(flax_ig.init(jax.random.PRNGKey(1), t, train=False), 1)
    sd = {}
    for k in (1, 2, 3, 4):
        from_jax._conv_t(sd, v["params"][f"tconv{k}"], f"tconv{k}")
        from_jax._bn(sd, v["params"][f"bn{k}"], v["batch_stats"][f"bn{k}"], f"bn{k}")
    port = _load(InfoGen(37, 32), sd)
    with torch.no_grad():
        got = _nhwc(port(_nchw(t)))
    ref = np.asarray(flax_ig.apply(v, t, train=False))
    assert got.shape == ref.shape == (2, 1, 203, 32)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_srb_tl_matches_flax():
    rng = np.random.default_rng(2)
    x = rng.random((2, 8, 16, 16), dtype=np.float32)
    temb = rng.random((2, 8, 16, 8), dtype=np.float32)
    flax_srb = jax_tsrn.RecurrentResidualBlockTL(16, 8)
    v = _random_stats(flax_srb.init(jax.random.PRNGKey(2), x, temb, train=False), 2)
    p, s = v["params"], v["batch_stats"]
    sd = {}
    for name in ("conv1", "conv2"):
        from_jax._conv(sd, p[name], name)
    for name in ("bn1", "bn2"):
        from_jax._bn(sd, p[name], s[name], name)
    for g in ("gru1", "gru2"):
        from_jax._conv(sd, p[g]["conv1"], f"{g}.conv1")
        from_jax._rnn(sd, p[g]["gru"], f"{g}.gru")
    port = _load(RecurrentResidualBlockTL(16, 8), sd)
    with torch.no_grad():
        got = _nhwc(port(_nchw(x), _nchw(temb)))
    np.testing.assert_allclose(got, np.asarray(flax_srb.apply(v, x, temb, train=False)), atol=1e-5)


def _tiny_tsrn_tl():
    rng = np.random.default_rng(3)
    x = rng.random((2, 16, 32, 4), dtype=np.float32)
    prior = rng.random((2, 1, 26, 37), dtype=np.float32)
    model = jax_tsrn.TSRN_TL(scale_factor=2, width=64, height=32, stn=True, mask=True,
                             srb_nums=2, hidden_units=8)
    # init in train mode, so that the variables hold the STN head
    v = _random_stats(model.init(jax.random.PRNGKey(3), x, prior, train=True), 3)
    return model, v, x, prior


def test_tsrn_tl_matches_flax():
    """The full model, with the port's original HR head (upsample, shuffle,
    mish, 9x9 conv) against the JAX package's fused 5x5 LR head."""
    model, v, x, prior = _tiny_tsrn_tl()
    port = _load(TSRN_TL(scale_factor=2, width=64, height=32, stn=True, mask=True, srb_nums=2,
                         hidden_units=8), from_jax.tsrn_tl_state_dict(v, srb_nums=2))
    with torch.no_grad():
        got = _nhwc(port(_nchw(x), _nchw(prior)))
        no_prior = _nhwc(port(_nchw(x)))
    ref = np.asarray(model.apply(v, x, prior, train=False))
    assert got.shape == ref.shape == (2, 32, 64, 4)
    np.testing.assert_allclose(got, ref, atol=5e-4)
    np.testing.assert_allclose(no_prior, np.asarray(model.apply(v, x, None, train=False)), atol=5e-4)


def test_tsrn_tl_stn_train_mode_matches_flax():
    """Train mode runs STN -> TPS -> SR: the output and every updated batch
    statistic against flax's.  fc2's weights are drawn at random so that the
    TPS warp depends on the image.  Output at 1e-3: the TPS sampler turns the
    control points' fp32 noise into pixel error (tests/test_torch_train.py),
    and every BatchNorm normalises by the batch's statistics."""
    model, v, x, prior = _tiny_tsrn_tl()
    rng = np.random.default_rng(30)
    fc2 = v["params"]["stn_head"]["fc2_kernel"]
    v["params"]["stn_head"]["fc2_kernel"] = (0.05 * rng.standard_normal(fc2.shape)).astype(np.float32)
    ref, mut = model.apply(v, x, prior, train=True, mutable=["batch_stats"])
    port = TSRN_TL(scale_factor=2, width=64, height=32, stn=True, mask=True, srb_nums=2, hidden_units=8)
    port.load_state_dict(from_jax.tsrn_tl_state_dict(v, srb_nums=2), strict=True)
    port.train()
    got = _nhwc(port(_nchw(x), _nchw(prior)))
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-3)
    new = from_jax.tsrn_tl_state_dict({"params": v["params"], "batch_stats": _numpy_tree(mut)["batch_stats"]},
                                      srb_nums=2)
    stats = [k for k in new if "running" in k]
    assert any(k.startswith("stn_head.") for k in stats)
    sd = port.state_dict()
    for k in stats:
        np.testing.assert_allclose(sd[k].numpy(), new[k].numpy(), rtol=1e-4, atol=1e-5, err_msg=k)


def _crnn_vars(seed, width=100):
    x = np.random.default_rng(seed).random((2, 32, width, 1), dtype=np.float32)
    v = _random_stats(jax_crnn.CRNN().init(jax.random.PRNGKey(seed), x, train=False), seed)
    return v, x


@pytest.mark.parametrize("width", [100, 64])
def test_crnn_matches_flax(width):
    v, x = _crnn_vars(4, width)
    port = _load(CRNN(), from_jax.crnn_state_dict(v))
    with torch.no_grad():
        got = port(_nchw(x)).numpy()
    ref = np.asarray(jax_crnn.CRNN().apply(v, x, train=False))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=2e-4)


def _assert_trees_equal(a, b):
    la, ta = jax.tree_util.tree_flatten_with_path(a)
    lb, tb = jax.tree_util.tree_flatten_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=str(path))


def test_state_dicts_round_trip_through_torch_import():
    """from_jax, then the JAX package's own importers, gives back the flax
    variables exactly."""
    _, v, _, _ = _tiny_tsrn_tl()
    sd = {k: t.numpy() for k, t in from_jax.tsrn_tl_state_dict(v, srb_nums=2).items()}
    _assert_trees_equal(ti.import_tsrn(sd, srb_nums=2), v)
    v, _ = _crnn_vars(5)
    sd = {k: t.numpy() for k, t in from_jax.crnn_state_dict(v).items()}
    _assert_trees_equal(ti.import_crnn(sd), v)
