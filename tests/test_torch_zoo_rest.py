"""The rest of the single-model SR zoo held to the flax modules on the same
weights, carried over by ``tpgsr_tpu_torch.interop.from_jax``: VDSR,
VDSR_TL, EDSR, LapSRN (with and without its STN), RRDBNet, RRDBNet_TL,
bicubic, ``textzoom_net`` and the TSRN_TL of ``tsrn_tl_wmask``, in eval and
in train mode; each converter's round trip through
``tpgsr_tpu.interop.torch_import.import_sr_checkpoint``; the registry
entries; the two new losses; and the draws of the MSRA convs and the
bilinear deconv.

The models' flax variables are the port's seeded draws read by the JAX
package's importer, with two exceptions: LapSRN's deconvs are redrawn at
random, since their bilinear init is symmetric and would hide a wrong flip;
and RRDBNet_TL's are flax's own init, since the JAX importer reads no
``infoGen`` for it.  BatchNorm statistics are drawn at random so that eval
mode is not the identity.  Outputs at atol 1e-5 times the largest output
value where that exceeds 1: the MSRA draws of VDSR and EDSR, whose residual
trunks add up, give outputs near 20, where fp32's reordered sums differ by
some 1e-6 of the value; the updated BatchNorm statistics at rtol 1e-4, atol
1e-5.  Sizes: LR 8x16 -> HR 16x32 (16x32 -> 32x64 for LapSRN's STN, whose
pools need it), batch 2, the TSRNs at 2 SRBs and hidden 8 (``textzoom_net``
at its fixed 6 and 32), EDSR at 2 residual blocks, RRDB at ``nb=2``."""

import functools

import jax
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from tests.torch_suite import port_test_module  # noqa: F401  (the run's compile cache, no TensorBoard)

from tpgsr_tpu import losses as jax_losses
from tpgsr_tpu.interop import torch_import as ti
from tpgsr_tpu.models import edsr as jax_edsr
from tpgsr_tpu.models import lapsrn as jax_lapsrn
from tpgsr_tpu.models import rrdb as jax_rrdb
from tpgsr_tpu.models.registry import ARCHS as JAX_ARCHS
from tpgsr_tpu.models.registry import TL_SIMPLE as JAX_TL_SIMPLE
from tpgsr_tpu_torch import losses
from tpgsr_tpu_torch.interop import from_jax
from tpgsr_tpu_torch.models import edsr, layers, lapsrn, rrdb, vdsr
from tpgsr_tpu_torch.models.layers import BilinearConvTranspose2d, MSRAConv2d, init_torch_defaults_
from tpgsr_tpu_torch.models.registry import ARCHS, NOT_PORTED, TL_SIMPLE, build_model

B, H, W = 2, 8, 16
NEW_ARCHS = ("tsrn_tl", "tsrn_tl_wmask", "textzoom_net", "vdsr", "vdsr_tl", "edsr", "lapsrn", "esrgan", "esrgan_tl",
             "bicubic")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _numpy_tree(variables):
    return jax.tree_util.tree_map(np.asarray, unfreeze(variables))


def _random_stats(v, seed):
    """Every BatchNorm mean/var of the numpy tree ``v`` replaced with random
    values (var > 0)."""
    rng = np.random.default_rng(seed)

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


# ---------------------------------------------------------------- the cases

# (arch, STN): the registry's widths where they are cheap at this size, a
# shallower trunk where they are not (EDSR, RRDB)
CASES = [("tsrn_tl_wmask", False), ("textzoom_net", False), ("vdsr", False), ("vdsr_tl", False), ("edsr", False),
         ("lapsrn", False), ("lapsrn", True), ("esrgan", False), ("esrgan_tl", False), ("bicubic", False)]
IDS = [f"{a}{'-stn' if stn else ''}" for a, stn in CASES]
SHALLOW = {
    "edsr": (lambda: jax_edsr.EDSR(2, n_resblocks=2), lambda: edsr.EDSR(2, n_resblocks=2)),
    "esrgan": (lambda: jax_rrdb.RRDBNet(2, nb=2), lambda: rrdb.RRDBNet(2, nb=2)),
    "esrgan_tl": (lambda: jax_rrdb.RRDBNet_TL(2, nb=2), lambda: rrdb.RRDBNet_TL(2, nb=2)),
}
SRB = {"textzoom_net": 6}


def _size(stn):
    return (2 * H, 2 * W) if stn else (H, W)


def _dicts(arch, stn):
    h, w = _size(stn)
    return ({"STN": stn, "mask": True, "srb": SRB.get(arch, 2), "hd_u": 8},
            {"scale_factor": 2, "width": 2 * w, "height": 2 * h})


def _jax_model(arch, stn):
    if arch in SHALLOW:
        return SHALLOW[arch][0]()
    return JAX_ARCHS[arch].build(*_dicts(arch, stn))


def _port_model(arch, stn):
    if arch in SHALLOW:
        return SHALLOW[arch][1]()
    return build_model(arch, *_dicts(arch, stn))[0]


def _importer_arch(arch):
    """The name ``import_sr_checkpoint`` knows the arch's weights by:
    ``textzoom_net`` is a TSRN (of 6 SRBs)."""
    return "tsrn" if arch == "textzoom_net" else arch


def _inputs(arch, stn, seed):
    rng = np.random.default_rng(seed)
    h, w = _size(stn)
    x = rng.random((B, h, w, 4), dtype=np.float32)[..., : ARCHS[arch].in_channels]
    prior_in = rng.random((B, 1, 26, 37), dtype=np.float32)
    return (x, prior_in) if ARCHS[arch].uses_prior else (x,)


def _drawn_variables(arch, stn, inputs):
    """The case's flax variables (numpy), BatchNorm statistics at random."""
    if arch == "esrgan_tl":  # the JAX importer reads no infoGen for it
        v = _numpy_tree(jax.jit(functools.partial(_jax_model(arch, stn).init, train=False))(
            jax.random.PRNGKey(20), *inputs))
        return _random_stats(v, 20)
    if arch == "bicubic":
        return {"params": {}, "batch_stats": {}}
    port = init_torch_defaults_(_port_model(arch, stn), torch.Generator().manual_seed(20))
    gen = torch.Generator().manual_seed(21)
    with torch.no_grad():
        for m in port.modules():
            if isinstance(m, BilinearConvTranspose2d):  # drawn, not symmetric
                m.weight.normal_(0.0, 0.1, generator=gen)
    sd = {k: t.numpy() for k, t in port.state_dict().items()}
    v = _numpy_tree(ti.import_sr_checkpoint(_importer_arch(arch), sd, srb_nums=_dicts(arch, stn)[0]["srb"]))
    return _random_stats(v, 20)


@functools.lru_cache(maxsize=None)
def _flax(arch, stn):
    """(flax variables, the inputs, and flax's outputs on them: eval, eval
    without the prior (a prior arch), train with the updated batch
    statistics), compiled as one function and shared by this file's tests
    of the case."""
    model = _jax_model(arch, stn)
    inputs = _inputs(arch, stn, 10)
    v = _drawn_variables(arch, stn, inputs)

    def outputs(v, *a):
        no_prior = model.apply(v, a[0], None, train=False) if len(a) == 2 else None
        return model.apply(v, *a, train=False), no_prior, model.apply(v, *a, train=True, mutable=["batch_stats"])

    ref, ref_no_prior, (ref_train, mut) = jax.jit(outputs)(v, *inputs)
    return v, inputs, {"eval": np.asarray(ref), "eval_no_prior": ref_no_prior, "train": np.asarray(ref_train),
                       "stats": _numpy_tree(mut).get("batch_stats", {})}


def _srb(arch, stn):
    return _dicts(arch, stn)[0]["srb"]


def _port(arch, stn, v):
    port = _port_model(arch, stn)
    port.load_state_dict(from_jax.sr_state_dict(arch, v, srb_nums=_srb(arch, stn)), strict=True)
    return port


def _atol(ref):
    return 1e-5 * max(1.0, float(np.abs(ref).max()))


@pytest.mark.parametrize("arch,stn", CASES, ids=IDS)
def test_model_matches_flax_in_eval(arch, stn):
    """Eval mode on shared weights; a prior arch also without its prior."""
    v, inputs, ref = _flax(arch, stn)
    port = _port(arch, stn, v).eval()
    with torch.no_grad():
        got = _nhwc(port(*(_nchw(a) for a in inputs)))
    h, w = _size(stn)
    assert got.shape == ref["eval"].shape == (B, 2 * h, 2 * w, inputs[0].shape[-1])
    np.testing.assert_allclose(got, ref["eval"], atol=_atol(ref["eval"]))
    if len(inputs) == 2:
        with torch.no_grad():
            got = _nhwc(port(_nchw(inputs[0])))
        np.testing.assert_allclose(got, np.asarray(ref["eval_no_prior"]), atol=_atol(ref["eval"]))


@pytest.mark.parametrize("arch,stn", CASES, ids=IDS)
def test_model_matches_flax_in_train(arch, stn):
    """Train mode on shared weights: the output, and every BatchNorm running
    statistic after the forward (the STN's and the prior's included)."""
    v, inputs, ref = _flax(arch, stn)
    port = _port(arch, stn, v).train()
    got = _nhwc(port(*(_nchw(a) for a in inputs)))
    np.testing.assert_allclose(got, ref["train"], atol=_atol(ref["train"]))
    new = from_jax.sr_state_dict(arch, {"params": v["params"], "batch_stats": ref["stats"]}, srb_nums=_srb(arch, stn))
    sd = port.state_dict()
    stats = [k for k in new if "running" in k]
    assert bool(stats) == (ARCHS[arch].uses_prior or arch == "textzoom_net" or stn)
    assert any(k.startswith("stn_head.") for k in stats) == stn
    for k in stats:
        np.testing.assert_allclose(sd[k].numpy(), new[k].numpy(), rtol=1e-4, atol=1e-5, err_msg=k)


def _assert_trees_equal(a, b):
    la, _ = jax.tree_util.tree_flatten_with_path(a)
    lb, _ = jax.tree_util.tree_flatten_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=str(path))


ROUND_TRIP = [c for c in CASES if c[0] not in ("esrgan_tl", "bicubic")]


@pytest.mark.parametrize("arch,stn", ROUND_TRIP, ids=[f"{a}{'-stn' if s else ''}" for a, s in ROUND_TRIP])
def test_state_dict_round_trips_through_import_sr_checkpoint(arch, stn):
    """``sr_state_dict``, then the JAX package's ``import_sr_checkpoint``
    (under ``tsrn`` for ``textzoom_net``), gives back the flax variables
    exactly; the keys are the original's (the state_dict loads strictly)."""
    v, _, _ = _flax(arch, stn)
    sd = {k: t.numpy() for k, t in from_jax.sr_state_dict(arch, v, srb_nums=_srb(arch, stn)).items()}
    _assert_trees_equal(ti.import_sr_checkpoint(_importer_arch(arch), sd, srb_nums=_srb(arch, stn)), v)


def test_esrgan_tl_and_bicubic_state_dicts():
    """RRDBNet_TL's state_dict holds the RRDB keys the JAX importer reads and
    the ``infoGen`` it does not; bicubic's is empty in both packages."""
    v, _, _ = _flax("esrgan_tl", False)
    sd = from_jax.sr_state_dict("esrgan_tl", v)
    assert set(sd) == set(_port_model("esrgan_tl", False).state_dict())
    plain = {k: t.numpy() for k, t in sd.items() if not k.startswith("infoGen.")}
    _assert_trees_equal(ti.import_sr_checkpoint("esrgan_tl", plain)["params"],
                        {k: x for k, x in v["params"].items() if k != "infoGen"})
    assert any(k.startswith("infoGen.bn4.running") for k in sd)
    assert from_jax.sr_state_dict("bicubic", _flax("bicubic", False)[0]) == {}
    assert build_model("bicubic", *_dicts("bicubic", False))[0].state_dict() == {}


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_registry_entry_matches_jax(arch):
    """Criterion, input channels, prior and trainability are the JAX
    package's; ``TL_SIMPLE`` is its list; ``textzoom_net`` is a 3-channel TSRN
    of 6 SRBs at hidden 32 whatever ``--srb`` and ``--hd_u`` say."""
    spec, want = ARCHS[arch], JAX_ARCHS[arch]
    assert (spec.crit, spec.in_channels, spec.uses_prior, spec.trainable) == (
        want.crit, want.in_channels, want.uses_prior, want.trainable)
    assert TL_SIMPLE == JAX_TL_SIMPLE and NOT_PORTED == ()
    if arch == "textzoom_net":
        model = build_model(arch, {"STN": False, "mask": True, "srb": 2, "hd_u": 8},
                            {"scale_factor": 2, "width": 128, "height": 32})[0]
        assert model.srb_nums == 6 and model.in_planes == 3 and model.block2.conv1.in_channels == 64


# ---------------------------------------------------------------- pieces


@pytest.mark.parametrize("in_ch,out_ch", [(64, 64), (3, 3)])
def test_lapsrn_deconv_matches_flax_on_drawn_kernels(in_ch, out_ch):
    """``BilinearConvTranspose2d`` with the JAX kernel through the conv-T rule
    equals ``_BilinearDeconv`` (a conv of the input dilated by 2, padded by 2,
    kernel unflipped) on a drawn kernel that is not symmetric."""
    rng = np.random.default_rng(30)
    x = rng.random((B, 5, 7, in_ch), dtype=np.float32)
    kernel = rng.standard_normal((4, 4, in_ch, out_ch)).astype(np.float32)
    assert not np.allclose(kernel, kernel[::-1, ::-1])
    ref = np.asarray(jax_lapsrn._BilinearDeconv(out_ch).apply({"params": {"kernel": kernel}}, x))
    sd = {}
    from_jax._conv_t(sd, {"kernel": kernel}, "d")
    port = BilinearConvTranspose2d(in_ch, out_ch)
    port.load_state_dict({"weight": sd["d.weight"]})
    with torch.no_grad():
        got = _nhwc(port(_nchw(x)))
    assert got.shape == ref.shape == (B, 10, 14, out_ch)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_own_draws_are_the_originals():
    """``init_torch_defaults_`` leaves each MSRA conv N(0, 2 / (9 out)) and each
    LapSRN deconv the bilinear filter for every (in, out) pair, as the flax
    initializers draw them."""
    model = init_torch_defaults_(lapsrn.LapSRN(2, 3), torch.Generator().manual_seed(0))
    deconv = model.convt_F1[0].cov_block[20]
    want = layers.bilinear_upsample_filter(4)
    np.testing.assert_array_equal(want, jax_lapsrn.bilinear_upsample_filter(4))
    assert all(np.array_equal(w, want) for w in deconv.weight.detach().numpy().reshape(-1, 4, 4))
    big = init_torch_defaults_(vdsr.VDSR(2, 3), torch.Generator().manual_seed(0)).residual_layer[0].conv
    assert isinstance(big, MSRAConv2d) and big.bias is None
    np.testing.assert_allclose(float(big.weight.detach().std()), (2.0 / (9 * 64)) ** 0.5, rtol=0.02)


def test_charbonnier_and_ssim_losses_match_jax():
    """LapSRN's Charbonnier is a sum, not a mean; ``ssim_loss`` is (1 - SSIM) x 10."""
    rng = np.random.default_rng(31)
    a = rng.random((B, 16, 32, 4), dtype=np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape).astype(np.float32), 0, 1)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = float(losses.charbonnier_loss(ta, tb))
    np.testing.assert_allclose(got, float(jax_losses.charbonnier_loss(a, b)), rtol=1e-5)
    assert got > a.size * 0.01  # a sum over the elements
    np.testing.assert_allclose(float(losses.ssim_loss(ta, tb)), float(jax_losses.ssim_loss(a, b)), rtol=1e-5)
