"""The port's SR zoo held to the flax modules on the same weights, carried
over by ``tpgsr_tpu_torch.interop.from_jax``: the blocks, each of the seven
archs the repo's other train scripts run (tsrn, srcnn, srcnn_tl, srres,
srresnet_tl, rdn, rdn_tl) and TSRN_TL with a plain sixth SRB, in eval and
in train mode; and each converter's round trip through
``tpgsr_tpu.interop.torch_import.import_sr_checkpoint``.  The models' flax
variables are the port's seeded draws read by that importer.

Batch statistics are drawn at random so BatchNorm in eval mode is not the
identity.  Tolerances are tests/test_torch_models.py's: 1e-5 for single
blocks, 5e-4 for whole models, whose reordered fp32 sums over many layers
add up; in train mode the updated BatchNorm statistics at rtol 1e-4, atol
1e-5.  Sizes: LR 16x32 -> HR 32x64, batch 2, the TSRNs at hidden 8; the
other backbones at their own widths, which their registry entries fix."""

import functools

import jax
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from tests.torch_suite import port_test_module  # noqa: F401  (the run's compile cache, no TensorBoard)

from tpgsr_tpu.interop import torch_import as ti
from tpgsr_tpu.models import prior as jax_prior
from tpgsr_tpu.models import rdn as jax_rdn
from tpgsr_tpu.models import srcnn as jax_srcnn
from tpgsr_tpu.models import srresnet as jax_srresnet
from tpgsr_tpu.models import tsrn as jax_tsrn
from tpgsr_tpu.models.registry import ARCHS as JAX_ARCHS
from tpgsr_tpu_torch.interop import from_jax
from tpgsr_tpu_torch.models import prior, rdn, srcnn, srresnet, tsrn
from tpgsr_tpu_torch.models.layers import init_torch_defaults_
from tpgsr_tpu_torch.models.registry import ARCHS, build_model

B, H, W = 2, 16, 32
SRB = {"tsrn": 2, "tsrn_tl_cascade": 6}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _numpy_tree(variables):
    return jax.tree_util.tree_map(np.asarray, unfreeze(variables))


def _random_stats(variables, seed):
    """Every BatchNorm mean/var replaced with random values (var > 0)."""
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


# ---------------------------------------------------------------- blocks


def _block_sd(p, s, convs=(), bns=(), prelus=()):
    sd = {}
    for name in convs:
        from_jax._conv(sd, p[name], name)
    for name in bns:
        from_jax._bn(sd, p[name], s[name], name)
    for name in prelus:
        sd[f"{name}.weight"] = torch.from_numpy(np.array(p[name]["alpha"]))
    return sd


@pytest.mark.parametrize("paddings", ["TSRN_PADDINGS", "NP_PADDINGS"])
def test_infogen_matches_flax(paddings):
    t = np.random.default_rng(1).random((B, 1, 26, 37), dtype=np.float32)
    pads = getattr(jax_prior, paddings)
    flax_ig = jax_prior.InfoGenP(37, 32, pads)
    v = _random_stats(flax_ig.init(jax.random.PRNGKey(1), t, train=False), 1)
    sd = {}
    from_jax._infogen(sd, {"infoGen": v["params"]}, {"infoGen": v["batch_stats"]})
    port = _load(prior.InfoGenP(37, 32, getattr(prior, paddings)), {k[len("infoGen."):]: x for k, x in sd.items()})
    with torch.no_grad():
        got = _nhwc(port(_nchw(t)))
    ref = np.asarray(flax_ig.apply(v, t, train=False))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_plain_recurrent_block_matches_flax():
    x = np.random.default_rng(2).random((B, 8, 16, 16), dtype=np.float32)
    flax_srb = jax_tsrn.RecurrentResidualBlock(16)
    v = _random_stats(flax_srb.init(jax.random.PRNGKey(2), x, train=False), 2)
    p, s = v["params"], v["batch_stats"]
    sd = _block_sd(p, s, convs=("conv1", "conv2"), bns=("bn1", "bn2"))
    for g in ("gru1", "gru2"):
        from_jax._conv(sd, p[g]["conv1"], f"{g}.conv1")
        from_jax._rnn(sd, p[g]["gru"], f"{g}.gru")
    port = _load(tsrn.RecurrentResidualBlock(16), sd)
    with torch.no_grad():
        got = _nhwc(port(_nchw(x)))
    np.testing.assert_allclose(got, np.asarray(flax_srb.apply(v, x, train=False)), atol=1e-5)


@pytest.mark.parametrize("tl", [False, True], ids=["plain", "tl"])
def test_residual_block_matches_flax(tl):
    rng = np.random.default_rng(3)
    x = rng.random((B, 8, 16, 16), dtype=np.float32)
    temb = rng.random((B, 8, 16, 8), dtype=np.float32)
    flax_block = jax_srresnet.ResidualBlockTL(16, 8) if tl else jax_srresnet.ResidualBlock(16)
    inputs = (x, temb) if tl else (x,)
    v = _random_stats(flax_block.init(jax.random.PRNGKey(3), *inputs, train=False), 3)
    sd = _block_sd(v["params"], v["batch_stats"], convs=("conv1", "conv2"), bns=("bn1", "bn2"), prelus=("prelu",))
    port = _load(srresnet.ResidualBlockTL(16, 8) if tl else srresnet.ResidualBlock(16), sd)
    with torch.no_grad():
        got = _nhwc(port(*(_nchw(a) for a in inputs)))
    np.testing.assert_allclose(got, np.asarray(flax_block.apply(v, *inputs, train=False)), atol=1e-5)


@pytest.mark.parametrize("text_channels", [0, 8])
def test_rdb_matches_flax(text_channels):
    rng = np.random.default_rng(4)
    x = rng.random((B, 8, 16, 16), dtype=np.float32)
    temb = rng.random((B, 8, 16, 8), dtype=np.float32) if text_channels else None
    flax_rdb = jax_rdn.RDB(16, 3, 8, text_channels)
    v = _numpy_tree(flax_rdb.init(jax.random.PRNGKey(4), x, temb))
    sd = {}
    for i in range(3):
        from_jax._conv(sd, v["params"][f"dense{i}"]["conv"], f"dense_layers.{i}.conv")
    from_jax._conv(sd, v["params"]["conv_1x1"], "conv_1x1")
    port = _load(rdn.RDB(16, 3, 8, text_channels), sd)
    with torch.no_grad():
        got = _nhwc(port(_nchw(x), None if temb is None else _nchw(temb)))
    np.testing.assert_allclose(got, np.asarray(flax_rdb.apply(v, x, temb)), atol=1e-5)


def test_upsample_nearest_equals_the_repeat_pair():
    x = np.random.default_rng(5).random((B, 5, 7, 3), dtype=np.float32)
    got = _nhwc(srcnn.upsample_nearest(_nchw(x), 2))
    np.testing.assert_array_equal(got, np.asarray(jax_srcnn.upsample_nearest(x, 2)))


# ---------------------------------------------------------------- whole models

# (arch, STN): the scripts' flags (only train_TSRN.sh passes --STN), plus
# srcnn and srres with the STN, whose placements differ from TSRN's
CASES = [("tsrn", True), ("srcnn", False), ("srcnn", True), ("srcnn_tl", False), ("srres", False),
         ("srres", True), ("srresnet_tl", False), ("rdn", False), ("rdn_tl", False), ("tsrn_tl_cascade", False)]
IDS = [f"{a}{'-stn' if stn else ''}" for a, stn in CASES]
IDS[-1] = "tsrn_tl_srb6"


def _dicts(arch, stn):
    args = {"STN": stn, "mask": True, "srb": SRB.get(arch, 5), "hd_u": 8}
    return args, {"scale_factor": 2, "width": 2 * W, "height": 2 * H}


def _inputs(arch, seed):
    rng = np.random.default_rng(seed)
    x = rng.random((B, H, W, 4), dtype=np.float32)[..., : ARCHS[arch].in_channels]
    prior_in = rng.random((B, 1, 26, 37), dtype=np.float32)
    return (x, prior_in) if ARCHS[arch].uses_prior else (x,)


@functools.lru_cache(maxsize=None)
def _flax(arch, stn):
    """(flax variables with random BN statistics, the inputs, and flax's
    outputs on them: eval with the prior, eval without it (a prior arch),
    train with the updated batch statistics), built once for this file's
    three tests of the case and compiled as one function."""
    args, cfg = _dicts(arch, stn)
    model = JAX_ARCHS[arch].build(args, cfg)
    inputs = _inputs(arch, 10)
    # the port's seeded draw (the STN head included), read by the JAX
    # package's own importer: flax's jitted init would compile the model
    # once more, and ``model.apply`` below fails on any parameter it misses
    drawn = init_torch_defaults_(build_model(arch, args, cfg)[0], torch.Generator().manual_seed(10))
    sd = {k: t.numpy() for k, t in drawn.state_dict().items()}
    v = _random_stats(ti.import_sr_checkpoint(arch, sd, srb_nums=args["srb"]), 10)

    def outputs(v, *a):
        no_prior = model.apply(v, a[0], None, train=False) if len(a) == 2 else None
        return model.apply(v, *a, train=False), no_prior, model.apply(v, *a, train=True, mutable=["batch_stats"])

    ref, ref_no_prior, (ref_train, mut) = jax.jit(outputs)(v, *inputs)
    return v, inputs, {"eval": np.asarray(ref), "eval_no_prior": ref_no_prior, "train": np.asarray(ref_train),
                       "stats": _numpy_tree(mut).get("batch_stats", {})}


def _port(arch, stn, v):
    """The port model of the case on the flax variables ``v``."""
    args, cfg = _dicts(arch, stn)
    port, spec = build_model(arch, args, cfg)
    assert spec.in_channels == JAX_ARCHS[arch].in_channels and spec.crit == JAX_ARCHS[arch].crit
    port.load_state_dict(from_jax.sr_state_dict(arch, v, srb_nums=args["srb"]), strict=True)
    return port


@pytest.mark.parametrize("arch,stn", CASES, ids=IDS)
def test_model_matches_flax_in_eval(arch, stn):
    """Eval mode on shared weights; a prior arch also without its prior."""
    v, inputs, ref = _flax(arch, stn)
    port = _port(arch, stn, v).eval()
    with torch.no_grad():
        got = _nhwc(port(*(_nchw(a) for a in inputs)))
    assert got.shape == ref["eval"].shape == (B, 2 * H, 2 * W, inputs[0].shape[-1])
    np.testing.assert_allclose(got, ref["eval"], atol=5e-4)
    if len(inputs) == 2:
        with torch.no_grad():
            got = _nhwc(port(_nchw(inputs[0])))
        np.testing.assert_allclose(got, np.asarray(ref["eval_no_prior"]), atol=5e-4)


@pytest.mark.parametrize("arch,stn", CASES, ids=IDS)
def test_model_matches_flax_in_train(arch, stn):
    """Train mode on shared weights: the output, and every BatchNorm running
    statistic after the forward (the STN's included)."""
    v, inputs, ref = _flax(arch, stn)
    port = _port(arch, stn, v).train()
    got = _nhwc(port(*(_nchw(a) for a in inputs)))
    np.testing.assert_allclose(got, ref["train"], atol=5e-4)
    new = from_jax.sr_state_dict(arch, {"params": v["params"], "batch_stats": ref["stats"]},
                                 srb_nums=_dicts(arch, stn)[0]["srb"])
    sd = port.state_dict()
    stats = [k for k in new if "running" in k]
    assert bool(stats) == (arch not in ("srcnn", "rdn") or stn)
    assert any(k.startswith("stn_head.") for k in stats) == stn
    for k in stats:
        np.testing.assert_allclose(sd[k].numpy(), new[k].numpy(), rtol=1e-4, atol=1e-5, err_msg=k)


def test_tsrn_tl_runs_plain_blocks_beyond_the_fifth():
    """srb 6: SRBs 2..6 take the prior, SRB 7 is the plain block, as flax's."""
    port, _ = build_model("tsrn_tl_cascade", *_dicts("tsrn_tl_cascade", False))
    kinds = [type(getattr(port, f"block{i}")) for i in range(2, 8)]
    assert kinds == [tsrn.RecurrentResidualBlockTL] * 5 + [tsrn.RecurrentResidualBlock]
    assert port.block7.gru1.conv1.in_channels == 16 and port.block6.gru1.conv1.in_channels == 48


def _assert_trees_equal(a, b):
    la, _ = jax.tree_util.tree_flatten_with_path(a)
    lb, _ = jax.tree_util.tree_flatten_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=str(path))


@pytest.mark.parametrize("arch,stn", CASES, ids=IDS)
def test_state_dict_round_trips_through_import_sr_checkpoint(arch, stn):
    """``sr_state_dict``, then the JAX package's ``import_sr_checkpoint``,
    gives back the flax variables exactly."""
    v, _, _ = _flax(arch, stn)
    srb = _dicts(arch, stn)[0]["srb"]
    sd = {k: t.numpy() for k, t in from_jax.sr_state_dict(arch, v, srb_nums=srb).items()}
    _assert_trees_equal(ti.import_sr_checkpoint(arch, sd, srb_nums=srb), v)
