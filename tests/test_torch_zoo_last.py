"""The last of the JAX package's models held to its flax modules on the CPU,
on the same weights carried over by ``tpgsr_tpu_torch.interop.from_jax``:
``TSRN_C2F`` and ``SEM_TSRN`` (archs ``tsrn_c2f`` and ``sem_tsrn``) in eval
and in train mode, the annotated transformer's ``LayerNorm``, the ``--tpg
OPT`` model (``OPTModel``) and the SEED eval recognizer
(``SEEDModelBuilder``); each converter's round trip through the JAX
package's importer; the registry entries; and the two archs' collates, byte
for byte.

The flax variables are the port's seeded draws read by the JAX package's
importers (SEED's through ``import_aster`` plus its two linears), BatchNorm
statistics drawn at random so that eval mode is not the identity.
Tolerances: SR outputs and the OPT logits in eval at atol 1e-5, in train
mode at ``OPT_TRAIN_ATOL``; ``tsrn_c2f``'s
coarse map and ``sem_tsrn``'s predicted vectors at 1e-5 of their norm; the
updated BatchNorm statistics at rtol 1e-4, atol 1e-5; SEED's best beam
score at ``tests/test_torch_aster.py``'s ``SCORE_ATOL``, its first state at
1e-4 of its norm, and its ids exactly
where every decision clears its ``MARGIN``.  Sizes: LR 16x32 (``tsrn_c2f``
with its STN, whose pools need it) or 8x16, batch 2, 2 SRBs at hidden 8;
OPT at ``output_channel`` 64 on a 32x64 input; SEED at its full widths
(it has none to cut), ``max_len_labels`` 12, batch 4."""

import functools

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from tests.fixtures import make_textzoom_lmdb
from tests.test_torch_aster import FEATURE_ATOL, MARGIN, SCORE_ATOL, _sequence_score
from tests.torch_recognizers import nchw, numpy_tree, seed_variables
from tests.torch_suite import port_test_module  # noqa: F401  (the run's compile cache, no TensorBoard)
from tpgsr_tpu.charset import AsterInfo as JaxAsterInfo
from tpgsr_tpu.data import collate as jax_collate
from tpgsr_tpu.data import datasets as jax_datasets
from tpgsr_tpu.interop import torch_import as ti
from tpgsr_tpu.models import opt_tpg as jax_opt_tpg
from tpgsr_tpu.models import seed as jax_seed
from tpgsr_tpu.models import transformer as jax_transformer
from tpgsr_tpu.models.registry import ARCHS as JAX_ARCHS
from tpgsr_tpu_torch.charset import AsterInfo
from tpgsr_tpu_torch.data import collate, datasets
from tpgsr_tpu_torch.interop import from_jax
from tpgsr_tpu_torch.models import opt_tpg, seed, transformer
from tpgsr_tpu_torch.models.layers import init_torch_defaults_
from tpgsr_tpu_torch.models.registry import ARCHS, NOT_PORTED, PORTED_ARCHS, build_model

B = 2
CASES = {"tsrn_c2f": (16, 32, True), "sem_tsrn": (8, 16, False)}  # arch: (LR height, LR width, --STN)
OPT_CHANNELS = 64
# OPT's train-mode logits: BatchNorm normalizes over 2 x 17 values a channel
# in the last layers, and fp32 lies 1.9e-5 (the port) and 2.9e-5 (JAX) from
# the port's fp64 on these weights, 5.4e-5 between them, of logits up to 1.7
# (``python -m tests.torch_fp64_noise``, ``opt_train_forward``)
OPT_TRAIN_ATOL = 1e-4
SEED_B, SEED_MAX_LEN = 4, 12


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _random_stats(v, seed_):
    rng = np.random.default_rng(seed_)

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


def _np_sd(module):
    return {k: t.numpy() for k, t in module.state_dict().items()}


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _rel_norm(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ---------------------------------------------------------------- tsrn_c2f, sem_tsrn


def _dicts(arch):
    h, w, stn = CASES[arch]
    return {"STN": stn, "mask": True, "srb": 2, "hd_u": 8}, {"scale_factor": 2, "width": 2 * w, "height": 2 * h}


@functools.lru_cache(maxsize=None)
def _flax(arch):
    """(flax variables, the input, flax's outputs: eval, train and the
    updated statistics), compiled as one function."""
    model = JAX_ARCHS[arch].build(*_dicts(arch))
    port = init_torch_defaults_(build_model(arch, *_dicts(arch))[0], torch.Generator().manual_seed(40))
    v = _random_stats(numpy_tree(ti.import_sr_checkpoint(arch, _np_sd(port), srb_nums=2)), 40)
    h, w, _ = CASES[arch]
    x = np.random.default_rng(41).random((B, h, w, 4), dtype=np.float32)

    def outputs(v, x):
        return model.apply(v, x, train=False), model.apply(v, x, train=True, mutable=["batch_stats"])

    ref_eval, (ref_train, mut) = jax.jit(outputs)(v, x)
    return v, x, {"eval": numpy_tree(ref_eval), "train": numpy_tree(ref_train),
                  "stats": numpy_tree(mut)["batch_stats"]}


def _port(arch, v):
    model = build_model(arch, *_dicts(arch))[0]
    model.load_state_dict(from_jax.sr_state_dict(arch, v, srb_nums=2), strict=True)
    return model


def _assert_pair(arch, got, want):
    """SR at atol 1e-5; the coarse map (an NHWC array) or the predicted
    vectors (a list of [B, 300]) at 1e-5 of their norm."""
    sr, aux = got
    h, w, _ = CASES[arch]
    assert _nhwc(sr).shape == want[0].shape == (B, 2 * h, 2 * w, 4)
    np.testing.assert_allclose(_nhwc(sr), want[0], atol=1e-5)
    if arch == "tsrn_c2f":
        assert _nhwc(aux).shape == want[1].shape == (B, h, w, 4)
        assert _rel_norm(_nhwc(aux), want[1]) <= 1e-5
    else:
        assert len(aux) == len(want[1]) == 2
        for a, b in zip(aux, want[1]):
            assert a.shape == b.shape == (B, 300)
            assert _rel_norm(a.detach().numpy(), b) <= 1e-5


@pytest.mark.parametrize("arch", list(CASES))
def test_model_matches_flax_in_eval(arch):
    v, x, ref = _flax(arch)
    port = _port(arch, v).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))
    _assert_pair(arch, got, ref["eval"])


@pytest.mark.parametrize("arch", list(CASES))
def test_model_matches_flax_in_train(arch):
    """Train mode (``tsrn_c2f``'s STN rectifies the input): the outputs, and
    every BatchNorm running statistic after the forward."""
    v, x, ref = _flax(arch)
    port = _port(arch, v).train()
    got = port(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))
    _assert_pair(arch, got, ref["train"])
    new = from_jax.sr_state_dict(arch, {"params": v["params"], "batch_stats": ref["stats"]}, srb_nums=2)
    sd = port.state_dict()
    stats = [k for k in new if "running" in k]
    assert any(k.startswith("stn_head.") for k in stats) == CASES[arch][2]
    for k in stats:
        np.testing.assert_allclose(sd[k].numpy(), new[k].numpy(), rtol=1e-4, atol=1e-5, err_msg=k)


def _assert_trees_equal(a, b):
    la, _ = jax.tree_util.tree_flatten_with_path(a)
    lb, _ = jax.tree_util.tree_flatten_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=str(path))


@pytest.mark.parametrize("arch", list(CASES))
def test_state_dict_round_trips_through_import_sr_checkpoint(arch):
    """``sr_state_dict`` then ``import_sr_checkpoint`` gives the variables
    back exactly; the keys are the port model's (it loads strictly), and
    ``sem_tsrn``'s bypassed projections come as zeros."""
    v, _, _ = _flax(arch)
    sd = from_jax.sr_state_dict(arch, v, srb_nums=2)
    assert sorted(sd) == sorted(build_model(arch, *_dicts(arch))[0].state_dict())
    if arch == "sem_tsrn":
        bypassed = [k for k in sd if ".feature_enhancer.w2v_proj." in k]
        assert len(bypassed) == 4 and all(not sd[k].any() for k in bypassed)
    else:
        assert sd["coarse_proj.weight"].shape == (4, 16, 9, 9) and sd["block5.0.conv.weight"].shape == (80, 20, 3, 3)
    _assert_trees_equal(ti.import_sr_checkpoint(arch, {k: t.numpy() for k, t in sd.items()}, srb_nums=2), v)


@pytest.mark.parametrize("arch", list(CASES))
def test_registry_entry_matches_jax(arch):
    """The JAX package's criterion, 4 input channels, no prior; nothing of
    the JAX package is left unported."""
    spec, want = ARCHS[arch], JAX_ARCHS[arch]
    assert (spec.crit, spec.in_channels, spec.uses_prior, spec.trainable) == (
        want.crit, want.in_channels, want.uses_prior, want.trainable) == ("image", 4, False, True)
    assert NOT_PORTED == () and sorted(PORTED_ARCHS) == sorted(JAX_ARCHS)


# ---------------------------------------------------------------- LayerNorm


def test_layer_norm_matches_jax_where_nn_layer_norm_parts():
    """Rows of mean 50 and spread 2 over 16 features: the port's ``LayerNorm``
    (unbiased std, eps on the std) equals the JAX module's at 1e-5, and lies
    over 1 % from ``nn.LayerNorm``'s (biased variance, eps inside the root)
    on the same affine."""
    rng = np.random.default_rng(42)
    x = (50.0 + 2.0 * rng.standard_normal((3, 5, 16))).astype(np.float32)
    a2, b2 = rng.uniform(0.5, 1.5, 16).astype(np.float32), rng.standard_normal(16).astype(np.float32)
    want = np.asarray(jax_transformer.LayerNorm().apply({"params": {"a_2": a2, "b_2": b2}}, x))
    ln = transformer.LayerNorm(16)
    ln.load_state_dict({"a_2": torch.from_numpy(a2), "b_2": torch.from_numpy(b2)})
    with torch.no_grad():
        got = ln(torch.from_numpy(x)).numpy()
        plain = torch.nn.functional.layer_norm(torch.from_numpy(x), (16,), torch.from_numpy(a2),
                                               torch.from_numpy(b2), eps=1e-6).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.abs(plain - want).max() > 1e-2


# ---------------------------------------------------------------- OPT


@functools.lru_cache(maxsize=None)
def _opt():
    """(flax variables, input, JAX logits in eval and in train mode and the
    train-mode statistics) of an OPT model of 64 channels."""
    port = init_torch_defaults_(opt_tpg.OPTModel(37, OPT_CHANNELS), torch.Generator().manual_seed(43))
    v = _random_stats(numpy_tree(ti.import_opt(_np_sd(port))), 43)
    x = np.random.default_rng(44).random((B, 32, 64, 1), dtype=np.float32)
    model = jax_opt_tpg.OPTModel(nclass=37, output_channel=OPT_CHANNELS)

    def outputs(v, x):
        return model.apply(v, x, train=False), model.apply(v, x, train=True, mutable=["batch_stats"])

    ref_eval, (ref_train, mut) = jax.jit(outputs)(v, x)
    return v, x, np.asarray(ref_eval), np.asarray(ref_train), numpy_tree(mut)["batch_stats"]


def test_opt_model_matches_flax():
    """[T, B, 37] logits (T = 64 / 4 + 1) in eval and in train mode, and the
    BatchNorm statistics after the train forward."""
    v, x, ref_eval, ref_train, stats = _opt()
    port = opt_tpg.OPTModel(37, OPT_CHANNELS)
    port.load_state_dict(from_jax.opt_state_dict(v), strict=True)
    with torch.no_grad():
        got = port.eval()(nchw(x)).numpy()
    assert got.shape == ref_eval.shape == (17, B, 37)
    np.testing.assert_allclose(got, ref_eval, atol=1e-5)
    got = port.train()(nchw(x)).detach().numpy()
    np.testing.assert_allclose(got, ref_train, atol=OPT_TRAIN_ATOL)
    new, sd = from_jax.opt_state_dict({"params": v["params"], "batch_stats": stats}), port.state_dict()
    for k in (k for k in new if "running" in k):
        np.testing.assert_allclose(sd[k].numpy(), new[k].numpy(), rtol=1e-4, atol=1e-5, err_msg=k)


def test_opt_state_dict_round_trips_through_import_opt():
    """``opt_state_dict`` then ``import_opt`` gives the variables back exactly;
    the keys are clova's, which the full-width model has too."""
    v, _, _, _, _ = _opt()
    sd = from_jax.opt_state_dict(v)
    _assert_trees_equal(ti.import_opt({k: t.numpy() for k, t in sd.items()}), v)
    full = opt_tpg.OPTModel().state_dict()
    assert sorted(sd) == sorted(full) and all(k.startswith(("FeatureExtraction.ConvNet.", "Prediction.")) for k in sd)
    assert full["Prediction.weight"].shape == (37, 512)
    assert opt_tpg.OPTModel()(torch.zeros(1, 1, 32, 100)).shape == (26, 1, 37)


# ---------------------------------------------------------------- SEED


@pytest.fixture(scope="module")
def seed_case():
    """The JAX SEED (no STN) and the port's on the same sharpened weights
    (tests/torch_recognizers.py's rescaling of ASTER's, less the STN), images
    in [-1, 1] at 32x100, and LR-sized images in [0, 1] for
    ``parse_seed_data``."""
    info = JaxAsterInfo("all")
    eos = info.char2id[info.EOS]
    port = seed.SEEDModelBuilder(info.rec_num_classes, eos, max_len_labels=SEED_MAX_LEN)
    v = seed_variables(port.init_from_(torch.Generator().manual_seed(45)), 45)
    model = jax_seed.SEEDModelBuilder(rec_num_classes=info.rec_num_classes, eos_id=eos, max_len_labels=SEED_MAX_LEN)
    port.load_state_dict(from_jax.seed_state_dict(v), strict=True)
    raw = np.random.default_rng(46).random((SEED_B, 16, 64, 4), dtype=np.float32)
    x = np.random.default_rng(47).uniform(-1.0, 1.0, (SEED_B, 32, 100, 3)).astype(np.float32)
    out = jax.jit(lambda v, x: model.apply(v, x)["output"])(v, x)
    return {"port": port.eval(), "vars": v, "raw": raw, "parsed": np.asarray(jax_seed.parse_seed_data(raw)), "x": x,
            "ids": np.asarray(out["pred_rec"]),
            "embed": np.asarray(out["pred_embed"]), "eos": eos}


def test_parse_seed_data_matches_jax(seed_case):
    """The bicubic resize at tests/test_torch_ops.py's 1e-5, doubled by the
    map to [-1, 1]."""
    got = seed.parse_seed_data(nchw(seed_case["raw"])).numpy().transpose(0, 2, 3, 1)
    assert got.shape == (SEED_B, 32, 100, 3)
    np.testing.assert_allclose(got, seed_case["parsed"], atol=2e-5)


def test_seed_ids_and_best_beam_score_match_jax(seed_case):
    """On the JAX encoder's features and embedding-seeded first state: the
    port's encoder features at tests/test_torch_aster.py's ``FEATURE_ATOL``
    and its first state at 1e-4 of its norm (those features' noise through
    the 12,800-wide ``eEmbed``); the port decoder's best beam score against
    the JAX decoder's teacher-forced score of the same ids, at
    ``SCORE_ATOL``; its ids equal to the JAX beam search's, every selection
    clearing ``MARGIN``; a zero first state gives other ids (the seed
    matters).  Then the whole model on the image: the port's ids are JAX's
    where its own margins clear ``MARGIN``."""
    port, v, x, eos = seed_case["port"], seed_case["vars"], seed_case["x"], seed_case["eos"]
    model = jax_seed.SEEDModelBuilder(rec_num_classes=JaxAsterInfo("all").rec_num_classes, eos_id=eos,
                                      max_len_labels=SEED_MAX_LEN)

    def encode(m, x):
        feats = m.encoder(x)
        return feats, m.embed_fc(m.embeder(feats))

    feats, state0 = (np.array(a) for a in jax.jit(lambda v, x: model.apply(v, x, method=encode))(v, x))
    with torch.no_grad():
        got_feats, got_state0 = port.encode(nchw(x))
        res = port.decoder.beam_search(torch.from_numpy(feats), 5, eos, state0=torch.from_numpy(state0))
        unseeded = port.decoder.beam_search(torch.from_numpy(feats), 5, eos).ids.numpy()
        end_to_end = port.beam_search(nchw(x))
    np.testing.assert_allclose(got_feats.numpy(), feats, atol=FEATURE_ATOL)
    assert _rel_norm(got_state0.numpy(), state0) <= 1e-4
    ids = res.ids.numpy()
    logits, beam = (np.asarray(a) for a in jax.jit(lambda v, f, s, t: model.apply(
        v, f, s, t, method=lambda m, f, s, t: (m.decoder(f, t, state0=s), m.decoder.beam_search(f, 5, eos, state0=s)[0])
    ))(v, feats, state0, ids.astype(np.int32)))
    want_scores = _sequence_score(logits, ids, eos)
    print("SEED beam scores", res.scores.numpy(), "margins", res.margins.numpy(), "end-to-end margins",
          end_to_end.margins.numpy())
    np.testing.assert_allclose(res.scores.numpy(), want_scores, atol=SCORE_ATOL)
    assert (res.margins.numpy() > MARGIN).all()
    np.testing.assert_array_equal(ids, beam)
    assert not np.array_equal(unseeded, ids)
    assert (end_to_end.margins.numpy() > MARGIN).all()
    np.testing.assert_array_equal(end_to_end.ids.numpy(), seed_case["ids"])


def test_seed_state_dict_keys_are_the_original_seed_s(seed_case):
    sd = from_jax.seed_state_dict(seed_case["vars"])
    assert sd["embeder.eEmbed.weight"].shape == (300, 25 * 512)
    assert sd["decoder.decoder.embed_fc.weight"].shape == (512, 300)
    assert sorted(sd) == sorted(seed_case["port"].state_dict())
    assert not any(k.startswith(("stn_head.", "tps.")) for k in sd)
    assert AsterInfo("all").rec_num_classes == JaxAsterInfo("all").rec_num_classes


# ---------------------------------------------------------------- collates


@pytest.fixture(scope="module")
def tz_root(tmp_path_factory):
    return make_textzoom_lmdb(str(tmp_path_factory.mktemp("tz_last")), n=4)


@pytest.mark.parametrize("device_mask", [False, True])
@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("wire", ["float32", "uint8"])
@pytest.mark.parametrize("kind", ["c2f_real", "W2V_real"])
def test_collates_match_jax(tz_root, kind, wire, mask, device_mask):
    """``c2f_real`` and ``W2V_real`` under each wire and mask setting, at HR
    64x32: every array byte-equal to the JAX package's (``coarse`` float at
    LR size with the mask channel whenever ``mask``, ``w2v`` zeros)."""
    cfg = dict(imgH=32, imgW=64, mask=mask, wire_dtype=wire, device_mask=device_mask)
    want = jax_collate.COLLATES[kind]([jax_datasets.TextZoomDataset(tz_root)[i] for i in range(4)],
                                      jax_collate.CollateConfig(**cfg))
    got = collate.COLLATES[kind]([datasets.TextZoomDataset(tz_root)[i] for i in range(4)],
                                 collate.CollateConfig(**cfg))
    assert sorted(got) == sorted(want) and got["labels"] == want["labels"]
    for k, arr in want.items():
        if k != "labels":
            assert got[k].dtype == arr.dtype, k
            np.testing.assert_array_equal(got[k], arr, err_msg=k)
    extra = "coarse" if kind == "c2f_real" else "w2v"
    assert got[extra].shape == ((4, 16, 32, 4 if mask else 3) if extra == "coarse" else (4, 300))


def test_c2f_coarse_is_the_hr_lr_average():
    """A flat HR of 200 and a flat LR of 101 average to 150 (150.5
    truncated), at the LR size."""
    hr, lr = Image.new("RGB", (64, 32), (200,) * 3), Image.new("RGB", (32, 16), (101,) * 3)
    out = collate.collate_c2f_real([(hr, lr, "word")], collate.CollateConfig(imgH=32, imgW=64))
    assert out["coarse"].shape == (1, 16, 32, 3)
    np.testing.assert_array_equal(out["coarse"], np.float32(150) / np.float32(255))
