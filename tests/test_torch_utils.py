"""The port's utilities held to the JAX package's on the CPU: the string
metrics and the label converters exactly, over seeded random strings and
lexicons; ``AverageMeter``; the straight-through Gumbel softmax forward and
its gradient against ``jax.grad`` from the same uniform draws (1e-6); the
cost report's parameter count against JAX's ``param_count`` on one SRCNN and
its FLOPs against counts made by hand; the eval step over tiles against the
flat step (the JAX package's bounds: SR 2e-6, outputs 2e-5) with a CRNN,
ASTER and MORAN reading, and ``TextSR``'s val at ``eval_tile`` 4 against
0; the display grids' file names against the JAX package's."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.fixtures import make_textzoom_lmdb
from tests.torch_suite import port_test_module  # noqa: F401  (the run's compile cache, no TensorBoard)
from tpgsr_tpu import charset as jax_charset
from tpgsr_tpu.ops import gumbel as jax_gumbel
from tpgsr_tpu.utils import cost as jax_cost
from tpgsr_tpu.utils import meters as jax_meters
from tpgsr_tpu.utils import metrics as jax_metrics
from tpgsr_tpu.utils import visualize as jax_visualize
from tpgsr_tpu_torch import charset, config
from tpgsr_tpu_torch.models.srcnn import SRCNN
from tpgsr_tpu_torch.ops import gumbel, rnn
from tpgsr_tpu_torch.train import trainer
from tpgsr_tpu_torch.train.step import make_eval_step
from tpgsr_tpu_torch.utils import AverageMeter, cost, metrics, visualize

ALPHABET = "0123456789abcdefghijklmnopqrstuvwxyzABC-$ !"
# the JAX package's bounds for the tiled eval step (tests/test_train.py::test_eval_step_tiled_equivalence)
TILED_SR_ATOL, TILED_OUT_ATOL = 2e-6, 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as the other port modules run: the suite's
    workers share the host's cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _words(rng, n: int, alphabet: str = ALPHABET, longest: int = 12):
    return ["".join(rng.choice(list(alphabet), rng.integers(0, longest + 1))) for _ in range(n)]


def test_string_metrics_match_jax():
    """Edit distances, accuracies and their lexicon variants (files with and
    without a lexicon, near ties between lexicon words) and the sequence
    scores: equal to the JAX package's, value for value."""
    rng = np.random.default_rng(0)
    for trial in range(20):
        preds, targs = _words(rng, 30), _words(rng, 30)
        targs[: trial % 7] = preds[: trial % 7]
        for a, b in zip(preds, targs):
            assert metrics.levenshtein(a, b) == jax_metrics.levenshtein(a, b)
        files = [f"f{i % 5}.jpg" for i in range(30)]
        # a lexicon for every file, or none for the first file (scored 0), or none at all
        lex = [{f: _words(rng, 6, "abcdeABCDE", 5) for f in sorted(set(files)) if f != files[0] or k != trial % 3}
               for k in range(3)]
        if trial % 4 == 0:
            lex[1] = {}
        for port_fn, jax_fn in ((metrics.accuracy_with_lexicon, jax_metrics.accuracy_with_lexicon),
                                (metrics.edit_distance_with_lexicon, jax_metrics.edit_distance_with_lexicon)):
            assert port_fn(preds, targs, *lex, file_names=files) == jax_fn(preds, targs, *lex, file_names=files)
            assert port_fn(preds, targs) == jax_fn(preds, targs)
        assert metrics.accuracy(preds, targs) == jax_metrics.accuracy(preds, targs)
        assert metrics.edit_distance(preds, targs) == jax_metrics.edit_distance(preds, targs)
        scores = rng.random((30, 16)).astype(np.float32)
        scores[0, 0] = 0.0
        assert metrics.rec_post_process(preds, scores, 10) == jax_metrics.rec_post_process(preds, scores, 10)
    assert metrics.accuracy([], []) == jax_metrics.accuracy([], []) == 0.0


def test_label_converters_match_jax():
    """``CTCLabelConverter`` (encode one word and a list; decode raw and
    greedy), ``encode_ctc_padded`` (upper case, characters outside the
    alphabet, words longer than the row, empty words),
    ``AttentionLabelConverter`` with both alphabet forms and
    ``labels2strs``: the JAX package's arrays and strings, dtypes included."""
    rng = np.random.default_rng(1)
    lower = charset.CTC_ALPHABET
    words = _words(rng, 40, lower) + ["", "x"]
    port, ref = charset.CTCLabelConverter(), jax_charset.CTCLabelConverter()
    for text in (words, words[3], ""):
        for got, want in zip(port.encode(text), ref.encode(text)):
            assert got.dtype == want.dtype and np.array_equal(got, want)
    for _ in range(30):
        ids = rng.integers(0, 37, rng.integers(0, 20))
        n = int(rng.integers(0, 22))
        for raw in (False, True):
            assert port.decode(ids, n, raw) == ref.decode(ids, n, raw)
    mixed = _words(rng, 40)
    for got, want in zip(charset.encode_ctc_padded(mixed, 7), jax_charset.encode_ctc_padded(mixed, 7)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    for alphabet, sep in (("0123456789abcdefghijklmnopqrstuvwxyz$", ":"), ("0:1:2:a:b:c:$", ":")):
        port_att, ref_att = charset.AttentionLabelConverter(alphabet, sep), jax_charset.AttentionLabelConverter(
            alphabet, sep)
        for text in (mixed, mixed[0]):
            got, want = port_att.encode(text), ref_att.encode(text)
            assert all(g.dtype == w.dtype and np.array_equal(g, w) for g, w in zip(got, want))
            assert port_att.decode(*got) == ref_att.decode(*want)
    info = charset.AsterInfo("all")
    labels = rng.integers(0, info.rec_num_classes, (6, 9))
    labels[2, 4] = labels[4, 0] = info.char2id["EOS"]
    assert (charset.labels2strs(labels, info.id2char, info.char2id)
            == jax_charset.labels2strs(labels, info.id2char, info.char2id))
    assert charset.labels2strs(labels[0], info.id2char, info.char2id) == jax_charset.labels2strs(
        labels[0], info.id2char, info.char2id)


def test_average_meter_matches_jax():
    port, ref = AverageMeter(), jax_meters.AverageMeter()
    for v, n in ((1.5, 1), (2.0, 4), (-3.0, 2), (0.25, 7)):
        port.update(v, n)
        ref.update(v, n)
        assert vars(port) == vars(ref)
    port.reset()
    assert port.count == 0 and port.avg == 0.0


def test_display_names_fit_a_file_name(tmp_path):
    """A grid's file name is the JAX package's where that fits 255 bytes; a
    recognizer reading to its 100-character limit (an untrained ASTER) gets
    each part cut to 80 bytes, and ``test_display`` writes it."""
    rng = np.random.default_rng(5)
    for lr, sr, label in zip(_words(rng, 20), _words(rng, 20), _words(rng, 20)):
        assert visualize._name(lr + "/", sr, label) == jax_visualize._safe(f"{lr}/_{sr}_{label}_.png")
    long = "a" * 100
    name = visualize._name("w" * 100, long, long)
    assert len(name.encode()) <= visualize.NAME_MAX and name == f"{'w' * 80}_{'a' * 80}_{'a' * 80}_.png"
    img = np.zeros((1, 8, 16, 3), np.float32)
    assert visualize.test_display(img, img, img, ["w" * 100], [long], [long], charset.str_filt, "v",
                                  out_root=str(tmp_path)) == 1
    assert os.listdir(tmp_path / "v") == [name]


def test_gumbel_softmax_matches_jax_forward_and_gradient():
    """From the JAX package's ``jax.random.uniform(key, shape)``: the noise,
    the soft sample and the straight-through sample equal JAX's, and the
    gradient of a weighted sum through the straight-through sample equals
    ``jax.grad``'s, at 1e-6; with a ``torch.Generator`` the sample is one
    hot and the same for the same seed."""
    rng = np.random.default_rng(2)
    logits = (3 * rng.standard_normal((4, 26, 37))).astype(np.float32)
    weights = rng.standard_normal((4, 26, 37)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    u = torch.from_numpy(np.array(jax.random.uniform(key, logits.shape)))
    np.testing.assert_allclose(gumbel.sample_gumbel(logits.shape, u=u).numpy(),
                               np.asarray(jax_gumbel.sample_gumbel(key, logits.shape)), atol=1e-6)
    for temp in (0.8, 2.0):
        np.testing.assert_allclose(gumbel.gumbel_softmax_sample(torch.from_numpy(logits), temp, u=u).numpy(),
                                   np.asarray(jax_gumbel.gumbel_softmax_sample(key, jnp.asarray(logits), temp)),
                                   atol=1e-6)
        x = torch.from_numpy(logits).requires_grad_(True)
        y = gumbel.gumbel_softmax(x, temp, u=u)
        (y * torch.from_numpy(weights)).sum().backward()
        want_y = jax_gumbel.gumbel_softmax(key, jnp.asarray(logits), temp)
        want_g = jax.grad(lambda lg: (jax_gumbel.gumbel_softmax(key, lg, temp) * weights).sum())(jnp.asarray(logits))
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), atol=1e-6)
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), atol=1e-6)
    draws = [gumbel.gumbel_softmax(torch.from_numpy(logits), generator=torch.Generator().manual_seed(9))
             for _ in range(2)]
    assert torch.equal(draws[0], draws[1]) and torch.equal(draws[0].sum(-1), torch.ones(4, 26))


def test_param_count_matches_jax_on_srcnn():
    """tests/test_utils_data.py's SRCNN (scale 2, 3 planes, no STN, 32x64):
    the port's count equals JAX's ``param_count`` of its params (their
    shapes, traced without a compile)."""
    x = np.zeros((1, 16, 32, 3), np.float32)
    from tpgsr_tpu.models.srcnn import SRCNN as JaxSRCNN

    variables = jax.eval_shape(lambda: JaxSRCNN(2, 3, False, 32, 64).init(jax.random.PRNGKey(0), x, train=False))
    assert cost.param_count(SRCNN(2, 3, False, 32, 64)) == jax_cost.param_count(variables["params"])


def test_flops_are_counted_as_by_hand(capsys):
    """A convolution then a linear layer: 2 FLOPs a multiply-add of each,
    the biases not counted; K1's plain recurrence on the CPU counts its
    2·T·2N·3H·H, what the card adds for the kernel; the report's line."""
    b, h, w = 2, 6, 10
    model = torch.nn.Sequential(torch.nn.Conv2d(3, 8, 3, padding=1), torch.nn.ReLU(), torch.nn.Flatten(),
                                torch.nn.Linear(8 * h * w, 5))
    by_hand = 2 * b * 8 * h * w * 3 * 9 + 2 * b * 8 * h * w * 5
    model.train()
    rep = cost.model_cost_report(model, (torch.zeros(b, 3, h, w),), "two layers")
    assert rep == {"flops": by_hand, "k1_flops": 0.0, "params": 8 * 3 * 9 + 8 + 8 * h * w * 5 + 5}
    assert model.training
    assert capsys.readouterr().out == f"::::: two layers: {by_hand / 1e9:.4f} GFLOPs, {rep['params'] / 1e6:.4f} M params\n"
    n, t, hid = 5, 7, 8
    args = (torch.randn(n, t, 6 * hid), torch.randn(2, 3 * hid, hid), torch.randn(2, 3 * hid))
    assert cost.cost_analysis(rnn.bigru_recurrence, *args)["flops"] == cost.recurrence_flops(n, t, hid) == 2 * t * 2 * n * 3 * hid * hid


def _small_config(db, batch: int):
    cfg = config.load_config()
    t = cfg.TRAIN
    t.train_data_dir, t.VAL.val_data_dir = [db], [db]
    t.width, t.height, t.batch_size, t.workers, t.compute_dtype = 64, 32, batch, 0, "fp32"
    return cfg


ARGS = dict(arch="tsrn_tl_cascade", STN=True, mask=True, use_distill=True, gradient=True, sr_share=True, stu_iter=1,
            srb=2, hd_u=8)


def test_textsr_prints_the_cost_report_when_asked(tmp_path, monkeypatch, capsys):
    """Under TPGSR_COST_REPORT ``init_state`` prints the SR model's line at
    TRAIN.batch_size and the TP CRNN's at batch 1, with their parameter
    counts; without it nothing."""
    db = make_textzoom_lmdb(str(tmp_path / "tz"), n=4)
    mission = trainer.TextSR(_small_config(db, 4), config.default_args(**ARGS), device="cpu")
    mission.init_state()
    assert "::::" not in capsys.readouterr().out
    monkeypatch.setenv("TPGSR_COST_REPORT", "1")
    state = mission.init_state()
    lines = [line for line in capsys.readouterr().out.splitlines() if line.startswith(":::::")]
    assert len(lines) == 2
    assert lines[0].startswith("::::: SR:tsrn_tl_cascade: ") and lines[1].startswith("::::: TP:CRNN: ")
    assert lines[0].endswith(f"{cost.param_count(state.sr[0]) / 1e6:.4f} M params")
    assert lines[1].endswith(f"{cost.param_count(state.teacher) / 1e6:.4f} M params")


@pytest.fixture(scope="module")
def eval_setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiles")
    db = make_textzoom_lmdb(str(root / "tz"), n=8)
    cfg = _small_config(db, 8)
    mission = trainer.TextSR(cfg, config.default_args(**ARGS), device="cpu")
    state = mission.init_state()
    (loader,) = mission.get_val_data()
    return cfg, state, next(iter(loader)), db


@pytest.mark.parametrize("kind", ["CRNN", "ASTER", "MORAN"])
def test_tiled_eval_equals_flat(eval_setup, kind):
    """Batch 8 in tiles of 4 (and for the CRNN of 3, which does not divide
    it: flat) against the flat step: SR at 2e-6, every output at 2e-5 (ids
    exactly), a CRNN's time-major logits joined along their batch axis."""
    cfg, state, batch, _ = eval_setup
    rec = None if kind == "CRNN" else trainer.eval_recognizer(kind, cfg, device="cpu")
    models = trainer.TextSR._eval_models(state, rec)
    flat_step = make_eval_step(ARGS, 64, device="cpu", tile=0)
    sr_f, outs_f = flat_step(models, batch)
    for tile in (4, 3) if kind == "CRNN" else (4,):
        sr_t, outs_t = make_eval_step(ARGS, 64, device="cpu", tile=tile)(models, batch)
        np.testing.assert_allclose(sr_t.numpy(), sr_f.numpy(), atol=TILED_SR_ATOL)
        assert set(outs_t) == set(outs_f) and outs_t["logits_sr"].shape == outs_f["logits_sr"].shape
        for k, v in outs_f.items():
            if v.dtype.is_floating_point:
                np.testing.assert_allclose(outs_t[k].numpy(), v.numpy(), atol=TILED_OUT_ATOL, err_msg=k)
            else:
                assert torch.equal(outs_t[k], v), k


def test_textsr_val_at_eval_tile_4_equals_flat(eval_setup, tmp_path, monkeypatch):
    """``TextSR``'s val over the 8-pair split at batch 8 with TRAIN.eval_tile 4
    gives the metric dict of eval_tile 0 (PSNR and SSIM at 1e-4, the rest
    equal); a missing key means 0, flat (the JAX package tiles at 64)."""
    cfg, _, _, _ = eval_setup
    monkeypatch.chdir(tmp_path)
    tiles = []
    monkeypatch.setattr(trainer, "make_eval_step", lambda *a, **k: tiles.append(k["tile"]) or make_eval_step(*a, **k))
    mds = {}
    for tile in (0, 4, None):
        c = config.AttrDict.deep(cfg)
        if tile is None:
            c.TRAIN.pop("eval_tile", None)
        else:
            c.TRAIN.eval_tile = tile
        mission = trainer.TextSR(c, config.default_args(go_test=True, vis_dir=f"t{tile}", **ARGS), device="cpu")
        mds[tile] = mission.train()
    assert tiles == [0, 4, 0]
    for tile in (4, None):
        (split,) = mds[tile]
        for k, v in mds[0][split].items():
            if k in ("psnr_avg", "ssim_avg"):
                np.testing.assert_allclose(mds[tile][split][k], v, rtol=1e-4, err_msg=k)
            else:
                assert mds[tile][split][k] == v, k
