"""The TextZoom data path of the port held to the JAX package on the CPU: the
LMDB reader and writer both ways, the dataset, the transforms, the collates
byte for byte under every wire and mask setting, the loader's batches over
two epochs, the device-side contour mask, the CTC loss, one ``use_label``
train step on a loader batch, and ``evaluate`` over a val LMDB whose last
batch is short.

LMDBs are written with ``tests/fixtures.py``'s word renderer; model sizes
are those of ``tests/test_torch_train.py`` (2 SRBs, hidden 8, LR 16x32 ->
HR 32x64).  Tolerances are stated at each test."""


import jax
import numpy as np
import pytest
import torch
from PIL import Image

from tests.fixtures import WORDS, _jpeg, make_textzoom_lmdb, render_word
from tests.test_torch_eval import _port_models
from tests.test_torch_train import (LOSS_RTOL, MOMENT_RTOL, PRE_BN_BIAS, STATS_RTOL, _crnn_sd, _port_state, _rel,
                                    _sr_sd)
from tpgsr_tpu.charset import CTC_NUM_CLASSES
from tpgsr_tpu.config import default_args, load_config
from tpgsr_tpu.data import collate as jax_collate
from tpgsr_tpu.data import datasets as jax_datasets
from tpgsr_tpu.data import lmdb as jax_lmdb
from tpgsr_tpu.data import transforms as jax_transforms
from tpgsr_tpu.data.loader import DataLoader as JaxDataLoader
from tpgsr_tpu.models.crnn import CRNN as JaxCRNN
from tpgsr_tpu.models.registry import ARCHS
from tpgsr_tpu.models.tsrn import TSRN_TL as JaxTSRN_TL
from tpgsr_tpu.ops import ctc as jax_ctc
from tpgsr_tpu.ops import image as jax_image
from tpgsr_tpu.train.evaluate import evaluate as jax_evaluate
from tpgsr_tpu.train.state import create_train_state as jax_create_train_state
from tpgsr_tpu.train.step import make_eval_step as jax_make_eval_step
from tpgsr_tpu.train.step import make_train_step as jax_make_train_step
from tpgsr_tpu.train.step import train_wire_keys as jax_train_wire_keys
from tpgsr_tpu.train.trainer import TextSR
from tpgsr_tpu_torch.data import collate, datasets, lmdb, transforms
from tpgsr_tpu_torch.data.loader import EpochBatchSampler, HostArray
from tpgsr_tpu_torch.ops import ctc, image
from tpgsr_tpu_torch.ops.ctc import decode_crnn
from tpgsr_tpu_torch.train import trainer
from tpgsr_tpu_torch.train.evaluate import evaluate
from tpgsr_tpu_torch.train.step import _ensure_mask, make_eval_step, make_train_step, train_wire_keys

ARCH = "tsrn_tl_cascade"
H, W = 16, 32  # LR 16x32 -> HR 32x64, tests/test_torch_train.py's geometry
B = 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _write_textzoom(path, words, seed=0, corrupt=()):
    """A TextZoom LMDB of ``words`` (HR 128x32, LR 64x16 JPEGs, as
    ``make_textzoom_lmdb``); records at the 1-based ``corrupt`` keys hold
    bytes that are no image."""
    items = [(b"num-samples", str(len(words)).encode())]
    for i, word in enumerate(words, 1):
        hr = render_word(word, (128, 32), seed=seed + i)
        items += [(b"label-%09d" % i, word.encode()),
                  (b"image_hr-%09d" % i, b"not a jpeg" if i in corrupt else _jpeg(hr)),
                  (b"image_lr-%09d" % i, _jpeg(hr.resize((64, 16), Image.BICUBIC)))]
    jax_lmdb.write_lmdb(str(path), items)
    return str(path)


@pytest.fixture(scope="module")
def tz_root(tmp_path_factory):
    return make_textzoom_lmdb(str(tmp_path_factory.mktemp("tz")), n=10)


# ---------------------------------------------------------------- LMDB


def test_port_reads_jax_multicommit_lmdb_with_overflow_values(tmp_path):
    """A JAX-written database after two more commits (updates, new keys,
    values on overflow pages at two page sizes' worth): every key, the
    in-order scan, and each meta slot's snapshot as the JAX reader sees it."""
    big = lambda i: (b"img-%03d" % i, bytes(range(256)) * 8 + bytes([i]))  # noqa: E731
    jax_lmdb.write_lmdb(str(tmp_path), [big(i) for i in range(20)] + [(b"k%04d" % i, b"v%d" % i) for i in range(300)],
                        psize=512)
    jax_lmdb.append_lmdb(str(tmp_path), [big(i) for i in range(20, 35)] + [(b"img-000", b"small-now")])
    jax_lmdb.append_lmdb(str(tmp_path), [(b"k%04d" % i, b"late") for i in range(0, 300, 7)])
    for slot in (None, 0, 1):
        with jax_lmdb.LMDBReader(str(tmp_path), meta_slot=slot) as ref, \
                lmdb.LMDBReader(str(tmp_path), meta_slot=slot) as got:
            assert (got.txnid, got.psize, len(got)) == (ref.txnid, ref.psize, len(ref))
            want = list(ref.items())
            assert list(got.items()) == want
            assert all(got.get(k) == v for k, v in want)
            assert got.get(b"absent") is None and got.get(b"") is None
    with lmdb.LMDBReader(str(tmp_path)) as env:
        assert env.txnid == 3 and env.get(b"img-000") == b"small-now" and env.get(b"img-034") == big(34)[1]


@pytest.mark.parametrize("n,value_size,psize", [(0, 10, 4096), (1, 10, 4096), (3000, 40, 4096), (60, 9000, 4096),
                                                (400, 300, 512)])
def test_port_writes_what_the_jax_package_writes(tmp_path, n, value_size, psize):
    """The port's ``write_lmdb`` gives the JAX package's file byte for byte
    (leaf-only, multi-level, overflow pages, a small page size), and the JAX
    reader reads it."""
    rng = np.random.default_rng(n)
    items = [(b"key-%07d" % int(k), rng.integers(0, 256, value_size, dtype=np.uint8).tobytes())
             for k in rng.choice(10**7, n, replace=False)]
    got = lmdb.write_lmdb(str(tmp_path / "port"), items, psize=psize)
    want = jax_lmdb.write_lmdb(str(tmp_path / "jax"), items, psize=psize)
    assert open(got, "rb").read() == open(want, "rb").read()
    with jax_lmdb.LMDBReader(str(tmp_path / "port")) as env:
        assert list(env.items()) == sorted(items)


def test_reader_pickles_as_its_path(tz_root):
    import pickle

    env = lmdb.LMDBReader(tz_root, meta_slot=1)
    env2 = pickle.loads(pickle.dumps(env))
    assert env2.path == env.path and env2.txnid == env.txnid
    assert env2.get(b"label-%09d" % 3) == env.get(b"label-%09d" % 3) == b"text"


# ---------------------------------------------------------------- dataset


def _pixels(item):
    return [np.asarray(x) if isinstance(x, Image.Image) else x for x in item]


@pytest.mark.parametrize("voc_type", ["upper", "lower"])
@pytest.mark.parametrize("cache_images", [False, True])
def test_dataset_items_match_jax(tmp_path, cache_images, voc_type):
    """Items of a set whose 2nd and 4th records are corrupt (each read skips
    forward to the next readable one), two passes with and without the decode
    cache; and ``ConcatDataset`` over two sets."""
    words = ["Hello", "w0rld!", "TeXt", "zo-om", "", "ab12"]
    a = _write_textzoom(tmp_path / "a", words, corrupt=(2, 4))
    b = _write_textzoom(tmp_path / "b", words[:3], seed=9)
    kw = dict(voc_type=voc_type, cache_images=cache_images)
    ref = jax_datasets.ConcatDataset([jax_datasets.TextZoomDataset(d, **kw) for d in (a, b)])
    got = datasets.ConcatDataset([datasets.TextZoomDataset(d, **kw) for d in (a, b)])
    assert len(got) == len(ref) == 9
    for _ in range(2):
        for i in range(len(ref)):
            want, have = _pixels(ref[i]), _pixels(got[i])
            assert have[2] == want[2]
            for x, y in zip(have[:2], want[:2]):
                np.testing.assert_array_equal(x, y)
    with pytest.raises(IndexError):
        datasets.TextZoomDataset(a)[len(words)]


# ---------------------------------------------------------------- transforms


def _image(seed, size):
    return render_word(WORDS[seed % len(WORDS)], size, seed=seed)


@pytest.mark.parametrize("case", ["contour_mask", "normalize", "normalize_mask", "downsample",
                                  "resize", "resize_same_size", "resize_mask", "resize_u8", "resize_u8_mask",
                                  "keep_ratio_narrow", "keep_ratio_narrow_mask", "keep_ratio_wide_mask"])
def test_transforms_match_jax(case):
    """Each transform on the same PIL image, byte for byte."""
    img = _image(3, (96, 40) if "narrow" in case else (128, 32))
    calls = {
        "contour_mask": lambda m: m.contour_mask(img),
        "normalize": lambda m: m.normalize(img),
        "normalize_mask": lambda m: m.normalize(img, mask=True),
        "downsample": lambda m: np.asarray(m.pil_downsample(img, 2)),
        "resize": lambda m: m.resize_normalize(img, (64, 16)),
        "resize_same_size": lambda m: m.resize_normalize(img, (128, 32), mask=True),
        "resize_mask": lambda m: m.resize_normalize(img, (64, 16), mask=True),
        "resize_u8": lambda m: m.resize_normalize(img, (64, 16), as_uint8=True),
        "resize_u8_mask": lambda m: m.resize_normalize(img, (64, 16), mask=True, as_uint8=True),
        "keep_ratio_narrow": lambda m: m.resize_normalize_keep_ratio(img, (128, 32)),
        "keep_ratio_narrow_mask": lambda m: m.resize_normalize_keep_ratio(img, (128, 32), mask=True),
        "keep_ratio_wide_mask": lambda m: m.resize_normalize_keep_ratio(img, (64, 32), mask=True),
    }
    got, want = calls[case](transforms), calls[case](jax_transforms)
    for x, y in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------- collates


def _items(mod, root, n=B):
    ds = mod.TextZoomDataset(root, voc_type="all")
    return [ds[i] for i in range(n)]


def _assert_batches_equal(got, want, tensors=False):
    """Same keys and labels, arrays byte-equal; the loader's arrays are
    tensors, the collates' numpy."""
    assert sorted(got) == sorted(want)
    assert got["labels"] == want["labels"]
    for k, v in want.items():
        if k != "labels":
            assert isinstance(got[k], torch.Tensor if tensors else np.ndarray), k
            arr = got[k].numpy() if tensors else got[k]
            assert arr.dtype == v.dtype, k
            np.testing.assert_array_equal(arr, v, err_msg=k)


@pytest.mark.parametrize("cache", [False, True])
@pytest.mark.parametrize("device_mask", [False, True])
@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("wire", ["float32", "uint8"])
@pytest.mark.parametrize("kind", ["real", "realWTL", "realWTLAMask"])
def test_collates_match_jax(tz_root, kind, wire, mask, device_mask, cache):
    """Each collate under each wire, mask and device_mask setting, with the
    transform cache off and on (twice: the second call reads the cache), at
    the tiny geometry (HR resized 128x32 -> 64x32): arrays byte-equal to the
    JAX package's.  Each side decodes its own images, so neither reads
    the other's cache."""
    cfg = dict(imgH=2 * H, imgW=2 * W, mask=mask, wire_dtype=wire, device_mask=device_mask, cache_transformed=cache)
    ref_items, items = _items(jax_datasets, tz_root), _items(datasets, tz_root)
    for _ in range(2):
        want = jax_collate.COLLATES[kind](ref_items, jax_collate.CollateConfig(**cfg))
        got = collate.COLLATES[kind](items, collate.CollateConfig(**cfg))
        _assert_batches_equal(got, want)
    channels = 4 if mask and not (wire == "uint8" and device_mask) else 3
    assert got["hr"].shape == (B, 2 * H, 2 * W, channels)


@pytest.mark.parametrize("mask", [False, True])
def test_keep_ratio_collate_matches_jax(tz_root, mask):
    cfg = dict(imgH=2 * H, imgW=2 * W, mask=mask, keep_ratio=True, wire_dtype="uint8")
    want = jax_collate.collate_real(_items(jax_datasets, tz_root), jax_collate.CollateConfig(**cfg))
    _assert_batches_equal(collate.collate_real(_items(datasets, tz_root), collate.CollateConfig(**cfg)), want)


def test_collate_labels_match_jax(tmp_path):
    """Labels with the blank fallback (no character in the alphabet), the
    WTL quirk, punctuation dropped from the CTC ids, and truncation at 15."""
    words = ["", "!!", "Hello", "abcdefghijklmnopqrstu", "a-b.c", "ZOOM"]
    root = _write_textzoom(tmp_path, words)
    cfg = dict(imgH=2 * H, imgW=2 * W)
    for kind in ("realWTL", "realWTLAMask"):
        want = jax_collate.COLLATES[kind](_items(jax_datasets, root, len(words)), jax_collate.CollateConfig(**cfg))
        got = collate.COLLATES[kind](_items(datasets, root, len(words)), collate.CollateConfig(**cfg))
        _assert_batches_equal(got, want)
    assert got["weighted_tics"].tolist() == [0, 0, 1, 1, 1, 1]


# ---------------------------------------------------------------- device mask


@pytest.mark.parametrize("case", ["random", "flat", "ties", "two_levels"])
def test_append_contour_mask_u8_matches_jax(case):
    """The port's mask from uint8 RGB equals the JAX package's byte for byte:
    random images, a flat image (every pixel equals the mean), images with
    pixels at the mean exactly, and two gray levels."""
    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, (3, 2 * H, 2 * W, 3), dtype=np.uint8)
    if case == "flat":
        img[:] = 77
    elif case == "ties":  # gray levels 0, 100, 100, 200 (gray of (v, v, v) is v): the mean is 100
        img[:] = np.tile(np.array([0, 100, 100, 200], np.uint8), img.size // 12).reshape(img.shape[:3])[..., None]
    elif case == "two_levels":
        img[..., :] = np.where(rng.random(img.shape[:3]) < 0.5, 10, 240)[..., None].astype(np.uint8)
    got = image.append_contour_mask_u8(torch.from_numpy(img))
    want = np.asarray(jax_image.append_contour_mask_u8(img))
    assert got.dtype == torch.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(image.pil_gray_u8(torch.from_numpy(img)).numpy(),
                                  np.asarray(jax_image.pil_gray_u8(img)))


@pytest.mark.parametrize("kind", ["realWTL", "realWTLAMask"])
def test_device_mask_equals_the_host_collates_mask(tz_root, kind):
    """``_ensure_mask`` on the RGB wire gives the bytes of the collate that
    ships the mask; a batch that has its mask, or a float one, is untouched."""
    items = _items(datasets, tz_root)
    cfg = dict(imgH=2 * H, imgW=2 * W, mask=True, wire_dtype="uint8")
    rgb = collate.COLLATES[kind](items, collate.CollateConfig(device_mask=True, **cfg))
    host = collate.COLLATES[kind](items, collate.CollateConfig(device_mask=False, **cfg))
    for k in ("hr", "lr"):
        rgb_t, host_t = torch.from_numpy(rgb[k]), torch.from_numpy(host[k])
        assert rgb_t.shape[-1] == 3
        torch.testing.assert_close(_ensure_mask(rgb_t, True), host_t, rtol=0, atol=0)
        assert _ensure_mask(rgb_t, False) is rgb_t and _ensure_mask(host_t, True) is host_t


# ---------------------------------------------------------------- loader


def _jax_config(train_dirs, val_dirs, workers=1):
    config = load_config()
    t = config.TRAIN
    t.train_data_dir, t.VAL.val_data_dir = list(train_dirs), list(val_dirs)
    t.width, t.height, t.batch_size, t.workers = 2 * W, 2 * H, B, workers
    t.compute_dtype = "fp32"
    return config


class _JaxData(TextSR):
    """The JAX trainer's data half: ``TextSR`` without its models."""

    def __init__(self, config, args):
        self.config, self.args, self.arch = config, args, args["arch"]
        self.scale_factor = int(config.TRAIN.down_sample_scale)


@pytest.mark.parametrize("n,batch_size,shuffle,drop_last,seed", [
    (10, 4, True, True, 1234), (10, 4, True, False, 0), (10, 3, False, False, 5), (7, 7, True, True, 2),
    (5, 8, True, False, 3), (5, 8, True, True, 3)])
def test_epoch_batch_sampler_matches_jax_batch_indices(n, batch_size, shuffle, drop_last, seed):
    ref = JaxDataLoader(list(range(n)), batch_size, None, shuffle=shuffle, drop_last=drop_last, seed=seed)
    sampler = EpochBatchSampler(n, batch_size, shuffle, drop_last, seed)
    assert len(sampler) == len(ref)
    for epoch in (1, 2, 3):
        ref._epoch = epoch
        assert list(sampler) == [b.tolist() for b in ref._batch_indices()]
        assert sampler.epoch == epoch


@pytest.mark.parametrize("workers", [0, 2])
def test_train_loader_matches_jax_over_two_epochs(tmp_path, workers):
    """``trainer.train_loader`` over two LMDBs (concatenated) against the JAX
    ``TextSR.get_train_data``, with the trainer's defaults (uint8 wire, mask
    on the device, decode cache) and ``--mask``: the same batches, in order,
    byte for byte, over two epochs.  ``workers=2`` runs two persistent
    forkserver worker processes (the only test here that starts any)."""
    dirs = [_write_textzoom(tmp_path / "a", WORDS[:7]), _write_textzoom(tmp_path / "b", WORDS[3:], seed=5)]
    args = default_args(arch=ARCH, mask=True)
    ref_loader = _JaxData(_jax_config(dirs, []), args).get_train_data()
    loader = trainer.train_loader(dirs, ARCH, mask=True, batch_size=B, height=2 * H, width=2 * W, workers=workers,
                                  device="cpu")
    assert len(loader) == len(ref_loader) == 3
    for _ in range(2):
        batches = list(loader)
        want = list(ref_loader)
        assert len(batches) == len(want)
        for got, ref in zip(batches, want):
            _assert_batches_equal(got, ref, tensors=True)
            assert got["hr"].shape == (B, 2 * H, 2 * W, 3) and got["hr"].dtype == torch.uint8
    if workers:
        assert loader._iterator is not None and len(loader._iterator._workers) == workers
        pids = [w.pid for w in loader._iterator._workers]
        list(loader)
        assert [w.pid for w in loader._iterator._workers] == pids  # the pool persists across epochs
        loader._iterator._shutdown_workers()
        assert not any(w.is_alive() for w in loader._iterator._workers)


def test_host_array_pickles_as_its_array_and_takes_torchs_pin_path(monkeypatch):
    """A worker's arrays cross as ``HostArray``: pickled as the array, and
    torch's pin-memory step (run by the ``DataLoader``'s pin thread) calls
    their ``pin_memory``, here a stand-in since pinning needs a card."""
    import pickle

    from torch.utils.data._utils.pin_memory import pin_memory

    arr = np.arange(24, dtype=np.uint8).reshape(2, 3, 4)
    back = pickle.loads(pickle.dumps(HostArray(arr)))
    np.testing.assert_array_equal(back.arr, arr)
    monkeypatch.setattr(HostArray, "pin_memory", lambda self, device=None: torch.from_numpy(self.arr).clone())
    out = pin_memory({"hr": back, "labels": ["a", "b"]})
    assert isinstance(out["hr"], torch.Tensor) and out["labels"] == ["a", "b"]
    np.testing.assert_array_equal(out["hr"].numpy(), arr)


def test_val_loaders_match_jax(tmp_path):
    """``trainer.val_loaders`` against ``TextSR.get_val_data``: each split in
    order, the short last batch kept, byte for byte."""
    dirs = [_write_textzoom(tmp_path / "a", WORDS[:5]), _write_textzoom(tmp_path / "b", WORDS[:7], seed=3)]
    ref = _JaxData(_jax_config([], dirs), default_args(arch=ARCH, mask=True)).get_val_data()
    got = trainer.val_loaders(dirs, ARCH, mask=True, batch_size=B, height=2 * H, width=2 * W, workers=0,
                              device="cpu")
    assert [len(x) for x in got] == [len(x) for x in ref] == [2, 2]
    for loader, ref_loader, sizes in zip(got, ref, ([4, 1], [4, 3])):
        pairs = list(zip(loader, ref_loader))
        assert [len(g["labels"]) for g, _ in pairs] == sizes
        for g, r in pairs:
            _assert_batches_equal(g, r, tensors=True)
            assert "ctc_labels" not in g and "label_vecs" in g


def test_collate_kinds_match_jax():
    from tpgsr_tpu.train.trainer import _collate_kind

    for arch in list(ARCHS):
        for train in (True, False):
            assert trainer.collate_kind(arch, train) == _collate_kind(arch, train), arch


# ---------------------------------------------------------------- CTC


def _ctc_case(words, seed=0, t=26, b=None):
    from tpgsr_tpu.charset import encode_ctc_padded

    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((t, b or len(words), CTC_NUM_CLASSES)).astype(np.float32)
    labels, lengths = encode_ctc_padded(words, max_label_len=15)
    return logits, labels, lengths


def test_ctc_loss_and_gradient_match_jax():
    """Per-sample loss and the gradient of ``mean(loss * weighted_tics)`` with
    respect to the logits, at rtol = atol = 1e-4 (tests/test_ctc.py:39): labels
    of 1 to 15 characters, repeats needing blanks between them, and an empty
    label with weight 0, as the collate's blank fallback gives."""
    words = ["hello", "ab", "supercalifragil", "x", "aabbccdd", "", "zzz", "0123456789abcde"]
    logits, labels, lengths = _ctc_case(words)
    tics = np.array([float(bool(w)) for w in words], np.float32)

    def jax_loss(x):
        return jax.numpy.mean(jax_ctc.ctc_loss(x, labels, lengths) * tics)

    want, want_grad = np.asarray(jax_ctc.ctc_loss(logits, labels, lengths)), np.asarray(jax.grad(jax_loss)(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    got = ctc.ctc_loss(x, torch.from_numpy(labels), torch.from_numpy(lengths))
    torch.mean(got * torch.from_numpy(tics)).backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(x.grad.numpy(), want_grad, rtol=1e-4, atol=1e-4)


def test_ctc_loss_of_a_label_longer_than_its_alignments_departs_from_jax():
    """A label that needs more than T = 26 frames (15 characters, 14 of them
    repeats, so 29 frames with the blanks between): ``nn.CTCLoss`` gives inf
    (the port keeps it: ``zero_infinity`` would change the reference's
    semantics), optax's log-space floor a large finite value (1.0008e5 here).
    The feasible labels beside it agree.  ROADMAP.md queue 3 records this."""
    words = ["aaaaaaaaaaaaaaa", "hello", "abababababababa"]
    logits, labels, lengths = _ctc_case(words, seed=1)
    want = np.asarray(jax_ctc.ctc_loss(logits, labels, lengths))
    got = ctc.ctc_loss(torch.from_numpy(logits), torch.from_numpy(labels), torch.from_numpy(lengths)).numpy()
    assert np.isinf(got[0]) and np.isfinite(want[0]) and want[0] > 1e4
    np.testing.assert_allclose(got[1:], want[1:], rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------- steps on loader batches


@pytest.fixture(scope="module")
def flagship_tiny():
    """The JAX flagship at the tiny size with ``--use_label``: (args, SR
    model, CRNN, state); the state built under jit, as
    tests/test_torch_train.py does."""
    args = default_args(arch=ARCH, STN=True, mask=True, use_distill=True, use_label=True, gradient=True,
                        stu_iter=1, sr_share=True, srb=2, hd_u=8)
    sr_model = JaxTSRN_TL(scale_factor=2, width=2 * W, height=2 * H, stn=True, mask=True, srb_nums=2, hidden_units=8)
    stu_model = JaxCRNN(nclass=CTC_NUM_CLASSES)
    crnn_in = np.zeros((B, 32, 2 * W, 1), np.float32)

    def build(key):
        return jax_create_train_state(
            key, sr_model, (np.zeros((B, H, W, 4), np.float32), np.zeros((B, 1, 26, CTC_NUM_CLASSES), np.float32)),
            n_sr=1, stu_model=stu_model, stu_example_inputs=(crnn_in,), n_stu=1,
            teacher_variables=stu_model.init(jax.random.PRNGKey(1), crnn_in, train=False))

    return args, sr_model, stu_model, jax.jit(build)(jax.random.PRNGKey(0))


def test_use_label_train_step_on_a_loader_batch_matches_jax(tmp_path, flagship_tiny):
    """One flagship ``--use_label`` step on the first batch of the train
    loader (3-channel uint8, the mask appended on the device; one word with
    no label, weight 0) against the JAX step on the JAX loader's batch, at
    tests/test_torch_train.py's first-step tolerances: every metric, Adam's
    moments, BN statistics, parameters within Adam's reach.  Only the wire
    keys reach the step."""
    args, sr_model, stu_model, state = flagship_tiny
    root = _write_textzoom(tmp_path, ["Hello", "!!", "zoom", "abc123", "scene", "tpu"])
    config = _jax_config([root], [])
    ref_batch = next(iter(_JaxData(config, args).get_train_data()))
    batch = next(iter(trainer.train_loader([root], ARCH, mask=True, batch_size=B, height=2 * H, width=2 * W,
                                           workers=0, device="cpu")))
    _assert_batches_equal(batch, ref_batch, tensors=True)
    assert batch["hr"].shape[-1] == 3 and 0.0 in batch["weighted_tics"].tolist()
    assert train_wire_keys(ARCH) == jax_train_wire_keys(ARCH)

    jax_step = jax_make_train_step(ARCH, ARCHS[ARCH], sr_model, stu_model, args, config, donate=False)
    new_state, ref = jax_step(state, {k: v for k, v in ref_batch.items() if k in jax_train_wire_keys(ARCH)})
    port = _port_state(state)
    init = [{k: t.clone() for k, t in m.state_dict().items()} for m in (*port.sr, *port.stu)]
    got = make_train_step(args, width=2 * W, device="cpu")(port, batch)
    assert sorted(got) == sorted(ref)
    for name in got:
        np.testing.assert_allclose(float(got[name]), float(ref[name]), rtol=LOSS_RTOL[0], err_msg=name)
    assert float(ref["loss_distill"]) > 0
    adam = new_state.opt_state[0]
    for j, (kind, m, to_sd) in enumerate((("sr", port.sr[0], _sr_sd), ("stu", port.stu[0], _crnn_sd))):
        stats = (new_state.sr_stats if kind == "sr" else new_state.stu_stats)[0]
        params = (new_state.sr_params if kind == "sr" else new_state.stu_params)[0]
        ref_sd, sd, named = to_sd(params, stats), m.state_dict(), dict(m.named_parameters())
        tracked = [n for n in named if not PRE_BN_BIAS.search(n)]
        for moment, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            ref_m = to_sd(getattr(adam, moment)[kind][0], stats)
            err = _rel([(port.optimizer.state[named[n]][key], ref_m[n]) for n in tracked])
            assert err <= MOMENT_RTOL[0], (kind, moment, err)
        running = [n for n in sd if "running" in n]
        assert _rel([(sd[n], ref_sd[n]) for n in running]) <= STATS_RTOL[0], kind
        for n in named:
            assert float((sd[n] - ref_sd[n]).abs().max()) <= 2.5e-3, (kind, n)
        assert _rel([(sd[n] - init[j][n], ref_sd[n] - init[j][n]) for n in tracked]) <= 0.05, kind


def test_evaluate_over_a_val_loader_matches_jax(tmp_path, flagship_tiny):
    """``evaluate`` over ``val_loaders`` (5 records at batch 2: the last batch
    holds one, unpadded) against the JAX ``evaluate`` over
    ``TextSR.get_val_data`` (which pads it): accuracies and counts exactly,
    PSNR and SSIM at rtol 1e-4.  Records 1 and 3 are relabelled with what the
    teacher reads on their HR, so that the accuracies are not all 0."""
    args, sr_model, stu_model, state = flagship_tiny
    words = ["hello", "world", "text", "zoom", "super"]
    root = _write_textzoom(tmp_path / "v0", words)
    models = _port_models(state)
    step = make_eval_step(args, width=2 * W, device="cpu")
    loader_kw = dict(batch_size=2, height=2 * H, width=2 * W, workers=0, device="cpu")
    reads = [r for b in trainer.val_loaders([root], ARCH, mask=True, **loader_kw)[0]
             for r in decode_crnn(step(models, b)[1]["logits_hr"])]
    words = [reads[i] if i in (0, 2) else w for i, w in enumerate(words)]
    root = _write_textzoom(tmp_path / "v1", words)
    config = _jax_config([], [root])
    config.TRAIN.batch_size = 2
    (ref_loader,) = _JaxData(config, args).get_val_data()
    (loader,) = trainer.val_loaders([root], ARCH, mask=True, **loader_kw)
    assert [len(b["labels"]) for b in loader] == [2, 2, 1]

    jax_step = jax_make_eval_step(ARCH, ARCHS[ARCH], sr_model, stu_model, args, config)
    want = jax_evaluate(jax_step, state, ref_loader)
    got = evaluate(step, models, loader)
    assert sorted(got) == sorted(want)
    assert got["images"] == want["images"] == 5 and got["accuracy_hr"] == want["accuracy_hr"] >= 0.4
    for k, v in want.items():
        if k in ("psnr_avg", "ssim_avg"):
            np.testing.assert_allclose(got[k], v, rtol=1e-4)
        else:
            assert got[k] == v, k
