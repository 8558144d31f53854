"""The data of ``--syn``, ``--mixed``, ``--ic15sr`` and ``--random_reso``, and
the rest of the JAX package's ``data/`` that no flag reaches, held to the JAX
package byte for byte on the CPU (numpy and PIL only, no JAX compile):

* ``SingleImageLMDB`` over both key forms, and ``SingleImageLMDBIC15`` with
  its aliases;
* ``MixedLMDB``'s HR-as-LR coin over two passes in a fixed order, with the
  decode cache on and off, and none under ``test``;
* ``IC15TextSRDataset`` over a rendered PGM tree, both splits;
* ``TextZoomWithMask``, ``SVTDataset`` and ``ImageFolderDataset``;
* ``collate_syn`` and ``collate_syn_random_reso`` with and without the mask,
  ``collate_real_wtl_withcrop`` from the same ``rng``;
* ``edge_weight_mask`` with its parts, ``degrade_image`` (deterministic),
  ``resize_normalize_random_crop``, and ``random_reso.laplacian_var`` (the
  reference's sharpness probe) on the native-size items;
* the port's train and val loaders of each flag against the JAX
  ``TextSR``'s first batches (the mixed train loader's coin aside: the JAX
  loader reads items on two threads that share it)."""

import numpy as np
import pytest
from PIL import Image

from tests.fixtures import WORDS, make_textzoom_lmdb, render_word
from tests.torch_modes import make_ic15_tree, make_syn_lmdb
from tests.torch_suite import port_test_module  # noqa: F401  (the run's compile cache, no TensorBoard)
from tpgsr_tpu import config as jax_config
from tpgsr_tpu.data import collate as jax_collate
from tpgsr_tpu.data import datasets as jax_datasets
from tpgsr_tpu.data import degradation as jax_degradation
from tpgsr_tpu.data import edges as jax_edges
from tpgsr_tpu.data import transforms as jax_transforms
from tpgsr_tpu.train import random_reso as jax_random_reso
from tpgsr_tpu.train.trainer import TextSR as JaxTextSR
from tpgsr_tpu_torch import config
from tpgsr_tpu_torch.data import collate, datasets, degradation, edges, transforms
from tpgsr_tpu_torch.train import random_reso, trainer

# native sizes (width, height): tall and short, odd widths, one under 16 rows
SYN_SIZES = [(100, 32), (57, 20), (64, 14), (131, 40), (24, 12), (320, 48), (75, 17), (128, 32)]


def _same(got, want):
    """Items, batches and their parts equal byte for byte: PIL images by
    mode, size and pixels, arrays by dtype, shape and bytes."""
    if isinstance(want, Image.Image):
        assert isinstance(got, Image.Image) and got.mode == want.mode and got.size == want.size
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    else:
        assert got == want


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    root = tmp_path_factory.mktemp("modes")
    return {
        "syn": make_syn_lmdb(str(root / "syn"), SYN_SIZES, keys=("image", "image_hr")),
        "tz": make_textzoom_lmdb(str(root / "tz"), n=12),
        "ic15": make_ic15_tree(str(root / "ic15")),
    }


@pytest.mark.parametrize("voc_type", ["upper", "all"])
def test_single_image_lmdb_reads_both_key_forms(roots, voc_type):
    got, want = datasets.SingleImageLMDB(roots["syn"], voc_type), jax_datasets.SingleImageLMDB(roots["syn"], voc_type)
    assert len(got) == len(want) == len(SYN_SIZES)
    for i in range(len(want)):
        _same(got[i], want[i])
        assert got[i][0].size == SYN_SIZES[i]
    for cls in ("SingleImageLMDBIC15", "COCOTextLMDB", "IIITLMDB", "BadSetLMDB"):
        pair, ref = getattr(datasets, cls)(roots["syn"], voc_type), getattr(jax_datasets, cls)(roots["syn"], voc_type)
        for i in (0, 3):
            item = pair[i]
            _same(item, ref[i])
            assert item[0] is item[1]


@pytest.mark.parametrize("cache_images", [False, True])
def test_mixed_lmdb_flips_as_jax(roots, cache_images):
    """Two passes over the pairs in one fixed order: the same items, LR as
    the HR (the same object) where JAX's is; no flip under ``test``."""
    got = datasets.MixedLMDB(roots["tz"], voc_type="all", cache_images=cache_images)
    want = jax_datasets.MixedLMDB(roots["tz"], voc_type="all", cache_images=cache_images)
    order = list(np.random.default_rng(3).permutation(len(want))) * 2
    flips = []
    for i in order:
        g, w = got[int(i)], want[int(i)]
        _same(g, w)
        assert (g[1] is g[0]) == (w[1] is w[0])
        flips.append(w[1] is w[0])
    assert 0 < sum(flips) < len(flips)
    tested = datasets.MixedLMDB(roots["tz"], voc_type="all", test=True, cache_images=cache_images)
    plain = datasets.TextZoomDataset(roots["tz"], voc_type="all")
    for i in order[:6]:
        _same(tested[int(i)], plain[int(i)])


@pytest.mark.parametrize("test", [False, True])
def test_ic15_textsr_dataset_reads_the_pgm_tree(roots, test):
    got = datasets.IC15TextSRDataset(roots["ic15"], voc_type="all", test=test)
    want = jax_datasets.IC15TextSRDataset(roots["ic15"], voc_type="all", test=test)
    assert len(got) == len(want) == (4 if test else 8)
    for i in range(len(want)):
        _same(got[i], want[i])
        assert got[i][0].mode == "RGB" and got[i][0].size == (128, 32) and got[i][1].size == (64, 16)


def test_textzoom_with_mask_svt_and_image_folder_match_jax(roots, tmp_path):
    for i in (0, 5):
        _same(datasets.TextZoomWithMask(roots["tz"])[i], jax_datasets.TextZoomWithMask(roots["tz"])[i])
    svt = tmp_path / "svt"
    for split in ("svt_train", "svt_test"):
        (svt / split / "IMG").mkdir(parents=True)
        (svt / split / "label").mkdir()
        for i, word in enumerate(WORDS[:3]):
            if not (split == "svt_test" and i == 1):  # a label without its image: skipped forward
                render_word(word, (90 + 7 * i, 30), seed=i).save(svt / split / "IMG" / f"{i:03d}.jpg", quality=92)
            (svt / split / "label" / f"{i:03d}.txt").write_text(word.upper() + "\n")
    for test in (False, True):
        got, want = datasets.SVTDataset(str(svt), test=test), jax_datasets.SVTDataset(str(svt), test=test)
        assert len(got) == len(want) == 3
        for i in range(2):
            _same(got[i], want[i])
    folder = tmp_path / "folder"
    folder.mkdir()
    for i, ext in enumerate((".png", ".JPG", ".bmp", ".txt")):
        render_word(WORDS[i], (60, 20), seed=i).save(folder / f"img{i}{ext}", "PNG" if ext == ".txt" else None)
    got, want = datasets.ImageFolderDataset(str(folder)), jax_datasets.ImageFolderDataset(str(folder))
    assert got.files == want.files and len(got) == 3
    for i in range(3):
        _same(got[i], want[i])


@pytest.mark.parametrize("mask", [False, True])
def test_syn_collates_match_jax(roots, mask):
    """``collate_syn`` (float32 with the mask whatever the wire) and
    ``collate_syn_random_reso`` (native-size lists, HR its bicubic x2) over
    items of every native size, as the train and val loaders feed them."""
    items = [datasets.SingleImageLMDB(roots["syn"], "all")[i] for i in range(len(SYN_SIZES))]
    for wire in ("uint8", "float32"):
        cfg = collate.CollateConfig(imgH=32, imgW=128, mask=mask, wire_dtype=wire, device_mask=True)
        jax_cfg = jax_collate.CollateConfig(imgH=32, imgW=128, mask=mask, wire_dtype=wire, device_mask=True)
        got, want = collate.COLLATES["syn"](items, cfg), jax_collate.COLLATES["syn"](items, jax_cfg)
        _same(got, want)
        assert got["hr"].dtype == np.float32 and got["hr"].shape == (len(items), 32, 128, 3 + mask)
        got = collate.COLLATES["syn_random_reso"](items, cfg)
        _same(got, jax_collate.COLLATES["syn_random_reso"](items, jax_cfg))
        for (w, h), lr, hr in zip(SYN_SIZES, got["lr_list"], got["hr_list"]):
            assert lr.shape == (1, h, w, 3 + mask) and hr.shape == (1, 2 * h, 2 * w, 3 + mask)


@pytest.mark.parametrize("wire,mask", [("float32", False), ("uint8", True)])
def test_withcrop_collate_matches_jax_from_the_same_rng(roots, wire, mask):
    items = [datasets.TextZoomDataset(roots["tz"], "all")[i] for i in range(8)]
    cfg = collate.CollateConfig(mask=mask, wire_dtype=wire)
    jax_cfg = jax_collate.CollateConfig(mask=mask, wire_dtype=wire)
    got = collate.collate_real_wtl_withcrop(items, cfg, rng=np.random.default_rng(5))
    _same(got, jax_collate.collate_real_wtl_withcrop(items, jax_cfg, rng=np.random.default_rng(5)))
    _same(collate.COLLATES["realWTL_withcrop"](items, cfg),
          jax_collate.COLLATES["realWTL_withcrop"](items, jax_cfg))
    for word in ("a", "ab", "hello", "x" * 30, "a-b?"):
        _same(collate._dash_padded_onehot(word, 26), jax_collate._dash_padded_onehot(word, 26))
    assert sorted(collate.COLLATES) == sorted(jax_collate.COLLATES)


def test_edges_degradation_and_random_crop_match_jax(roots):
    img = datasets.TextZoomDataset(roots["tz"])[2][0]
    gray = np.asarray(img.convert("L"))
    _same(edges.canny(gray), jax_edges.canny(gray))
    _same(edges.dilate(edges.canny(gray)), jax_edges.dilate(jax_edges.canny(gray)))
    _same(edges.gaussian_blur(gray), jax_edges.gaussian_blur(gray))
    weights = edges.edge_weight_mask(img)
    _same(weights, jax_edges.edge_weight_mask(img))
    assert weights.dtype == np.float64 and 0.4 <= weights.min() and weights.max() <= 0.9 and weights.max() > 0.4
    _same(degradation.fspecial_gaussian(15, 1.0), jax_degradation.fspecial_gaussian(15, 1.0))
    for noise in (0.0, 5.0):
        got = degradation.degrade_image(img, degradation.DEFAULT_BLUR_KERNEL, noise, deterministic=True)
        _same(got, jax_degradation.degrade_image(img, jax_degradation.DEFAULT_BLUR_KERNEL, noise, deterministic=True))
    for size, interval in (((64, 16), None), ((64, 16), (0, 5)), ((128, 32), None)):
        for mask in (False, True):
            small = img.resize((24, 16))
            for im in (img, small):
                _same(transforms.resize_normalize_random_crop(im, size, mask, interval),
                      jax_transforms.resize_normalize_random_crop(im, size, mask, interval))


def test_laplacian_var_matches_jax(roots):
    lrs = collate.collate_syn_random_reso([datasets.SingleImageLMDB(roots["syn"], "all")[i] for i in range(4)],
                                          collate.CollateConfig(mask=True))["lr_list"]
    for lr in lrs:
        assert random_reso.laplacian_var(lr[0]) == jax_random_reso.laplacian_var(lr[0]) > 0


def _first_batches(port_mission, jax_mission):
    loaders = ((port_mission.get_train_data(), jax_mission.get_train_data()),
               (port_mission.get_val_data()[0], jax_mission.get_val_data()[0]))
    return [(next(iter(p)), next(iter(j))) for p, j in loaders]


def _as_numpy(batch):
    return {k: v.numpy() if hasattr(v, "numpy") else v for k, v in batch.items()}


@pytest.mark.parametrize("flags,dirs", [
    ({"syn": True}, ("syn", "syn")),
    ({"mixed": True}, ("tz", "tz")),
    ({"ic15sr": True}, ("ic15", "ic15")),
    ({"random_reso": True}, ("tz", "tz")),
    ({"syn": True, "random_reso": True, "go_test": True}, ("syn", "syn")),
], ids=["syn", "mixed", "ic15sr", "random_reso", "syn_random_reso"])
def test_loaders_of_each_flag_match_jax(roots, flags, dirs):
    """The port's ``TextSR`` loaders (``workers`` 0) and the JAX ``TextSR``'s,
    on the packaged YAML at batch 4 with the flagship's flags: the first
    train and val batches equal, lists and wire included (the mixed train
    batch by its HR and labels, its LRs following each loader's coin)."""
    cfgs = []
    for pkg in (config, jax_config):
        cfg = pkg.load_config()
        t = cfg.TRAIN
        t.train_data_dir, t.VAL.val_data_dir = [roots[dirs[0]]], [roots[dirs[1]]]
        t.batch_size, t.workers = 4, 0
        cfgs.append(cfg)
    args = dict(arch="tsrn_tl_cascade", STN=True, mask=True, use_distill=True, gradient=True, sr_share=True,
                stu_iter=1, **flags)
    port = trainer.TextSR(cfgs[0], config.default_args(**args), device="cpu")
    jax_mission = JaxTextSR(cfgs[1], jax_config.default_args(**args))
    (train, jax_train), (val, jax_val) = _first_batches(port, jax_mission)
    train, val = _as_numpy(train), _as_numpy(val)
    if flags.get("mixed"):
        train = {k: v for k, v in train.items() if k != "lr"}
        jax_train = {k: v for k, v in jax_train.items() if k != "lr"}
    _same(train, jax_train)
    _same(val, jax_val)
    if flags.get("random_reso"):
        key = "lr_list" if flags.get("syn") else "lr"
        assert val[key][0].dtype == np.float32 and val[key][0].shape[-1] == 4


def test_mixed_loader_with_two_workers_matches_jax_over_two_epochs(roots):
    """At ``TRAIN.workers`` 2 the port's ``--mixed`` train loader (two
    ``MixedLMDB`` parts concatenated) gives the JAX ``TextSR``'s
    ``DataLoader(num_workers=2)`` batches, HR-as-LR coin included, over two
    epochs: batch i read by worker i % 2, each worker's copy reseeded every
    epoch with seed + epoch * 100003 + worker."""
    cfgs = []
    for pkg in (config, jax_config):
        cfg = pkg.load_config()
        t = cfg.TRAIN
        t.train_data_dir, t.VAL.val_data_dir = [roots["tz"], roots["tz"]], [roots["tz"]]
        t.batch_size, t.workers = 4, 2
        cfgs.append(cfg)
    args = dict(arch="tsrn_tl_cascade", STN=True, mask=True, use_distill=True, gradient=True, sr_share=True,
                stu_iter=1, mixed=True)
    port = trainer.TextSR(cfgs[0], config.default_args(**args), device="cpu").get_train_data()
    ref = JaxTextSR(cfgs[1], jax_config.default_args(**args)).get_train_data()
    try:
        for _ in range(2):
            got, want = [_as_numpy(b) for b in port], list(ref)
            assert len(got) == len(want) == 6
            _same(got, want)
    finally:
        ref.shutdown()
