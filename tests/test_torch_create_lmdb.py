"""The port's dataset builders and its LMDB append held to the JAX package's
on the CPU, byte for byte: ``create_dataset`` and ``create_paired_dataset``
(with and without LR images), ``append_lmdb`` over a seeded series of
commits at two page sizes with overflow values, the reader's freelist and
tree pages, ``crop_word_boxes`` and ``read_voc_annotations``; then the
port's own ``append_paired_dataset`` and its ``python -m`` entry, read back
through ``TextZoomDataset``.  Nothing here compiles a JAX program."""

import os
import random

import numpy as np
import pytest

from tests.torch_suite import port_test_module  # noqa: F401  (the run's compile cache, no TensorBoard)
from tpgsr_tpu.data import create_lmdb as jax_create
from tpgsr_tpu.data import lmdb as jax_lmdb
from tpgsr_tpu_torch.data import create_lmdb, lmdb
from tpgsr_tpu_torch.data.create_lmdb import render_word
from tpgsr_tpu_torch.data.datasets import TextZoomDataset

WORDS = ("scene", "Text", "zoom42", "prior", "a", "super-res")


def _mdb(path) -> bytes:
    with open(os.path.join(path, "data.mdb"), "rb") as f:
        return f.read()


def _images(n: int, seed: int = 0):
    return [render_word(WORDS[i % len(WORDS)], (40 + 12 * i, 16 + 4 * (i % 5)), seed=seed + i) for i in range(n)]


def test_create_dataset_writes_the_jax_package_s_bytes(tmp_path):
    """Single-image records from PIL images and from image files: the same
    ``data.mdb``, the same count."""
    images = _images(5)
    paths = []
    for i, img in enumerate(images[:2]):
        paths.append(str(tmp_path / f"{i}.png"))
        img.save(paths[-1])
    items = images[2:] + paths
    labels = [f"w{i}" for i in range(len(items))]
    n = create_lmdb.create_dataset(str(tmp_path / "port"), items, labels)
    assert n == jax_create.create_dataset(str(tmp_path / "jax"), items, labels) == 5
    assert _mdb(tmp_path / "port") == _mdb(tmp_path / "jax")


@pytest.mark.parametrize("with_lr", [False, True], ids=["bicubic_lr", "given_lr"])
def test_create_paired_dataset_writes_the_jax_package_s_bytes(tmp_path, with_lr):
    """TextZoom records, the LR bicubic at 1/2 (1/3 here with a scale of 3)
    or given: the same ``data.mdb``; the port's dataset reads every pair."""
    hr = _images(7)
    lr = [img.resize((max(1, img.size[0] // 2), max(1, img.size[1] // 2))) for img in hr] if with_lr else None
    kw = {"lr_list": lr, "down_sample_scale": 2 if with_lr else 3}
    n = create_lmdb.create_paired_dataset(str(tmp_path / "port"), hr, list(WORDS) + ["x"], **kw)
    assert n == jax_create.create_paired_dataset(str(tmp_path / "jax"), hr, list(WORDS) + ["x"], **kw) == 7
    assert _mdb(tmp_path / "port") == _mdb(tmp_path / "jax")
    ds = TextZoomDataset(str(tmp_path / "port"), voc_type="all")
    assert len(ds) == 7 and ds[6][2] == "x"


@pytest.mark.parametrize("psize", [4096, 1024])
def test_append_lmdb_commits_the_jax_package_s_bytes(tmp_path, psize):
    """A seeded series of eight commits over a database of 150 keys (new
    keys, overwritten ones, values from 3 bytes to 24 KB: overflow pages at
    both page sizes) by both packages: the same file after every commit;
    the port's reader gives the JAX reader's items, freelist and tree pages
    for both meta slots, the stale slot the previous commit's items."""
    rng = random.Random(psize)
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    items = [(b"key-%05d" % i, rng.randbytes(rng.randint(1, 3000))) for i in range(150)]
    lmdb.write_lmdb(port, items, psize=psize)
    jax_lmdb.write_lmdb(ref, items, psize=psize)
    previous = dict(items)
    for commit in range(8):
        new = [(b"key-%05d" % rng.randint(0, 300), rng.randbytes(rng.choice([3, 40, 700, 5000, 24000])))
               for _ in range(rng.randint(1, 25))]
        lmdb.append_lmdb(port, new)
        jax_lmdb.append_lmdb(ref, new)
        assert _mdb(port) == _mdb(ref), f"commit {commit}"
        now = {**previous, **dict(new)}
        with lmdb.LMDBReader(port) as got, jax_lmdb.LMDBReader(ref) as want:
            assert dict(got.items()) == now and got.txnid == want.txnid == commit + 2
            assert got.freelist() == want.freelist() and got.tree_pages() == want.tree_pages()
            assert got.tree_pages(got.free_root) == want.tree_pages(want.free_root)
        stale = [s for s in (0, 1) if lmdb.LMDBReader(port, meta_slot=s).txnid == commit + 1]
        with lmdb.LMDBReader(port, meta_slot=stale[0]) as old:
            assert dict(old.items()) == previous
        previous = now


def test_append_paired_dataset_adds_a_readable_commit(tmp_path):
    """Pairs appended as a second commit are numbered after the first
    commit's, ``num-samples`` rises, the dataset reads every pair, and the
    first commit's snapshot still reads by its meta slot."""
    split = str(tmp_path / "split")
    first, more = _images(6), _images(4, seed=50)
    create_lmdb.create_paired_dataset(split, first, [f"a{i}" for i in range(6)])
    assert create_lmdb.append_paired_dataset(split, more, [f"b{i}" for i in range(4)]) == 4
    ds = TextZoomDataset(split, voc_type="all")
    assert len(ds) == 10 and [ds[i][2] for i in (0, 5, 6, 9)] == ["a0", "a5", "b0", "b3"]
    assert ds[6][0].size == more[0].size and ds[6][1].size == (more[0].size[0] // 2, more[0].size[1] // 2)
    slots = {s: lmdb.LMDBReader(split, meta_slot=s) for s in (0, 1)}
    old = min(slots.values(), key=lambda r: r.txnid)
    assert old.get(b"num-samples") == b"6" and old.get(b"label-000000007") is None


def test_the_command_line_builds_and_appends_a_split(tmp_path):
    """``python -m tpgsr_tpu_torch.data.create_lmdb`` over a folder and a
    label file (a label with a space, a line without one skipped) writes
    what ``create_paired_dataset`` writes from the same files; ``--append``
    adds a second folder's pairs."""
    folder = tmp_path / "hr"
    folder.mkdir()
    names = []
    for i, img in enumerate(_images(5)):
        names.append(f"{i}.png")
        img.save(folder / names[-1])
    labels = ["scene", "two words", "zoom", "x", "prior"]
    (tmp_path / "labels.txt").write_text("".join(f"{n} {w}\n" for n, w in zip(names, labels)) + "lonely.png\n")
    out = str(tmp_path / "split")
    assert create_lmdb.main(["--images", str(folder), "--labels", str(tmp_path / "labels.txt"), "--out", out]) == 0
    create_lmdb.create_paired_dataset(str(tmp_path / "direct"), [str(folder / n) for n in names], labels)
    assert _mdb(out) == _mdb(tmp_path / "direct")
    (tmp_path / "more.txt").write_text("3.png again\n")
    create_lmdb.main(["--images", str(folder), "--labels", str(tmp_path / "more.txt"), "--out", out, "--append"])
    ds = TextZoomDataset(out, voc_type="all")
    assert len(ds) == 6 and ds[1][2] == "twowords" and ds[5][2] == "again"  # str_filt drops the space
    with lmdb.LMDBReader(out) as env:
        assert env.get(b"label-000000002") == b"two words"


def test_crop_word_boxes_and_voc_annotations_match_jax(tmp_path):
    """Quads as SynthText's [2, 4, N], xyxy boxes, padding,
    a box clipped at the border and one too small: the same crops (pixels
    and words); a VOC file with a box-less object: the same list."""
    image = render_word("a long scene text line", (160, 48), seed=3)
    rng = np.random.default_rng(0)
    quads = np.stack([rng.uniform(-5, 150, (4, 6)), rng.uniform(-5, 45, (4, 6))])  # [2, 4, N]
    quads[:, :, 5] = [[10, 11, 11, 10], [5, 5, 6, 6]]  # under 2 pixels wide: skipped
    xyxy = np.array([[0, 0, 30, 20], [100, 10, 170, 50]])
    words = [f"w{i}" for i in range(6)]
    for boxes, pad, n in ((quads, 0.0, 6), (quads, 0.1, 6), (xyxy, 0.05, 2)):
        got = create_lmdb.crop_word_boxes(image, boxes, words[:n], pad)
        want = jax_create.crop_word_boxes(image, boxes, words[:n], pad)
        assert [w for _, w in got] == [w for _, w in want] and got
        assert all(np.array_equal(np.asarray(g), np.asarray(w)) for (g, _), (w, _) in zip(got, want))
    xml = tmp_path / "a.xml"
    xml.write_text("<annotation><object><name>cat</name><bndbox><xmin>1.6</xmin><ymin>2</ymin><xmax>30</xmax>"
                   "<ymax>40</ymax></bndbox></object><object><name>nobox</name></object>"
                   "<object><name>dog</name><bndbox><xmin>5</xmin><ymin>6</ymin><xmax>7</xmax></bndbox></object>"
                   "</annotation>")
    got = create_lmdb.read_voc_annotations(str(xml))
    assert got == jax_create.read_voc_annotations(str(xml)) == [("cat", (1, 2, 30, 40)), ("dog", (5, 6, 7, 0))]
