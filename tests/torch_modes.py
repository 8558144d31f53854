"""Data of the ``--syn``, ``--mixed``, ``--ic15sr`` and ``--random_reso``
tests (tests/test_torch_data_modes.py, tests/test_torch_random_reso.py,
tests/test_torch_modes_trainer.py): a synthetic single-image LMDB of words
rendered at given native sizes, and an IC15 TextSR tree of PGM pairs, each
written with ``tests/fixtures.py``'s word renderer."""

import io
import os

from PIL import Image

from tests.fixtures import WORDS, _jpeg, render_word
from tpgsr_tpu_torch.data.lmdb import write_lmdb


def _png(img: Image.Image) -> bytes:
    buf = io.BytesIO()
    img.save(buf, "PNG")
    return buf.getvalue()


def make_syn_lmdb(path: str, sizes, keys=("image",), seed: int = 0, png: bool = False, labels=None) -> str:
    """A single-image LMDB (``lmdbDataset``'s keys): record i holds
    ``WORDS[i % 10]`` rendered at ``sizes[i]`` (width, height) under
    ``image-%09d`` or ``image_hr-%09d``, the key form cycling through
    ``keys``, and labelled with the word or ``labels[i]``; JPEGs, or PNGs
    with ``png`` (lossless, for the tests that hold images at their native
    size)."""
    encode = _png if png else _jpeg
    items = [(b"num-samples", str(len(sizes)).encode())]
    for i, size in enumerate(sizes, 1):
        word = WORDS[(i - 1) % len(WORDS)]
        key = keys[(i - 1) % len(keys)].encode()
        label = word if labels is None else labels[i - 1]
        items += [(b"label-%09d" % i, label.encode()),
                  (key + b"-%09d" % i, encode(render_word(word, tuple(size), seed=seed + i)))]
    write_lmdb(path, items)
    return path


def make_ic15_tree(root: str, n_train: int = 8, n_test: int = 4, hr_size=(128, 32), seed: int = 0) -> str:
    """An IC15 TextSR tree: ``HRx2/<split>/<name>.pgm`` (grayscale, ``hr_size``),
    ``LRx2/<split>/<name>.pgm`` at half that and ``<split>_GT.txt`` lines
    ``<name>, "<label>"``, for the splits ``train`` and ``test``."""
    lr_size = (hr_size[0] // 2, hr_size[1] // 2)
    for split, n in (("train", n_train), ("test", n_test)):
        for d in ("HRx2", "LRx2"):
            os.makedirs(os.path.join(root, d, split), exist_ok=True)
        lines = []
        for i in range(n):
            name, word = f"word_{split}_{i}", WORDS[(i + (split == "test")) % len(WORDS)]
            hr = render_word(word, hr_size, seed=seed + 1000 * (split == "test") + i).convert("L")
            hr.save(os.path.join(root, "HRx2", split, name + ".pgm"))
            hr.resize(lr_size, Image.BICUBIC).save(os.path.join(root, "LRx2", split, name + ".pgm"))
            lines.append(f'{name}, "{word}"')
        with open(os.path.join(root, f"{split}_GT.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return root
