"""LMDB dataset builders (counterpart of tpgsr_tpu/data/create_lmdb.py;
reference dataset/create_lmdb.py, crop_800k.py, voc_data.py), written
through the port's own ``write_lmdb`` and ``append_lmdb``:

* ``create_dataset``: single-image records (``image-%09d``, ``label-%09d``,
  ``num-samples``), the synthetic and recognition layout;
* ``create_paired_dataset``: TextZoom's layout (``image_hr-%09d``,
  ``image_lr-%09d``, ``label-%09d``, ``num-samples``), the LR the HR
  downsampled bicubic by ``down_sample_scale`` where no LR is given;
  ``append_paired_dataset`` adds pairs to such a split as a second commit;
* ``render_word``: a synthetic word image, for dry runs where no
  TextZoom is at hand;
* ``crop_word_boxes``: word crops from a scene image's boxes or quads
  (SynthText's ``wordBB``, passed as an array); ``read_voc_annotations``:
  the boxes of a VOC-style XML file.

Images are encoded as JPEG (quality 95), each checked to decode, as the
JAX package writes them: the same images give the same ``data.mdb``, byte
for byte.

    python -m tpgsr_tpu_torch.data.create_lmdb --images hr/ --labels labels.txt --out my_split
    python -m tpgsr_tpu_torch.data.create_lmdb --images hr/ --lr_images lr/ --labels labels.txt --out my_split
    python -m tpgsr_tpu_torch.data.create_lmdb --images more/ --labels more.txt --out my_split --append

builds a paired split from a folder of HR images and a label file, each
line ``<file name> <label>`` (the label may hold spaces; lines without one
are skipped), in the file's order; ``--lr_images`` names a folder of LR
images of the same file names, and ``--append`` adds the pairs to an
existing split.
"""

from __future__ import annotations

import argparse
import io
import os
import sys
import xml.etree.ElementTree as ET
from typing import List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image, ImageDraw

from tpgsr_tpu_torch.data.lmdb import LMDBReader, append_lmdb, write_lmdb


def _encode(img: Image.Image, fmt: str = "JPEG", quality: int = 95) -> bytes:
    buf = io.BytesIO()
    img.convert("RGB").save(buf, fmt, quality=quality)
    return buf.getvalue()


def _check_valid(img_bytes: bytes) -> bool:
    """The reference's ``checkImageIsValid``: the bytes decode to an image
    of positive size."""
    try:
        img = Image.open(io.BytesIO(img_bytes))
        img.verify()
        w, h = img.size
        return w > 0 and h > 0
    except Exception:
        return False


def _load(item) -> Image.Image:
    return item if isinstance(item, Image.Image) else Image.open(item)


def _write(output_path: str, items: List[Tuple[bytes, bytes]], cnt: int) -> int:
    items.append((b"num-samples", str(cnt).encode()))
    os.makedirs(output_path, exist_ok=True)
    write_lmdb(output_path, sorted(items))
    return cnt


def create_dataset(output_path: str, image_list: Sequence, label_list: Sequence[str], check_valid: bool = True) -> int:
    """Write a single-image LMDB from images (PIL images or paths) and their
    labels; returns the number of samples written (those that decode)."""
    if len(image_list) != len(label_list):
        raise ValueError(f"{len(image_list)} images but {len(label_list)} labels")
    items: List[Tuple[bytes, bytes]] = []
    cnt = 0
    for img, label in zip(image_list, label_list):
        data = _encode(_load(img))
        if check_valid and not _check_valid(data):
            continue
        cnt += 1
        items += [(b"image-%09d" % cnt, data), (b"label-%09d" % cnt, label.encode())]
    return _write(output_path, items, cnt)


def _paired_items(hr_list: Sequence, label_list: Sequence[str], lr_list: Optional[Sequence], down_sample_scale: int,
                  check_valid: bool, first: int = 1) -> Tuple[List[Tuple[bytes, bytes]], int]:
    """TextZoom records of the pairs numbered from ``first``, and how many
    were kept."""
    if len(hr_list) != len(label_list) or (lr_list is not None and len(lr_list) != len(hr_list)):
        raise ValueError("hr_list, label_list and lr_list must have one entry a pair")
    items: List[Tuple[bytes, bytes]] = []
    cnt = 0
    for i, (hr, label) in enumerate(zip(hr_list, label_list)):
        hr_img = _load(hr)
        if lr_list is not None:
            lr_img = _load(lr_list[i])
        else:
            size = (max(1, hr_img.size[0] // down_sample_scale), max(1, hr_img.size[1] // down_sample_scale))
            lr_img = hr_img.resize(size, Image.BICUBIC)
        hr_b, lr_b = _encode(hr_img), _encode(lr_img)
        if check_valid and not (_check_valid(hr_b) and _check_valid(lr_b)):
            continue
        k = first + cnt
        items += [(b"image_hr-%09d" % k, hr_b), (b"image_lr-%09d" % k, lr_b), (b"label-%09d" % k, label.encode())]
        cnt += 1
    return items, cnt


def create_paired_dataset(output_path: str, hr_list: Sequence, label_list: Sequence[str],
                          lr_list: Optional[Sequence] = None, down_sample_scale: int = 2,
                          check_valid: bool = True) -> int:
    """Write a TextZoom-layout LMDB; the LR is the HR resized bicubic to
    1/``down_sample_scale`` where ``lr_list`` is None.  Returns the number
    of pairs written."""
    items, cnt = _paired_items(hr_list, label_list, lr_list, down_sample_scale, check_valid)
    return _write(output_path, items, cnt)


def append_paired_dataset(output_path: str, hr_list: Sequence, label_list: Sequence[str],
                          lr_list: Optional[Sequence] = None, down_sample_scale: int = 2,
                          check_valid: bool = True) -> int:
    """Add pairs to the TextZoom-layout LMDB at ``output_path`` as one more
    commit (``append_lmdb``), numbered after its ``num-samples``, which is
    raised; the previous commit stays readable by ``meta_slot``.  Returns the
    number of pairs added."""
    with LMDBReader(output_path) as env:
        n = int(env.get(b"num-samples"))
    items, cnt = _paired_items(hr_list, label_list, lr_list, down_sample_scale, check_valid, first=n + 1)
    append_lmdb(output_path, items + [(b"num-samples", str(n + cnt).encode())])
    return cnt


def render_word(word: str, size, seed: int = 0) -> Image.Image:
    """``word`` in light gray on a dark background of ``size`` (width,
    height), with Gaussian noise; colours and noise drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    bg = rng.integers(0, 80, 3)
    img = Image.new("RGB", size, tuple(int(c) for c in bg))
    ImageDraw.Draw(img).text((2, 2), word, fill=(int(200 + rng.integers(0, 55)),) * 3)
    arr = np.asarray(img, np.float32)
    noise = rng.normal(0, 8, arr.shape)
    return Image.fromarray(np.clip(arr + noise, 0, 255).astype(np.uint8))


def crop_word_boxes(image: Image.Image, word_boxes, words: Sequence[str],
                    pad: float = 0.0) -> List[Tuple[Image.Image, str]]:
    """Word crops of a scene image: ``word_boxes`` holds a quad a word as
    SynthText's ``wordBB`` [2, 4, N], or an xyxy box a word [N, 4];
    each crop is the quad's bounding box widened by ``pad`` of its size and
    clipped to the image, and one narrower or lower than 2 pixels is
    skipped.  Returns [(crop, word)]."""
    out = []
    w, h = image.size
    boxes = np.asarray(word_boxes, np.float64)
    for i, word in enumerate(words):
        b = boxes[..., i] if boxes.ndim == 3 else boxes[i]
        if b.ndim == 2:  # a quad [2, 4]
            x0, x1, y0, y1 = b[0].min(), b[0].max(), b[1].min(), b[1].max()
        else:
            x0, y0, x1, y1 = b
        dx, dy = pad * (x1 - x0), pad * (y1 - y0)
        box = (int(max(0, x0 - dx)), int(max(0, y0 - dy)), int(min(w, x1 + dx)), int(min(h, y1 + dy)))
        if box[2] - box[0] < 2 or box[3] - box[1] < 2:
            continue
        out.append((image.crop(box), word))
    return out


def read_voc_annotations(xml_path: str) -> List[Tuple[str, Tuple[int, int, int, int]]]:
    """A VOC-style XML file -> [(name, (xmin, ymin, xmax, ymax))] of its
    objects that have a box."""
    out = []
    for obj in ET.parse(xml_path).getroot().findall("object"):
        bb = obj.find("bndbox")
        if bb is None:
            continue
        box = tuple(int(float(bb.findtext(k, "0"))) for k in ("xmin", "ymin", "xmax", "ymax"))
        out.append((obj.findtext("name", ""), box))
    return out


def read_label_file(path: str) -> List[Tuple[str, str]]:
    """``<file name> <label>`` lines -> [(file name, label)]; the label is the
    rest of the line after the first run of spaces, lines without one are
    skipped."""
    pairs = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\r\n").split(None, 1)
            if len(parts) == 2:
                pairs.append((parts[0], parts[1]))
    return pairs


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description="Build a TextZoom-layout LMDB split from a folder of images.")
    p.add_argument("--images", required=True, help="folder of the HR images")
    p.add_argument("--labels", required=True, help="label file: '<file name> <label>' a line")
    p.add_argument("--out", required=True, help="the split's directory (data.mdb is written there)")
    p.add_argument("--lr_images", default="", help="folder of the LR images, of the same names (else bicubic)")
    p.add_argument("--down_sample_scale", type=int, default=2, help="HR over LR size where no LR is given")
    p.add_argument("--append", action="store_true", help="add the pairs to an existing split as a new commit")
    args = p.parse_args(argv)
    pairs = read_label_file(args.labels)
    hr = [os.path.join(args.images, name) for name, _ in pairs]
    lr = [os.path.join(args.lr_images, name) for name, _ in pairs] if args.lr_images else None
    build = append_paired_dataset if args.append else create_paired_dataset
    n = build(args.out, hr, [label for _, label in pairs], lr, args.down_sample_scale)
    print(f"{'appended' if args.append else 'wrote'} {n} pairs of {len(pairs)} to {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
