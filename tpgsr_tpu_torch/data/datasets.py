"""The datasets of the data flags (counterpart of tpgsr_tpu/data/datasets.py).

* ``TextZoomDataset`` (:37) is the reference ``lmdbDataset_real``
  (dataset/dataset.py:104-149): paired HR/LR records under the 1-based keys
  ``label-%09d``, ``image_hr-%09d`` and ``image_lr-%09d``, a ``num-samples``
  count, a skip forward over unreadable records, labels filtered by
  ``str_filt``;
* ``SingleImageLMDB`` (:90, ``--syn``) is ``lmdbDataset`` (:60-101): one
  image a record, ``image_hr-%09d`` or else ``image-%09d``;
* ``MixedLMDB`` (:113, ``--mixed``) is ``lmdbDataset_mix`` (:766-813): a
  TextZoom pair whose LR is its HR when its own ``random.Random(0)`` draws
  above 0.5, outside ``test`` and above the decode cache;
* ``IC15TextSRDataset`` (:235, ``--ic15sr``) is
  ``lmdbDataset_realIC15TextSR`` (:152-238): PGM pairs under
  ``HRx2/<split>`` and ``LRx2/<split>`` listed in ``<split>_GT.txt``;
* the readers no flag selects: ``TextZoomWithMask`` (:164, the edge weight
  mask of ``edges.edge_weight_mask``), ``SingleImageLMDBIC15`` (:179) with
  its aliases ``COCOTextLMDB``, ``IIITLMDB`` and ``BadSetLMDB``,
  ``SVTDataset`` (:199) and ``ImageFolderDataset`` (:127);
* ``ConcatDataset`` is torch's, the same cumulative sizes and bisect as the
  reference's (dataset.py:1484-1524).
"""

from __future__ import annotations

import io
import os
import random
from typing import List, Optional, Tuple

from PIL import Image
from torch.utils.data import ConcatDataset, Dataset

from tpgsr_tpu_torch.charset import str_filt
from tpgsr_tpu_torch.data.lmdb import LMDBReader

__all__ = ["BadSetLMDB", "COCOTextLMDB", "ConcatDataset", "IC15TextSRDataset", "IIITLMDB", "ImageFolderDataset",
           "MixedLMDB", "SVTDataset", "SingleImageLMDB", "SingleImageLMDBIC15", "TextZoomDataset", "TextZoomWithMask"]

# the decode cache holds up to this many items (a million crops are ~15 GB)
CACHE_LIMIT = 1_000_000
# records probed past a corrupt one before giving up
SKIP_PROBES = 16


def _buf2pil(buf: Optional[bytes], mode: str = "RGB") -> Image.Image:
    if buf is None:
        raise IOError("missing image record")
    return Image.open(io.BytesIO(buf)).convert(mode)


class TextZoomDataset(Dataset):
    """Paired HR/LR TextZoom LMDB; items are (img_hr, img_lr, label).

    ``cache_images`` keeps each decoded item after its first read, so that
    epochs after the first skip the JPEG decode.  An item is the same object
    each epoch, which also lets the collate's transform cache (collate.py)
    hit.  In a loader each worker holds its own copy of the cache.
    """

    def __init__(self, root: str, voc_type: str = "upper", max_len: int = 100,
                 test: bool = False, cache_images: bool = False):
        self.env = LMDBReader(root)
        n = self.env.get(b"num-samples")
        if n is None:
            raise IOError(f"{root}: missing num-samples key")
        self.n_samples = int(n)
        self.voc_type = voc_type
        self.max_len = max_len
        self.test = test
        self._cache: Optional[dict] = {} if cache_images and self.n_samples <= CACHE_LIMIT else None

    def __len__(self) -> int:
        return self.n_samples

    def __getitem__(self, index: int):
        if self._cache is not None and index in self._cache:
            return self._cache[index]
        if not 0 <= index < self.n_samples:
            raise IndexError(f"index {index} out of range for {self.n_samples} samples")
        first = index + 1  # keys are 1-based (reference dataset.py:134)
        for probe in range(first, min(first + SKIP_PROBES, self.n_samples + 1)):
            label = self.env.get(b"label-%09d" % probe)
            try:
                img_hr = _buf2pil(self.env.get(b"image_hr-%09d" % probe))
                img_lr = _buf2pil(self.env.get(b"image_lr-%09d" % probe))
            except (IOError, OSError):
                continue  # skip forward over a corrupt record (dataset.py:146-147)
            word = label.decode() if label is not None else ""
            item = (img_hr, img_lr, str_filt(word, self.voc_type))
            if self._cache is not None:
                self._cache[index] = item
            return item
        raise IOError(f"no readable record at or after index {first}")


class SingleImageLMDB(Dataset):
    """A synthetic LMDB of one image a record (``--syn``); items are (img,
    label).  The image is ``image_hr-%09d``, or ``image-%09d`` where that key
    is missing; a record that has neither raises ``IOError``."""

    def __init__(self, root: str, voc_type: str = "upper", max_len: int = 31, test: bool = True):
        self.env = LMDBReader(root)
        self.n_samples = int(self.env.get(b"num-samples"))
        self.voc_type = voc_type
        self.max_len = max_len

    def __len__(self) -> int:
        return self.n_samples

    def __getitem__(self, index: int):
        if not 0 <= index < self.n_samples:
            raise IndexError(f"index {index} out of range for {self.n_samples} samples")
        key = index + 1
        label = self.env.get(b"label-%09d" % key)
        buf = self.env.get(b"image_hr-%09d" % key)
        if buf is None:
            buf = self.env.get(b"image-%09d" % key)
        word = label.decode() if label is not None else ""
        return _buf2pil(buf), str_filt(word, self.voc_type)


class MixedLMDB(TextZoomDataset):
    """TextZoom pairs whose LR is the HR half the time (``--mixed``).  The
    coin is this dataset's own ``rng`` (``random.Random(0)`` unless given),
    drawn once a ``__getitem__`` outside ``test``, so the stream follows the
    order of the calls: a loader worker draws from its own copy."""

    def __init__(self, *args, rng: Optional[random.Random] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.rng = rng or random.Random(0)

    def __getitem__(self, index: int):
        img_hr, img_lr, label = super().__getitem__(index)
        if not self.test and self.rng.random() > 0.5:
            img_lr = img_hr
        return img_hr, img_lr, label


class IC15TextSRDataset(Dataset):
    """IC15 TextSR folders (``--ic15sr``): ``<root>/HRx2/<split>/<name>.pgm``
    and ``<root>/LRx2/<split>/<name>.pgm`` for each line ``<name>,
    "<label>"`` of ``<root>/<split>_GT.txt``, ``split`` being ``test`` or
    ``train``; items are (img_hr, img_lr, label), both RGB."""

    def __init__(self, root: str, voc_type: str = "upper", max_len: int = 100, test: bool = False):
        split = "test" if test else "train"
        self.hr_dir = os.path.join(root, "HRx2", split)
        self.lr_dir = os.path.join(root, "LRx2", split)
        self.items: List[Tuple[str, str]] = []
        with open(os.path.join(root, f"{split}_GT.txt")) as f:
            for line in f:
                line = line.strip()
                if line:
                    name, _, label = line.partition(",")
                    self.items.append((name.strip(), label.strip().strip('"')))
        self.voc_type = voc_type
        self.max_len = max_len

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, index: int):
        name, label = self.items[index]
        img_hr = Image.open(os.path.join(self.hr_dir, name + ".pgm")).convert("RGB")
        img_lr = Image.open(os.path.join(self.lr_dir, name + ".pgm")).convert("RGB")
        return img_hr, img_lr, str_filt(label, self.voc_type)


class TextZoomWithMask(TextZoomDataset):
    """TextZoom pairs with the HR's edge weight mask (``lmdbDatasetWithMask_real``,
    dataset.py:816-871): items are (img_hr, img_lr, label, weights), the
    weights float64 in [0.4, 0.9] (``edges.edge_weight_mask``)."""

    def __getitem__(self, index: int):
        from tpgsr_tpu_torch.data.edges import edge_weight_mask

        img_hr, img_lr, label = super().__getitem__(index)
        return img_hr, img_lr, label, edge_weight_mask(img_hr)


class SingleImageLMDBIC15(SingleImageLMDB):
    """A single-image LMDB read as pairs whose LR is the HR
    (``lmdbDataset_realIC15``, dataset.py:461-507): items are (img, img,
    label)."""

    def __getitem__(self, index: int):
        img, label = super().__getitem__(index)
        return img, img, label


# lmdbDataset_realCOCOText (dataset.py:509), _realIIIT (:354) and _realBadSet
# (:410) read the same records as the IC15 LMDB
COCOTextLMDB = SingleImageLMDBIC15
IIITLMDB = SingleImageLMDBIC15
BadSetLMDB = SingleImageLMDBIC15


class SVTDataset(Dataset):
    """SVT folders, ``<root>/svt_{train,test}/IMG/<stem>.jpg`` beside
    ``label/<stem>.*`` whose first line is the word (``lmdbDataset_realSVT``,
    dataset.py:242-296); items are (img, img, label), skipping forward over
    up to ``SKIP_PROBES`` unreadable records (wrapping at the end)."""

    def __init__(self, root: str, voc_type: str = "upper", max_len: int = 100, test: bool = False):
        d = os.path.join(root, "svt_test" if test else "svt_train")
        self.image_dir = os.path.join(d, "IMG")
        self.anno_dir = os.path.join(d, "label")
        self.anno_list = sorted(os.listdir(self.anno_dir))
        self.voc_type = voc_type
        self.max_len = max_len

    def __len__(self) -> int:
        return len(self.anno_list)

    def __getitem__(self, index: int):
        for probe in range(index, min(index + SKIP_PROBES, len(self))):
            anno = self.anno_list[probe % len(self)]
            image_path = os.path.join(self.image_dir, anno.split(".")[0] + ".jpg")
            if not os.path.isfile(image_path):
                continue
            try:
                with open(os.path.join(self.anno_dir, anno)) as f:
                    word = f.readlines()[0].strip()
                img = Image.open(image_path).convert("RGB")
            except (IOError, OSError, IndexError, ValueError):
                continue
            return img, img, str_filt(word, self.voc_type)
        raise IOError(f"no readable SVT record at or after index {index}")


class ImageFolderDataset(Dataset):
    """The images of a folder (``.png``, ``.jpg``, ``.jpeg``, ``.bmp``) in
    name order, for inference (``lmdbDataset_realForTest``, dataset.py:298);
    items are (img, the file's stem)."""

    EXTS = (".png", ".jpg", ".jpeg", ".bmp")

    def __init__(self, root: str):
        self.root = root
        self.files = sorted(f for f in os.listdir(root) if os.path.splitext(f)[1].lower() in self.EXTS)

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, index: int):
        name = self.files[index]
        return Image.open(os.path.join(self.root, name)).convert("RGB"), os.path.splitext(name)[0]
