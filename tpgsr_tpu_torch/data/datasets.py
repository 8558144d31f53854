"""TextZoom datasets over LMDB (counterpart of tpgsr_tpu/data/datasets.py:
``TextZoomDataset`` :37 and ``ConcatDataset`` :146).

``TextZoomDataset`` is the reference ``lmdbDataset_real``
(dataset/dataset.py:104-149): paired HR/LR records under the 1-based keys
``label-%09d``, ``image_hr-%09d`` and ``image_lr-%09d``, a ``num-samples``
count, a skip forward over unreadable records, labels filtered by
``str_filt``.  ``ConcatDataset`` is torch's, the same cumulative sizes and
bisect as the reference's (dataset.py:1484-1524).
"""

from __future__ import annotations

import io
from typing import Optional

from PIL import Image
from torch.utils.data import ConcatDataset, Dataset

from tpgsr_tpu_torch.charset import str_filt
from tpgsr_tpu_torch.data.lmdb import LMDBReader

__all__ = ["ConcatDataset", "TextZoomDataset"]

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
