"""The data half of ``TextSR`` (counterpart of tpgsr_tpu/train/trainer.py:
``_collate_kind`` :113, ``_collate`` :206, ``get_train_data`` :258 and
``get_val_data`` :282, on TextZoom LMDBs).

Plain functions of the TRAIN keys (``configs/super_resolution.yaml``), with
the YAML's defaults and the JAX trainer's wire defaults: the uint8 wire with
the contour mask appended on the device.  ``workers`` is the number of
loader processes, as in the reference's torch ``DataLoader``
(interfaces/base.py:250-255); the val loaders take as many.
"""

from __future__ import annotations

import functools
from typing import Callable, List, Sequence

from tpgsr_tpu_torch.data.collate import COLLATES, CollateConfig
from tpgsr_tpu_torch.data.datasets import ConcatDataset, TextZoomDataset
from tpgsr_tpu_torch.data.loader import Loader, make_loader
from tpgsr_tpu_torch.device import DeviceLike, resolve_device

# archs trained through the cascade (reference super_resolution.py:44) and
# the TL archs with one student (tpgsr_tpu/models/registry.py:22-26)
ABLATION_SET = ("tsrn_tl_cascade", "srcnn_tl", "srresnet_tl", "rdn_tl", "vdsr_tl")
TL_SIMPLE = ("tsrn_tl", "tsrn_tl_wmask", "esrgan_tl")


def collate_kind(arch: str, train: bool) -> str:
    """The collate an arch trains or validates with (reference
    interfaces/base.py:51-214)."""
    if arch in ABLATION_SET or arch in TL_SIMPLE:
        return "realWTLAMask" if train else "realWTL"
    return "real"


def make_collate(arch: str, train: bool, mask: bool = False, *, height: int = 32, width: int = 128,
                 down_sample_scale: int = 2, keep_ratio: bool = False, wire_uint8: bool = True,
                 device_mask: bool = True) -> Callable:
    """The TextZoom collate for ``arch``, picklable for loader workers.

    ``wire_uint8`` ships images before the divide by 255; with it and
    ``mask``, ``device_mask`` ships RGB and the steps append the mask on the
    device."""
    cfg = CollateConfig(imgH=int(height), imgW=int(width), down_sample_scale=int(down_sample_scale),
                        mask=bool(mask), keep_ratio=bool(keep_ratio),
                        wire_dtype="uint8" if wire_uint8 else "float32", device_mask=bool(device_mask))
    return functools.partial(COLLATES[collate_kind(arch, train)], cfg=cfg)


def train_loader(train_data_dir: Sequence[str], arch: str = "tsrn_tl_cascade", mask: bool = False, *,
                 batch_size: int = 512, height: int = 32, width: int = 128, down_sample_scale: int = 2,
                 keep_ratio: bool = False, wire_uint8: bool = True, device_mask: bool = True,
                 cache_images: bool = True, workers: int = 1, manualSeed: int = 1234, voc_type: str = "all",
                 max_len: int = 100, device: DeviceLike = None) -> Loader:
    """The train loader over the TextZoom LMDBs of ``train_data_dir``
    (concatenated), shuffled from ``manualSeed`` each epoch, the short last
    batch dropped; pinned for the card unless ``device`` is the CPU."""
    dev = resolve_device(device)
    sets = [TextZoomDataset(d, voc_type=voc_type, max_len=max_len, cache_images=cache_images)
            for d in train_data_dir]
    ds = sets[0] if len(sets) == 1 else ConcatDataset(sets)
    collate = make_collate(arch, True, mask, height=height, width=width, down_sample_scale=down_sample_scale,
                           keep_ratio=keep_ratio, wire_uint8=wire_uint8, device_mask=device_mask)
    return make_loader(ds, int(batch_size), collate, shuffle=True, drop_last=True, seed=int(manualSeed),
                       workers=int(workers), device=dev)


def val_loaders(val_data_dir: Sequence[str], arch: str = "tsrn_tl_cascade", mask: bool = False, *,
                batch_size: int = 512, height: int = 32, width: int = 128, down_sample_scale: int = 2,
                keep_ratio: bool = False, wire_uint8: bool = True, device_mask: bool = True,
                cache_images: bool = True, workers: int = 1, voc_type: str = "all", max_len: int = 100,
                device: DeviceLike = None) -> List[Loader]:
    """One loader per val split, in order, unshuffled, the last batch kept
    short; pinned for the card unless ``device`` is the CPU."""
    dev = resolve_device(device)
    collate = make_collate(arch, False, mask, height=height, width=width, down_sample_scale=down_sample_scale,
                           keep_ratio=keep_ratio, wire_uint8=wire_uint8, device_mask=device_mask)
    return [make_loader(TextZoomDataset(d, voc_type=voc_type, max_len=max_len, test=True,
                                        cache_images=cache_images),
                        int(batch_size), collate, shuffle=False, drop_last=False, workers=int(workers),
                        device=dev)
            for d in val_data_dir]
