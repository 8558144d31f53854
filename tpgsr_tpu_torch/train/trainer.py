"""``TextSR``: config and flags to ``train()`` / ``test()`` / ``demo()``
(counterpart of tpgsr_tpu/train/trainer.py; reference
interfaces/super_resolution.py:49-1523 and interfaces/base.py).

The data half is plain functions of the TRAIN keys
(``configs/super_resolution.yaml``), with the YAML's defaults and the JAX
trainer's wire defaults: the uint8 wire with the contour mask appended on
the device.  ``workers`` is the number of loader processes, as in the
reference's torch ``DataLoader`` (interfaces/base.py:250-255); the val
loaders take as many.

``TextSR`` runs the loop of the JAX class: the train step once an
iteration, the losses logged every 5 iterations and a display line every
``displayInterval`` (the only places it reads a metric back from the card),
val over the splits of TRAIN.VAL.val_data_dir at ``valInterval`` with the
best-checkpoint policy, a save at ``saveInterval``, global epochs and
iterations from the restored step.  ``--go_test`` runs val with
visualizations, ``--test`` times eval over TEST.test_data_dir, ``--demo``
reads the images of ``--demo_dir``.  The data flags pick the datasets of
train and val (``make_dataset``): ``--syn`` single-image LMDBs read through
``collate_syn``, ``--mixed`` TextZoom pairs whose LR is the HR half the
time, ``--ic15sr`` IC15's PGM folders; ``--random_reso`` scores val image by
image at native size behind the confidence gate (train/random_reso.py),
over ``collate_syn_random_reso``'s lists with ``--syn`` (an eval-only mode:
``--go_test``) or over the val collate's float32 batches.  Val,
``--go_test`` and ``--test`` score the images with the recognizer of
``--test_model`` (``--rec`` for ``--test``): the teacher CRNN, or ASTER,
MORAN or SEED (``eval_recognizer``).
``--tpg OPT`` makes clova's None-ResNet-None-CTC the teacher and the students
(``load_opt``); a CRNN of its own then scores the images.
In a process group of several ranks (``parallel``; ``cli.main`` starts
one for TRAIN.n_devices above 1, or joins torchrun's) each rank runs this
loop on its card: the train loader reads the rank's slice of every global
batch, the state is rank 0's with BatchNorm over the global batch
(``parallel.replicate``), the step averages the gradients, val and
``--test`` evaluate sharded and agree on every rank, and rank 0 alone
writes checkpoints, scalars and visualizations and prints.
Val, ``--go_test``, ``--test`` and ``--demo`` evaluate a batch above
TRAIN.eval_tile rows in tiles of that many (``step.make_eval_step``); 0 or
a missing key runs every batch whole, where the JAX package tiles at 64:
on the card flat is the faster.  With
TPGSR_COST_REPORT set in the environment, ``init_state`` prints the SR
model's and the TP CRNN's FLOPs and parameters (``utils.cost``).
What is not ported raises
``NotImplementedError`` naming its ``ROADMAP.md`` item (``check_ported``);
``dispatch_chain`` and ``wire_uint8`` are read by nothing: the port runs one
step a dispatch on the uint8 wire.
"""

from __future__ import annotations

import functools
import os
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
from PIL import Image

from tpgsr_tpu_torch.charset import CTC_NUM_CLASSES, AsterInfo
from tpgsr_tpu_torch.config import AttrDict, apply_arg_overrides, registry_dicts
from tpgsr_tpu_torch.data.collate import COLLATES, CollateConfig
from tpgsr_tpu_torch.data.datasets import ConcatDataset, IC15TextSRDataset, MixedLMDB, SingleImageLMDB, TextZoomDataset
from tpgsr_tpu_torch.data.loader import Loader, make_loader
from tpgsr_tpu_torch.data.transforms import resize_normalize
from tpgsr_tpu_torch.device import DeviceLike, resolve_device
from tpgsr_tpu_torch.models import aster, moran
from tpgsr_tpu_torch.models.crnn import CRNN
from tpgsr_tpu_torch.models.layers import init_torch_defaults_
from tpgsr_tpu_torch.models.opt_tpg import OPTModel
from tpgsr_tpu_torch.models.seed import SEEDModelBuilder
from tpgsr_tpu_torch.models.registry import ABLATION_SET, TL_SIMPLE, build_model, check_arch
from tpgsr_tpu_torch.ops.ctc import decode_crnn
from tpgsr_tpu_torch.ops.gru_seq import MAX_HIDDEN
from tpgsr_tpu_torch.parallel import rank_and_world, rank_device, replicate
from tpgsr_tpu_torch.train import checkpoint as ckpt
from tpgsr_tpu_torch.train.evaluate import evaluate
from tpgsr_tpu_torch.train.logging import ScalarLogger
from tpgsr_tpu_torch.train.priors import parse_crnn_data
from tpgsr_tpu_torch.train.random_reso import conf_threshold_of, evaluate_random_reso_loader
from tpgsr_tpu_torch.train.state import TrainState, create_train_state
from tpgsr_tpu_torch.train.step import REC_KINDS, EvalModels, make_eval_step, make_train_step, rec_decoder, torch_dtype
from tpgsr_tpu_torch.utils.cost import model_cost_report

# --rec of --test -> the eval recognizer (tpgsr_tpu/train/trainer.py:749-751)
REC_MAP = {"aster": "ASTER", "moran": "MORAN", "crnn": "CRNN"}


# the data flags that pick the datasets, in the order the JAX package tests
# them (tpgsr_tpu/train/trainer.py:240-256); none of them: TextZoom pairs
DATA_MODES = ("syn", "mixed", "ic15sr")


def data_mode(args: Mapping) -> str:
    """'syn', 'mixed' or 'ic15sr', the first of those flags that ``args``
    sets, else 'textzoom'."""
    return next((m for m in DATA_MODES if args.get(m)), "textzoom")


def make_dataset(root: str, mode: str = "textzoom", test: bool = False, *, voc_type: str = "all",
                 max_len: int = 100, cache_images: bool = True):
    """The dataset of a train or val directory under a data mode
    (interfaces/base.py:39-235; tpgsr_tpu/train/trainer.py:240-299):
    TextZoom pairs, ``SingleImageLMDB`` for 'syn' (which takes no ``test``),
    ``MixedLMDB`` for 'mixed' (no HR-as-LR under ``test``) or
    ``IC15TextSRDataset`` for 'ic15sr' (its ``test`` or ``train`` split).
    The decode cache is the LMDB pairs' alone."""
    if mode == "syn":
        return SingleImageLMDB(root, voc_type=voc_type, max_len=max_len)
    if mode == "ic15sr":
        return IC15TextSRDataset(root, voc_type=voc_type, max_len=max_len, test=test)
    cls = {"mixed": MixedLMDB, "textzoom": TextZoomDataset}[mode]
    return cls(root, voc_type=voc_type, max_len=max_len, test=test, cache_images=cache_images)


def collate_kind(arch: str, train: bool, syn: bool = False, random_reso: bool = False) -> str:
    """The collate an arch trains or validates with (reference
    interfaces/base.py:51-214; tpgsr_tpu/train/trainer.py:222-236):
    ``collate_syn`` under ``syn``, ``collate_syn_random_reso`` under both."""
    if syn:
        return "syn_random_reso" if random_reso else "syn"
    if arch in ABLATION_SET or arch in TL_SIMPLE:
        return "realWTLAMask" if train else "realWTL"
    return {"tsrn_c2f": "c2f_real", "sem_tsrn": "W2V_real"}.get(arch, "real")


def make_collate(arch: str, train: bool, mask: bool = False, *, height: int = 32, width: int = 128,
                 down_sample_scale: int = 2, keep_ratio: bool = False, wire_uint8: bool = True,
                 device_mask: bool = True, syn: bool = False, random_reso: bool = False) -> Callable:
    """The collate for ``arch`` (``collate_kind``), picklable for loader
    workers.

    ``wire_uint8`` ships images before the divide by 255; with it and
    ``mask``, ``device_mask`` ships RGB and the steps append the mask on the
    device.  A ``random_reso`` val collate ships float32 with the mask
    channel whatever they say: its evaluator reads each image on its own
    (tpgsr_tpu/train/trainer.py:222-226)."""
    if random_reso and not train:
        wire_uint8 = device_mask = False
    cfg = CollateConfig(imgH=int(height), imgW=int(width), down_sample_scale=int(down_sample_scale),
                        mask=bool(mask), keep_ratio=bool(keep_ratio),
                        wire_dtype="uint8" if wire_uint8 else "float32", device_mask=bool(device_mask))
    return functools.partial(COLLATES[collate_kind(arch, train, syn, random_reso)], cfg=cfg)


def train_loader(train_data_dir: Sequence[str], arch: str = "tsrn_tl_cascade", mask: bool = False, *,
                 batch_size: int = 512, height: int = 32, width: int = 128, down_sample_scale: int = 2,
                 keep_ratio: bool = False, wire_uint8: bool = True, device_mask: bool = True,
                 cache_images: bool = True, workers: int = 1, manualSeed: int = 1234, voc_type: str = "all",
                 max_len: int = 100, data: str = "textzoom", random_reso: bool = False,
                 device: DeviceLike = None, shard_index: int = 0, shard_count: int = 1) -> Loader:
    """The train loader over the directories of ``train_data_dir``
    (concatenated), read as ``data`` says (``make_dataset``: TextZoom LMDBs
    unless 'syn', 'mixed' or 'ic15sr'), shuffled from ``manualSeed`` each
    epoch, the short last batch dropped; pinned for the card unless
    ``device`` is the CPU; rank ``shard_index`` of ``shard_count`` reads its
    slice of each global batch of ``batch_size``.  A 'mixed' dataset draws
    its HR-as-LR coin in the process that reads it: with ``workers`` > 1
    each worker draws from its copy, reseeded every epoch as the JAX
    loader's workers reseed theirs (``data.loader``)."""
    dev = resolve_device(device)
    sets = [make_dataset(d, data, voc_type=voc_type, max_len=max_len, cache_images=cache_images)
            for d in train_data_dir]
    ds = sets[0] if len(sets) == 1 else ConcatDataset(sets)
    collate = make_collate(arch, True, mask, height=height, width=width, down_sample_scale=down_sample_scale,
                           keep_ratio=keep_ratio, wire_uint8=wire_uint8, device_mask=device_mask,
                           syn=data == "syn", random_reso=random_reso)
    return make_loader(ds, int(batch_size), collate, shuffle=True, drop_last=True, seed=int(manualSeed),
                       workers=int(workers), device=dev, shard_index=shard_index, shard_count=shard_count)


def val_loaders(val_data_dir: Sequence[str], arch: str = "tsrn_tl_cascade", mask: bool = False, *,
                batch_size: int = 512, height: int = 32, width: int = 128, down_sample_scale: int = 2,
                keep_ratio: bool = False, wire_uint8: bool = True, device_mask: bool = True,
                cache_images: bool = True, workers: int = 1, voc_type: str = "all", max_len: int = 100,
                data: str = "textzoom", random_reso: bool = False, device: DeviceLike = None) -> List[Loader]:
    """One loader per val split, in order, unshuffled, the last batch kept
    short, each split read as ``data`` says (``make_dataset``, ``test``);
    pinned for the card unless ``device`` is the CPU.  Under
    ``random_reso`` the batches are float32 with the mask channel, or with
    'syn' lists of images at their own sizes (``make_collate``)."""
    dev = resolve_device(device)
    collate = make_collate(arch, False, mask, height=height, width=width, down_sample_scale=down_sample_scale,
                           keep_ratio=keep_ratio, wire_uint8=wire_uint8, device_mask=device_mask,
                           syn=data == "syn", random_reso=random_reso)
    return [make_loader(make_dataset(d, data, True, voc_type=voc_type, max_len=max_len, cache_images=cache_images),
                        int(batch_size), collate, shuffle=False, drop_last=False, workers=int(workers),
                        device=dev)
            for d in val_data_dir]


def split_name(path: str) -> str:
    """A val split's name: the last part of its directory."""
    return os.path.basename(str(path).rstrip("/"))


class BestTracker:
    """Best-checkpoint selection (interfaces/super_resolution.py:505-533), as
    the JAX package's ``BestTracker``:

    * ``best_history_acc[split]`` rises whenever that split improves, with an
      ``epoch`` stamp, whether or not the eval is the best overall;
    * ``is_best`` compares the accuracy summed over the splits;
    * on a new best, ``best_model_info`` takes the accuracies (with the
      epoch) and the PSNR and SSIM of the last split only (the reference
      reads them after its split loop, :528-529)."""

    def __init__(self, split_names: Sequence[str]):
        self.best_history_acc: Dict = {k: 0.0 for k in split_names}
        self.best_model_acc: Dict = {k: 0.0 for k in split_names}
        self.best_model_psnr: Dict = {k: 0.0 for k in split_names}
        self.best_model_ssim: Dict = {k: 0.0 for k in split_names}
        self.best_sum = 0.0

    def update(self, metrics_by_split: Mapping[str, Mapping[str, float]], epoch: int) -> bool:
        """``metrics_by_split``: {split: metric_dict} in evaluation order."""
        accs = {k: float(md["accuracy"]) for k, md in metrics_by_split.items()}
        for k, v in accs.items():
            if v > self.best_history_acc.get(k, 0.0):
                self.best_history_acc[k] = v
                self.best_history_acc["epoch"] = epoch
        is_best = sum(accs.values()) > self.best_sum
        if is_best:
            self.best_sum = sum(accs.values())
            self.best_model_acc = dict(accs)
            self.best_model_acc["epoch"] = epoch
            last = list(metrics_by_split)[-1]
            self.best_model_psnr[last] = float(metrics_by_split[last]["psnr_avg"])
            self.best_model_ssim[last] = float(metrics_by_split[last]["ssim_avg"])
        return is_best

    @property
    def best_model_info(self) -> Dict:
        return {"accuracy": dict(self.best_model_acc), "psnr": dict(self.best_model_psnr),
                "ssim": dict(self.best_model_ssim)}


def eval_rec_kind(args: Mapping) -> str:
    """The eval recognizer a run scores with: ``--rec`` under ``--test``,
    ``--test_model`` otherwise."""
    if args.get("test"):
        return REC_MAP.get(args.get("rec", "crnn"), "CRNN")
    return str(args.get("test_model") or "CRNN")


def load_crnn(path: str, generator: torch.Generator) -> CRNN:
    """A CRNN from ``path`` when that file exists (a plain ``state_dict``;
    interfaces/base.py:634-660), drawn from ``generator`` otherwise."""
    model = CRNN(nclass=CTC_NUM_CLASSES)
    if path and os.path.exists(path):
        model.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))
    else:
        init_torch_defaults_(model, generator)
    return model


def load_opt(path: str, generator: torch.Generator, opt_TPG: Optional[Mapping] = None) -> OPTModel:
    """The ``--tpg OPT`` text-prior generator (reference interfaces/base.py:681-718;
    tpgsr_tpu/train/trainer.py:300-312): clova's None-ResNet-None-CTC of
    ``opt_TPG``'s ``num_class`` and ``output_channel`` (37 and 512 without
    it), from ``path`` when that file exists (clova's file,
    ``module.`` prefixes stripped), drawn from ``generator`` otherwise."""
    opt = opt_TPG or {}
    model = OPTModel(nclass=int(opt.get("num_class", CTC_NUM_CLASSES)),
                     output_channel=int(opt.get("output_channel", 512)))
    if path and os.path.exists(path):
        model.load_state_dict(ckpt.load_recognizer_state_dict(path))
    else:
        init_torch_defaults_(model, generator)
    return model


def eval_recognizer(kind: str, config: AttrDict, device: DeviceLike = None) -> torch.nn.Module:
    """The frozen eval recognizer of ``--test_model`` (test_bible,
    super_resolution.py:107-135; tpgsr_tpu/train/trainer.py:381-458), in
    eval mode on ``device`` (the card unless told otherwise): ASTER from
    TRAIN.VAL.rec_pretrained with ``AsterInfo(TRAIN.voc_type)``, MORAN from
    TRAIN.VAL.moran_pretrained (files in the original's layout,
    ``checkpoint.load_recognizer_state_dict``; the constants the original
    keeps as buffers are dropped), a CRNN from TRAIN.VAL.crnn_pretrained.
    Where the file does not exist the weights are drawn from seed 7, as the
    JAX package draws them from its key 7 (other numbers, the same
    distributions).  SEED (``AsterInfo(TRAIN.voc_type)``, no STN) is always
    drawn from seed 7: the JAX package reads no SEED file either
    (tpgsr_tpu/train/trainer.py:414-426)."""
    dev = resolve_device(device)
    val = config.TRAIN.VAL
    gen = torch.Generator().manual_seed(7)
    if kind == "CRNN":
        model = load_crnn(val.get("crnn_pretrained", ""), gen)
    elif kind in ("ASTER", "MORAN"):
        if kind == "ASTER":
            info = AsterInfo(config.TRAIN.voc_type)
            model = aster.RecognizerBuilder(info.rec_num_classes, info.char2id[info.EOS], max_len_labels=info.max_len)
            path, constants = val.get("rec_pretrained", ""), aster.ORIGINAL_CONSTANTS
        else:
            model, path, constants = moran.MORAN(), val.get("moran_pretrained", ""), moran.ORIGINAL_CONSTANTS
        if path and os.path.exists(path):
            sd = ckpt.load_recognizer_state_dict(path)
            model.load_state_dict({k: v for k, v in sd.items() if not k.startswith(constants)})
        else:
            model.init_from_(gen)
    elif kind == "SEED":
        info = AsterInfo(config.TRAIN.voc_type)
        model = SEEDModelBuilder(info.rec_num_classes, info.char2id[info.EOS], max_len_labels=info.max_len)
        model.init_from_(gen)
    else:
        raise ValueError(f"unknown --test_model {kind!r}")
    return model.to(dev).eval().requires_grad_(False)


def check_ported(config: AttrDict, args: Mapping, device: torch.device) -> None:
    """Raise ``NotImplementedError``, naming its ``ROADMAP.md`` item, for
    what the run asks that the port does not do yet."""
    t = config.TRAIN

    def missing(what: str, item: str) -> None:
        raise NotImplementedError(f"{what}: not ported yet (ROADMAP.md {item})")

    check_arch(args["arch"])
    torch_dtype(t.get("compute_dtype", "fp32"))  # raises ValueError for a value that is neither fp32 nor bf16
    if args.get("tpg", "CRNN") not in ("CRNN", "OPT"):
        raise ValueError(f"unknown --tpg {args['tpg']!r}")
    kind = eval_rec_kind(args)
    if kind not in REC_KINDS:
        raise ValueError(f"unknown --test_model {kind!r}")
    if args.get("demo") and kind != "CRNN":
        # the JAX package's demo() decodes any recognizer's output by CTC
        missing(f"--demo with --test_model {kind}", "queue 1 item 8")
    if args.get("random_reso"):
        # the JAX package's two refusals (tpgsr_tpu/train/trainer.py:508-515,
        # :666-667), raised here before anything runs: the variable-resolution
        # lists feed no train step and no fixed-shape eval step, and val runs
        # the CRNN alone
        if args.get("syn") and not (args.get("go_test") or args.get("demo")):
            raise ValueError("--random_reso with --syn is eval-only; run with --go_test")
        if not (args.get("test") or args.get("demo")) and str(args.get("test_model") or "CRNN") != "CRNN":
            raise ValueError("--random_reso eval supports --test_model=CRNN only")
    hidden = int(args.get("hd_u", 32))
    # only the TSRN family runs K1; the other backbones read no --hd_u.  K1
    # runs every size from 1 to MAX_HIDDEN (padded to its kernels' sizes);
    # at 256 an fp32 W_hh is 786 KB a direction, more than an SM's shared
    # memory, which needs another design
    if device.type == "cuda" and args["arch"].startswith("tsrn") and not 1 <= hidden <= MAX_HIDDEN:
        missing(f"--hd_u {hidden} on the card (K1 takes hidden sizes 1 to {MAX_HIDDEN}; above, an fp32 W_hh "
                "outgrows an SM's shared memory)", "queue 2 item 3")


class TextSR:
    """config + flags -> ``train()`` / ``test()`` / ``demo()`` (main.py:10-18),
    on ``device`` (the card unless told otherwise).  The train step runs in
    TRAIN.compute_dtype ('bf16', the packaged default, or 'fp32'); val,
    ``--go_test``, ``--test`` and ``--demo`` run the fp32 eval step whatever
    it says, as the JAX package does.  On the card it turns TF32 off for the
    process, cuBLAS's and cuDNN's, in both precisions: the fp32 parts (fp32
    steps, and in bf16 the losses, BatchNorm, K1's state, the clip, Adam and
    eval) stay IEEE fp32.  ``opt_TPG`` is the ``--tpg OPT`` generator's
    options (``config.tpg_opt``, which the CLI passes).  In a process group
    it is one rank: on ``cuda:<local rank>`` where ``device`` names no card,
    and ``train()``/``test()`` need the group's size to be TRAIN.n_devices
    where that is above 0."""

    def __init__(self, config: AttrDict, args: AttrDict, opt_TPG: Optional[AttrDict] = None,
                 device: DeviceLike = None):
        self.device = rank_device(device)
        self.rank, self.world = rank_and_world()
        self.primary = self.rank == 0
        self.config = apply_arg_overrides(config, args)
        self.args = args
        self.opt_TPG = opt_TPG
        self.tpg = str(args.get("tpg") or "CRNN")
        check_ported(self.config, args, self.device)
        if self.device.type == "cuda":
            # fp32 is IEEE fp32 on the card too, in either compute dtype:
            # PyTorch lets cuDNN's convolutions run in TF32 unless told otherwise.
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.scale_factor = int(self.config.TRAIN.down_sample_scale)
        self.arch = args["arch"]
        self.vis_dir = args.get("vis_dir") or self.arch
        self.ckpt_dir = os.path.join(self.config.TRAIN.ckpt_dir, self.vis_dir)
        self.stu_iter = int(args.get("stu_iter", 1))
        # a plain arch trains one SR model and no students (trainer.py:195-198)
        self.is_tl = self.arch in ABLATION_SET or self.arch in TL_SIMPLE
        self.n_sr = (1 if args.get("sr_share") else self.stu_iter) if self.is_tl else 1
        self.n_stu = (1 if args.get("tpg_share") else self.stu_iter) if self.is_tl else 0
        self._state: Optional[TrainState] = None
        self._rec: Optional[torch.nn.Module] = None
        self._rec_kind: Optional[str] = None
        self._train_step: Optional[Callable] = None
        self._eval_step: Optional[Callable] = None

    # ------------------------------------------------------------------ data
    def _loader_kw(self) -> Dict:
        t = self.config.TRAIN
        return dict(batch_size=int(t.batch_size), height=int(t.height), width=int(t.width),
                    down_sample_scale=self.scale_factor, keep_ratio=bool(t.get("keep_ratio", False)),
                    cache_images=bool(t.get("cache_images", True)), workers=int(t.get("workers", 1)),
                    voc_type=t.voc_type, max_len=int(t.max_len), data=data_mode(self.args),
                    random_reso=bool(self.args.get("random_reso")), device=self.device)

    def get_train_data(self) -> Loader:
        t = self.config.TRAIN
        return train_loader(t.train_data_dir, self.arch, bool(self.args.get("mask")),
                            manualSeed=int(t.get("manualSeed", 1234)), shard_index=self.rank,
                            shard_count=self.world, **self._loader_kw())

    def get_val_data(self, dirs: Optional[Sequence[str]] = None) -> List[Loader]:
        dirs = self.config.TRAIN.VAL.val_data_dir if dirs is None else dirs
        return val_loaders(dirs, self.arch, bool(self.args.get("mask")), **self._loader_kw())

    # ----------------------------------------------------------------- state
    def _check_world(self) -> None:
        """TRAIN.n_devices above 0 must be the group's size (``cli.main``
        starts that many ranks)."""
        n = int(self.config.TRAIN.get("n_devices", 0) or 0)
        if n > 0 and n != self.world:
            raise ValueError(f"TRAIN.n_devices {n} trains on {n} ranks, but this process is one of {self.world}: "
                             "start it through cli.main, torchrun or parallel.spawn")

    def _eval_only(self) -> bool:
        return bool(self.args.get("go_test") or self.args.get("test") or self.args.get("demo"))

    def _eval_recognizer(self) -> Optional[torch.nn.Module]:
        """The eval recognizer of ``--test_model`` that the state lacks
        (``eval_recognizer``): ASTER, MORAN or SEED for any arch, a CRNN for a
        plain arch and under ``--tpg OPT``; None for a prior arch (cascade or
        ``TL_SIMPLE``) scored by CRNN, whose CRNN teacher reads the images.  Built when ``--test_model`` changes (``test()``
        sets it from ``--rec``), as the JAX package rebuilds its eval step
        (tpgsr_tpu/train/trainer.py:470-481), and frozen on the device."""
        kind = str(self.args.get("test_model") or "CRNN")
        if kind == "CRNN" and self.is_tl and self.tpg == "CRNN":
            return None
        if self._rec_kind != kind:
            self._rec, self._rec_kind = eval_recognizer(kind, self.config, self.device), kind
        return self._rec

    def _decoder(self):
        return rec_decoder(str(self.args.get("test_model") or "CRNN"), self.config.TRAIN.voc_type)

    def _teacher(self, gen: torch.Generator) -> torch.nn.Module:
        """A prior arch's teacher: the CRNN of TRAIN.VAL.crnn_pretrained, or
        under ``--tpg OPT`` the OPT model of ``opt_TPG.saved_model``; drawn
        from ``gen`` where the file does not exist."""
        if self.tpg == "OPT":
            return load_opt((self.opt_TPG or {}).get("saved_model", ""), gen, self.opt_TPG)
        return load_crnn(self.config.TRAIN.VAL.get("crnn_pretrained", ""), gen)

    def init_state(self) -> TrainState:
        """SR models drawn from TRAIN.manualSeed (then a prior arch's
        teacher, CRNN or OPT, when it is not loaded), students copied from the teacher, Adam; then
        ``--resume`` (or TRAIN.resume): the periodic files, Adam and the
        step, or for an eval-only run the best files alone.  In a group of
        several ranks every rank then holds rank 0's state, the SR models'
        and students' BatchNorm over the global batch
        (``parallel.replicate``)."""
        t = self.config.TRAIN
        gen = torch.Generator().manual_seed(int(t.get("manualSeed", 1234)))
        a, cfg = registry_dicts(self.config, self.args)
        sr = [init_torch_defaults_(build_model(self.arch, a, cfg)[0], gen).to(self.device) for _ in range(self.n_sr)]
        teacher = self._teacher(gen).to(self.device) if self.is_tl else None
        state = create_train_state(sr, teacher, n_stu=self.n_stu, lr=float(t.lr), beta1=float(t.beta1))
        resume = self.args.get("resume") or t.get("resume")
        if resume:
            ckpt.restore_checkpoint(resume, state, prefer_best=self._eval_only())
        if os.environ.get("TPGSR_COST_REPORT") and self.primary:
            self._cost_report(state)
        replicate([*state.sr, *state.stu], [state.teacher], state.optimizer)
        self._state = state
        return state

    def _cost_report(self, state: TrainState) -> None:
        """The FLOPs and parameters of the SR model at TRAIN.batch_size and of
        the text-prior generator at batch 1, as the JAX package prints them
        under TPGSR_COST_REPORT (tpgsr_tpu/train/trainer.py:365-377; reference
        interfaces/base.py:372-381, 638-643): zero inputs, eval mode."""
        t = self.config.TRAIN
        spec = check_arch(self.arch)
        size = (int(t.height) // self.scale_factor, int(t.width) // self.scale_factor)
        lr = torch.zeros(int(t.batch_size), spec.in_channels, *size, device=self.device)
        prior = torch.zeros(int(t.batch_size), CTC_NUM_CLASSES, 1, 26, device=self.device)
        model_cost_report(state.sr[0], (lr, prior) if spec.uses_prior else (lr,), f"SR:{self.arch}")
        if self.is_tl:
            model_cost_report(state.teacher, (torch.zeros(1, 1, 32, 100, device=self.device),), "TP:CRNN")

    def _build_steps(self, with_train: bool = True) -> None:
        width = int(self.config.TRAIN.width)
        if with_train and self._train_step is None:
            self._train_step = make_train_step(self.args, width, device=self.device,
                                               compute_dtype=str(self.config.TRAIN.get("compute_dtype", "fp32")))
        if self._eval_step is None:
            tile = int(self.config.TRAIN.get("eval_tile", 0) or 0)
            self._eval_step = make_eval_step(self.args, width, device=self.device, tile=tile)

    @staticmethod
    def _eval_models(state: TrainState, rec: Optional[torch.nn.Module] = None) -> EvalModels:
        return EvalModels(sr=state.sr, stu=state.stu, teacher=state.teacher, rec=rec).eval()

    # ----------------------------------------------------------------- train
    def train(self):
        """The train loop (tpgsr_tpu/train/trainer.py:506-642); with
        ``--go_test``, one val over the splits with visualizations, and its
        {split: metric_dict}.  Returns the state otherwise."""
        self._check_world()
        val_data = self.get_val_data()
        state = self._state if self._state is not None else self.init_state()
        go_test = bool(self.args.get("go_test"))
        self._build_steps(with_train=not go_test)
        # a fresh run clears the event dir (super_resolution.py:98-101); a
        # continuation (chunked train() calls, resume) appends to it
        logger = ScalarLogger(os.path.join("tensorboard", self.vis_dir), clear=state.step == 0)
        try:
            if go_test:
                return self._run_val(state, val_data, logger, iters=0)
            self._train_epochs(state, self.get_train_data(), val_data, logger)
        finally:
            logger.close()
        return state

    def _train_epochs(self, state: TrainState, loader: Loader, val_data: List[Loader], logger: ScalarLogger):
        t = self.config.TRAIN
        tracker = BestTracker([split_name(d) for d in t.VAL.val_data_dir])
        converge_list: List[Dict] = []
        display, val_int, save_int = int(t.displayInterval), int(t.VAL.valInterval), int(t.saveInterval)
        times: List[float] = []
        # global epochs and iterations from the restored step, so that every
        # global epoch has its own shuffle and val/save fire on global
        # iterations across chunked calls and resumes
        spe = len(loader)
        start_epoch = state.step // spe if spe else 0

        def log_scalars(m: Mapping[str, float], iters: int) -> None:
            logger.add_scalar("loss/total", m["loss_total"], iters)
            logger.add_scalar("loss/SR", m["loss_img"], iters)
            logger.add_scalar("loss/distill", m["loss_distill"], iters)

        def display_line(m: Mapping[str, float], epoch: int, iters: int) -> None:
            ips = int(t.batch_size) / (sum(times[-display:]) / min(len(times), display))
            print(f"[epoch {epoch} iter {iters}] loss_total={m['loss_total']:.4f} "
                  f"loss_img={m['loss_img']:.4f} loss_distill={m['loss_distill']:.4f} {ips:.1f} img/s", flush=True)

        def val_and_save(iters: int, epoch: int) -> None:
            if iters % val_int == 0:
                mds = self._run_val(state, val_data, logger, iters)
                converge_list.append({"iters": iters, **{k: md["accuracy"] for k, md in mds.items()}})
                is_best = tracker.update(mds, epoch)
                self._save(state, self._info(iters, epoch, tracker), is_best, converge_list)
            if iters % save_int == 0:
                self._save(state, self._info(iters, epoch, tracker), False, converge_list)

        for epoch in range(start_epoch, start_epoch + int(t.epochs)):
            loader.batch_sampler.epoch = epoch  # iterating advances it to epoch + 1
            for j, batch in enumerate(loader):
                iters = spe * epoch + j + 1
                t0 = time.time()
                metrics = self._train_step(state, batch)
                if iters % 5 == 0:
                    log_scalars({k: float(v) for k, v in metrics.items()}, iters)
                times.append(time.time() - t0)
                if iters % display == 0 and self.primary:
                    display_line({k: float(v) for k, v in metrics.items()}, epoch, iters)
                val_and_save(iters, epoch)

    def _save(self, state: TrainState, info: Dict, is_best: bool, converge_list: List[Dict]) -> None:
        ckpt.save_checkpoint(self.ckpt_dir, state, info, is_best, converge_list)

    def _info(self, iters: int, epoch: int, tracker: BestTracker) -> Dict:
        t = self.config.TRAIN
        return {"arch": self.arch, "iters": iters, "epochs": epoch, "batch_size": int(t.batch_size),
                "voc_type": t.voc_type, "up_scale_factor": self.scale_factor,
                "best_history_res": dict(tracker.best_history_acc), "best_model_info": tracker.best_model_info}

    def _run_val(self, state: TrainState, val_data: Sequence[Loader], logger: ScalarLogger,
                 iters: int) -> Dict[str, Dict[str, float]]:
        """Evaluate every val split; {split: metric_dict} in order."""
        t = self.config.TRAIN
        models = self._eval_models(state, self._eval_recognizer())
        kw = {"vis_dir": self.vis_dir, "n_vis": int(t.VAL.get("n_vis", 10))} if self.args.get("go_test") else {}
        mds = {}
        for d, loader in zip(t.VAL.val_data_dir, val_data):
            name = split_name(d)
            if self.args.get("random_reso"):
                md = self._run_val_random_reso(models, loader)
            else:
                md = evaluate(self._eval_step, models, loader, decoder=self._decoder(), **kw)
            if self.primary:
                print(f"  [val {name}] acc={md['accuracy']:.4f} (lr={md['accuracy_lr']:.4f} "
                      f"hr={md['accuracy_hr']:.4f}) psnr={md['psnr_avg']:.2f} ssim={md['ssim_avg']:.4f}", flush=True)
            for k in ("psnr_avg", "ssim_avg", "accuracy"):
                logger.add_scalar(f"eval/{k}_{name}", md[k], iters)
            mds[name] = md
        return mds

    def _run_val_random_reso(self, models: EvalModels, loader: Loader) -> Dict[str, float]:
        """One split's ``--random_reso`` val (tpgsr_tpu/train/trainer.py:654-710):
        for a prior arch its students give the gate and the priors and its
        teacher reads SR, LR and HR; for a plain arch the eval CRNN does all
        three.  The CRNNs read ``parse_crnn_data`` at width 100, whatever
        TRAIN.width; CTC decodes their logits."""
        in_ch = check_arch(self.arch).in_channels
        sr_share, tpg_share = bool(self.args.get("sr_share")), bool(self.args.get("tpg_share"))

        def reads(model: torch.nn.Module) -> Callable:
            return lambda x: model(parse_crnn_data(x).permute(0, 3, 1, 2))

        def sr_apply(model: torch.nn.Module) -> Callable:
            def run(lr: torch.Tensor, prior: torch.Tensor) -> torch.Tensor:
                lr_in = lr[..., :in_ch].permute(0, 3, 1, 2)
                out = model(lr_in, prior.permute(0, 3, 1, 2)) if self.is_tl else model(lr_in)
                return (out[0] if isinstance(out, tuple) else out).permute(0, 2, 3, 1)
            return run

        if self.is_tl:
            rec = reads(models.teacher)
            stu = [reads(models.stu[0 if tpg_share else i]) for i in range(self.stu_iter)]
        else:
            rec = reads(models.rec)
            stu = [rec] * self.stu_iter
        return evaluate_random_reso_loader(
            loader, stu, [sr_apply(models.sr[0 if sr_share else i]) for i in range(self.stu_iter)], rec,
            decode_crnn, stu_iter=self.stu_iter, conf_threshold=conf_threshold_of(self.arch), is_tl=self.is_tl,
            device=self.device)

    # ------------------------------------------------------------------ test
    def test(self) -> Dict[str, float]:
        """Eval over TEST.test_data_dir (``--test``), fed the LR as the JAX
        package does (the reference feeds HR, super_resolution.py:1381), read
        by the recognizer of ``--rec`` (super_resolution.py:1360-1370): one
        warm batch, then a timed pass; its metric dict with ``fps``."""
        self._check_world()
        (loader,) = self.get_val_data([self.config.TEST.test_data_dir])
        state = self._state if self._state is not None else self.init_state()
        self.args["test_model"] = eval_rec_kind(self.args)
        self._build_steps(with_train=False)
        models = self._eval_models(state, self._eval_recognizer())
        decoder = self._decoder()
        evaluate(self._eval_step, models, loader, max_batches=1, decoder=decoder)
        t0 = time.time()
        md = evaluate(self._eval_step, models, loader, decoder=decoder)
        md["fps"] = md["images"] / (time.time() - t0)
        if self.primary:
            print({k: round(v, 4) if isinstance(v, float) else v for k, v in md.items()}, flush=True)
        return md

    # ------------------------------------------------------------------ demo
    def demo(self) -> List[tuple]:
        """SR each image of ``--demo_dir`` at batch 1 and read LR and SR;
        returns [(file, LR string, SR string)] in file order."""
        t = self.config.TRAIN
        state = self._state if self._state is not None else self.init_state()
        self._build_steps(with_train=False)
        models = self._eval_models(state, self._eval_recognizer())
        size = (int(t.width) // self.scale_factor, int(t.height) // self.scale_factor)
        preds = []
        t0 = time.time()
        for fn in sorted(os.listdir(self.args["demo_dir"])):
            try:
                img = Image.open(os.path.join(self.args["demo_dir"], fn))
            except OSError:  # not an image
                continue
            lr = resize_normalize(img, size, bool(self.args.get("mask")))[None]
            # hr is read by no output the demo uses: zeros at the HR size
            batch = {"lr": lr, "hr": np.zeros((1, int(t.height), int(t.width), lr.shape[-1]), np.float32)}
            _, outs = self._eval_step(models, batch)
            pred_sr, pred_lr = decode_crnn(outs["logits_sr"])[0], decode_crnn(outs["logits_lr"])[0]
            print(f"{fn}: LR='{pred_lr}' SR='{pred_sr}'", flush=True)
            preds.append((fn, pred_lr, pred_sr))
        if preds:
            print(f"fps={len(preds) / (time.time() - t0):.2f}", flush=True)
        return preds
