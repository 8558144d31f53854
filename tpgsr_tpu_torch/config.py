"""Configuration: flags over the YAML over defaults (counterpart of
tpgsr_tpu/config.py, of which this module keeps its own copy).

Same flag surface, defaults and choices as the reference's main.py:22-52,
so the ``train_TPGSR-*.sh`` one-liners run unchanged; the packaged YAML
(``configs/super_resolution.yaml``) has the JAX package's keys and values.
``--batch_size``, ``--resume`` and ``--test_data_dir`` override the YAML
(reference interfaces/base.py:216-229).
"""

from __future__ import annotations

import argparse
import os
import shlex
from typing import Any, Optional

import yaml

ARCH_CHOICES = [
    "tsrn", "bicubic", "srcnn", "vdsr", "srres", "esrgan", "rdn", "edsr",
    "lapsrn", "tsrn_tl_wmask", "tsrn_tl_cascade", "srcnn_tl", "srresnet_tl",
    "rdn_tl", "vdsr_tl", "tsrn_tl",
    "tsrn_c2f", "sem_tsrn", "esrgan_tl", "textzoom_net",
]

_DEFAULT_CONFIG = os.path.join(os.path.dirname(__file__), "configs", "super_resolution.yaml")


class AttrDict(dict):
    """Attribute-access dict (the reference's EasyDict)."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    @classmethod
    def deep(cls, obj: Any) -> Any:
        if isinstance(obj, dict):
            return cls({k: cls.deep(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [cls.deep(v) for v in obj]
        return obj


def load_config(path: Optional[str] = None) -> AttrDict:
    """Load a YAML config (the packaged one for ``None`` or its bare name;
    ``config/<path>`` when ``path`` is no file, as main.py:54 joins it)."""
    if path is None or path == "super_resolution.yaml":
        path = _DEFAULT_CONFIG
    elif not os.path.isfile(path) and os.path.isfile(os.path.join("config", path)):
        path = os.path.join("config", path)
    with open(path) as f:
        raw = yaml.safe_load(f)
    return AttrDict.deep(raw or {})


def build_arg_parser() -> argparse.ArgumentParser:
    """The CLI flags of main.py:22-52."""
    p = argparse.ArgumentParser(description="TPGSR (PyTorch port)")
    p.add_argument("--arch", default="tsrn_tl_wmask", choices=ARCH_CHOICES)
    p.add_argument("--go_test", action="store_true", default=False)
    p.add_argument("--test", action="store_true", default=False)
    p.add_argument("--test_data_dir", type=str, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--resume", type=str, default=None)
    p.add_argument("--vis_dir", type=str, default=None)
    p.add_argument("--rec", default="aster", choices=["aster", "moran", "crnn"])
    p.add_argument("--STN", action="store_true", default=False)
    p.add_argument("--syn", action="store_true", default=False, help="use synthetic LR")
    p.add_argument("--mixed", action="store_true", default=False, help="mix syn with real LR")
    p.add_argument("--ic15sr", action="store_true", default=False)
    p.add_argument("--mask", action="store_true", default=False)
    p.add_argument("--gradient", action="store_true", default=False)
    p.add_argument("--hd_u", type=int, default=32)
    p.add_argument("--srb", type=int, default=5)
    p.add_argument("--stu_iter", type=int, default=1)
    p.add_argument("--demo", action="store_true", default=False)
    p.add_argument("--demo_dir", type=str, default="./demo")
    p.add_argument("--test_model", type=str, default="CRNN", choices=["ASTER", "CRNN", "MORAN", "SEED"])
    p.add_argument("--sr_share", action="store_true", default=False)
    p.add_argument("--tpg_share", action="store_true", default=False)
    p.add_argument("--use_label", action="store_true", default=False)
    p.add_argument("--use_distill", action="store_true", default=False)
    p.add_argument("--ssim_loss", action="store_true", default=False)
    p.add_argument("--random_reso", action="store_true", default=False)
    p.add_argument("--tpg", type=str, default="CRNN", choices=["CRNN", "OPT"])
    p.add_argument("--config", type=str, default="super_resolution.yaml")
    return p


def script_argv(path: str) -> list:
    """The flags of a one-line ``python3 main.py ...`` train script (the
    repo's ``train_*.sh``), as the shell splits them."""
    with open(path) as f:
        return shlex.split(f.read().strip())[2:]


def default_args(**overrides: Any) -> AttrDict:
    """The arguments of an empty command line, with ``overrides``."""
    d = AttrDict(vars(build_arg_parser().parse_args([])))
    d.update(overrides)
    return d


def tpg_opt() -> AttrDict:
    """The "OPT" text-prior generator's options, hard-coded in main.py:60-75
    (tpgsr_tpu/config.py:104-119): clova's None-ResNet-None-CTC, 37 classes,
    its weights from ``saved_model`` when that file exists."""
    opt = AttrDict(
        Transformation="None",
        FeatureExtraction="ResNet",
        SequenceModeling="None",
        Prediction="CTC",
        num_fiducial=20,
        input_channel=1,
        output_channel=512,
        hidden_size=256,
        saved_model="None-ResNet-None-CTC.pth",
        character="-0123456789abcdefghijklmnopqrstuvwxyz",
    )
    opt["num_class"] = len(opt["character"])
    return opt


def apply_arg_overrides(config: AttrDict, args: AttrDict) -> AttrDict:
    """Flags over the YAML (interfaces/base.py:216-229); edits ``config``."""
    if args.get("batch_size"):
        config.TRAIN.batch_size = args["batch_size"]
    if args.get("resume"):
        config.TRAIN.resume = args["resume"]
    if args.get("test_data_dir"):
        config.TEST.test_data_dir = args["test_data_dir"]
    return config


def registry_dicts(config: AttrDict, args: AttrDict) -> tuple:
    """(args_dict, cfg_dict) as ``models.registry.build_model`` takes them."""
    t = config.TRAIN
    cfg = {
        "scale_factor": int(t.get("down_sample_scale", 2)),
        "width": int(t.get("width", 128)),
        "height": int(t.get("height", 32)),
    }
    a = {
        "STN": bool(args.get("STN", False)),
        "mask": bool(args.get("mask", False)),
        "srb": int(args.get("srb", 5)),
        "hd_u": int(args.get("hd_u", 32)),
    }
    return a, cfg
