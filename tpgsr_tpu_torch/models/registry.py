"""The ``--arch`` dispatch (counterpart of tpgsr_tpu/models/registry.py:30-135;
reference interfaces/base.py:293-370).

Each ported arch has an ``ArchSpec``: its model from ``registry_dicts``' two
dicts, its image criterion, the input channels the steps slice from the
batch (3 for srcnn, rdn and the other RGB backbones, which the scripts
still run with ``--mask``; tpgsr_tpu/models/registry.py:55-60), whether it
takes the text prior, and whether it has parameters to train (not
``bicubic``).  ``textzoom_net`` is TSRN with 3 channels, 6 SRBs and hidden
32 whatever ``--srb`` and ``--hd_u`` say (tpgsr_tpu/models/registry.py:109-115).
The JAX package's two other archs raise ``NotImplementedError`` naming
their ``ROADMAP.md`` item.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping, Tuple

import torch.nn as nn

from tpgsr_tpu_torch.models.bicubic import BICUBIC
from tpgsr_tpu_torch.models.edsr import EDSR
from tpgsr_tpu_torch.models.lapsrn import LapSRN
from tpgsr_tpu_torch.models.rdn import RDN, RDN_TL
from tpgsr_tpu_torch.models.rrdb import RRDBNet, RRDBNet_TL
from tpgsr_tpu_torch.models.srcnn import SRCNN, SRCNN_TL
from tpgsr_tpu_torch.models.srresnet import SRResNet, SRResNet_TL
from tpgsr_tpu_torch.models.tsrn import TSRN, TSRN_TL
from tpgsr_tpu_torch.models.vdsr import VDSR, VDSR_TL

# archs trained through the cascade (reference super_resolution.py:44) and
# the TL archs with one student (tpgsr_tpu/models/registry.py:22-26)
ABLATION_SET = ("tsrn_tl_cascade", "srcnn_tl", "srresnet_tl", "rdn_tl", "vdsr_tl")
TL_SIMPLE = ("tsrn_tl", "tsrn_tl_wmask", "esrgan_tl")


@dataclass(frozen=True)
class ArchSpec:
    build: Callable[[Mapping, Mapping], nn.Module]  # (args, cfg) -> model
    crit: str  # 'image' | 'mse' | 'l1' | 'charbonnier'
    in_channels: int  # channels the steps slice from the input and the target
    uses_prior: bool
    trainable: bool = True


def _tsrn(cls):
    return lambda a, c: cls(scale_factor=c["scale_factor"], width=c["width"], height=c["height"], stn=a["STN"],
                            mask=a["mask"], srb_nums=a["srb"], hidden_units=a["hd_u"])


ARCHS = {
    "tsrn": ArchSpec(_tsrn(TSRN), "image", 4, False),
    "tsrn_tl": ArchSpec(_tsrn(TSRN_TL), "image", 4, True),
    "tsrn_tl_wmask": ArchSpec(_tsrn(TSRN_TL), "image", 4, True),
    "tsrn_tl_cascade": ArchSpec(_tsrn(TSRN_TL), "image", 4, True),
    "bicubic": ArchSpec(lambda a, c: BICUBIC(c["scale_factor"]), "mse", 4, False, trainable=False),
    "srcnn": ArchSpec(lambda a, c: SRCNN(c["scale_factor"], 3, a["STN"], c["height"], c["width"]), "mse", 3, False),
    "srres": ArchSpec(lambda a, c: SRResNet(c["scale_factor"], a["STN"], c["width"], c["height"], a["mask"]),
                      "mse", 4, False),
    "rdn": ArchSpec(lambda a, c: RDN(scale_factor=c["scale_factor"]), "l1", 3, False),
    "srcnn_tl": ArchSpec(lambda a, c: SRCNN_TL(c["scale_factor"], 4, a["STN"], c["height"], c["width"]),
                         "mse", 4, True),
    "srresnet_tl": ArchSpec(lambda a, c: SRResNet_TL(c["scale_factor"], a["STN"], c["width"], c["height"], a["mask"]),
                            "mse", 4, True),
    "rdn_tl": ArchSpec(lambda a, c: RDN_TL(scale_factor=c["scale_factor"]), "l1", 4, True),
    "vdsr": ArchSpec(lambda a, c: VDSR(c["scale_factor"], 3), "mse", 3, False),
    "vdsr_tl": ArchSpec(lambda a, c: VDSR_TL(c["scale_factor"], 4, height=c["height"], width=c["width"]),
                        "mse", 4, True),
    "edsr": ArchSpec(lambda a, c: EDSR(c["scale_factor"]), "l1", 3, False),
    "lapsrn": ArchSpec(lambda a, c: LapSRN(c["scale_factor"], 3, a["STN"], c["width"], c["height"]),
                       "charbonnier", 3, False),
    "esrgan": ArchSpec(lambda a, c: RRDBNet(c["scale_factor"]), "l1", 3, False),
    "esrgan_tl": ArchSpec(lambda a, c: RRDBNet_TL(c["scale_factor"]), "l1", 3, True),
    "textzoom_net": ArchSpec(lambda a, c: TSRN(scale_factor=c["scale_factor"], width=c["width"], height=c["height"],
                                               stn=a["STN"], mask=False, srb_nums=6, hidden_units=32),
                             "image", 3, False),
}
PORTED_ARCHS = tuple(ARCHS)
# the JAX package's other archs: ROADMAP.md queue 1 item 7 ports them
NOT_PORTED = ("tsrn_c2f", "sem_tsrn")


def check_arch(arch: str) -> ArchSpec:
    """``arch``'s spec; ``NotImplementedError`` naming its item for an arch
    not ported yet, ``ValueError`` for a name the JAX package lacks too."""
    if arch in ARCHS:
        return ARCHS[arch]
    if arch in NOT_PORTED:
        raise NotImplementedError(f"arch {arch!r} is not ported yet (ROADMAP.md queue 1 item 7); "
                                  f"ported: {', '.join(PORTED_ARCHS)}")
    raise ValueError(f"unknown arch {arch!r}")


def build_model(arch: str, args: Mapping, cfg: Mapping) -> Tuple[nn.Module, ArchSpec]:
    """(the SR model of ``arch``, its spec) from ``registry_dicts``' two
    dicts: ``STN``, ``mask``, ``srb``, ``hd_u`` and the YAML's scale, width
    and height."""
    spec = check_arch(arch)
    return spec.build(args, cfg), spec
