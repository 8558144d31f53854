"""The ``--arch`` dispatch (counterpart of tpgsr_tpu/models/registry.py:30-135;
reference interfaces/base.py:293-370).

Each ported arch has an ``ArchSpec``: its model from ``registry_dicts``' two
dicts, its image criterion, the input channels the steps slice from the
batch (3 for srcnn and rdn, which the scripts still run with ``--mask``;
tpgsr_tpu/models/registry.py:55-60), and whether it takes the text prior.
Every other arch of the JAX package raises ``NotImplementedError`` naming
its ``ROADMAP.md`` item.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping, Tuple

import torch.nn as nn

from tpgsr_tpu_torch.models.rdn import RDN, RDN_TL
from tpgsr_tpu_torch.models.srcnn import SRCNN, SRCNN_TL
from tpgsr_tpu_torch.models.srresnet import SRResNet, SRResNet_TL
from tpgsr_tpu_torch.models.tsrn import TSRN, TSRN_TL

# archs trained through the cascade (reference super_resolution.py:44) and
# the TL archs with one student (tpgsr_tpu/models/registry.py:22-26)
ABLATION_SET = ("tsrn_tl_cascade", "srcnn_tl", "srresnet_tl", "rdn_tl", "vdsr_tl")
TL_SIMPLE = ("tsrn_tl", "tsrn_tl_wmask", "esrgan_tl")


@dataclass(frozen=True)
class ArchSpec:
    build: Callable[[Mapping, Mapping], nn.Module]  # (args, cfg) -> model
    crit: str  # 'image' | 'mse' | 'l1'
    in_channels: int  # channels the steps slice from the input and the target
    uses_prior: bool
    trainable: bool = True


def _tsrn(cls):
    return lambda a, c: cls(scale_factor=c["scale_factor"], width=c["width"], height=c["height"], stn=a["STN"],
                            mask=a["mask"], srb_nums=a["srb"], hidden_units=a["hd_u"])


ARCHS = {
    "tsrn": ArchSpec(_tsrn(TSRN), "image", 4, False),
    "tsrn_tl_cascade": ArchSpec(_tsrn(TSRN_TL), "image", 4, True),
    "srcnn": ArchSpec(lambda a, c: SRCNN(c["scale_factor"], 3, a["STN"], c["height"], c["width"]), "mse", 3, False),
    "srres": ArchSpec(lambda a, c: SRResNet(c["scale_factor"], a["STN"], c["width"], c["height"], a["mask"]),
                      "mse", 4, False),
    "rdn": ArchSpec(lambda a, c: RDN(scale_factor=c["scale_factor"]), "l1", 3, False),
    "srcnn_tl": ArchSpec(lambda a, c: SRCNN_TL(c["scale_factor"], 4, a["STN"], c["height"], c["width"]),
                         "mse", 4, True),
    "srresnet_tl": ArchSpec(lambda a, c: SRResNet_TL(c["scale_factor"], a["STN"], c["width"], c["height"], a["mask"]),
                            "mse", 4, True),
    "rdn_tl": ArchSpec(lambda a, c: RDN_TL(scale_factor=c["scale_factor"]), "l1", 4, True),
}
PORTED_ARCHS = tuple(ARCHS)
# the JAX package's other archs: ROADMAP.md queue 1 item 7 ports them
NOT_PORTED = ("tsrn_tl", "tsrn_tl_wmask", "bicubic", "vdsr", "vdsr_tl", "esrgan", "esrgan_tl", "edsr", "lapsrn",
              "tsrn_c2f", "sem_tsrn", "textzoom_net")


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
