"""The ``--arch`` dispatch (counterpart of tpgsr_tpu/models/registry.py,
``build_model`` :133; reference interfaces/base.py:293-370).

Only ``tsrn_tl_cascade``, the flagship's arch, is ported: ``build_model``
raises for every other until the rest of the SR zoo comes
(``ROADMAP.md`` queue 1 item 7).
"""

from __future__ import annotations

from typing import Mapping

import torch.nn as nn

from tpgsr_tpu_torch.models.tsrn import TSRN_TL

# archs trained through the cascade (reference super_resolution.py:44) and
# the TL archs with one student (tpgsr_tpu/models/registry.py:22-26)
ABLATION_SET = ("tsrn_tl_cascade", "srcnn_tl", "srresnet_tl", "rdn_tl", "vdsr_tl")
TL_SIMPLE = ("tsrn_tl", "tsrn_tl_wmask", "esrgan_tl")
PORTED_ARCHS = ("tsrn_tl_cascade",)


def check_arch(arch: str) -> None:
    if arch not in PORTED_ARCHS:
        raise NotImplementedError(f"arch {arch!r} is not ported yet (ROADMAP.md queue 1 item 7); "
                                  f"ported: {', '.join(PORTED_ARCHS)}")


def build_model(arch: str, args: Mapping, cfg: Mapping) -> nn.Module:
    """The SR model of ``arch`` from ``registry_dicts``' two dicts: TSRN_TL
    from ``STN``, ``mask``, ``srb``, ``hd_u`` and the YAML's scale, width
    and height."""
    check_arch(arch)
    return TSRN_TL(scale_factor=cfg["scale_factor"], width=cfg["width"], height=cfg["height"], stn=args["STN"],
                   mask=args["mask"], srb_nums=args["srb"], hidden_units=args["hd_u"])
