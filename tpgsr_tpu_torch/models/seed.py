"""SEED, the semantics-enhanced ASTER, as an eval recognizer (counterpart of
tpgsr_tpu/models/seed.py:39-116; reference model/SEED/models/model_builder.py:22-120,
embedding_head.py:6-18, attention_recognition_head.py:251-262).

ASTER's encoder (``aster.ResNetAster``), then ``embeder.eEmbed`` takes the
flattened [B, T * C] = [B, 25 * 512] features to a 300-wide semantic vector,
the decoder's ``embed_fc`` takes that to the first GRU state, and ASTER's
beam search (``aster.AttentionRecognitionHead``) decodes from it, every beam
of a row starting from its row's state.  Keys follow the original SEED:
``encoder.*``, ``decoder.decoder.*`` with ``decoder.decoder.embed_fc``, and
``embeder.eEmbed``.  The STN is off, as the trainer builds SEED
(``stn_on=False``).  ``parse_seed_data`` is its input: the RGB resized
bicubic to 32x100 and mapped to [-1, 1] (reference interfaces/base.py:720-756).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from tpgsr_tpu_torch.models.aster import AttentionRecognitionHead, BeamResult, ResNetAster
from tpgsr_tpu_torch.models.layers import init_torch_defaults_
from tpgsr_tpu_torch.ops.resize import interpolate_bicubic

EMBED_DIM = 300


class Embedding(nn.Module):
    """[B, T, C] encoder features -> [B, 300] (embedding_head.py:6-18)."""

    def __init__(self, in_timestep: int = 25, in_planes: int = 512, embed_dim: int = EMBED_DIM):
        super().__init__()
        self.eEmbed = nn.Linear(in_timestep * in_planes, embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.eEmbed(x.reshape(x.shape[0], -1))


class SEEDModelBuilder(nn.Module):
    """The SEED recognizer: encoder, semantic embedding, beam search seeded
    from it."""

    def __init__(self, rec_num_classes: int, eos_id: int, s_dim: int = 512, att_dim: int = 512,
                 max_len_labels: int = 100, time_step: int = 25, beam_width: int = 5):
        super().__init__()
        self.eos_id, self.beam_width = eos_id, beam_width
        self.encoder = ResNetAster()
        self.decoder = AttentionRecognitionHead(rec_num_classes, 512, s_dim, att_dim, max_len_labels)
        self.decoder.decoder.embed_fc = nn.Linear(EMBED_DIM, s_dim)
        self.embeder = Embedding(time_step, 512, EMBED_DIM)

    def init_from_(self, generator: torch.Generator) -> "SEEDModelBuilder":
        """torch's default ranges for convs, linears and recurrent weights,
        N(0, 1) for the target embedding, BatchNorm at its defaults."""
        return init_torch_defaults_(self, generator)

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B, 3, 32, 100] in [-1, 1] -> (features [B, 25, 512], the decoder's
        first state [B, s_dim])."""
        feats = self.encoder(x)
        return feats, self.decoder.decoder.embed_fc(self.embeder(feats))

    def beam_search(self, x: torch.Tensor) -> BeamResult:
        feats, state0 = self.encode(x)
        return self.decoder.beam_search(feats, self.beam_width, self.eos_id, state0=state0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, 3, 32, 100] in [-1, 1] (``parse_seed_data``) -> beam-search ids
        [B, max_len_labels]."""
        return self.beam_search(x).ids


def parse_seed_data(images: torch.Tensor, width: int = 100) -> torch.Tensor:
    """[B, C >= 3, H, W] in [0, 1] -> [B, 3, 32, ``width``] in [-1, 1]."""
    x = interpolate_bicubic(images[:, :3], (32, width))
    return (x - 0.5) / 0.5
