"""ASTER, the attention recognizer that scores SR output by default
(counterpart of tpgsr_tpu/models/aster.py; reference
model/recognizer/resnet_aster.py:38-135, attention_recognition_head.py:11-268
and recognizer_builder.py:27-104).

NCHW, with the original's keys, so that ``aster_demo.pth.tar`` loads and a
port ``state_dict`` goes through the JAX package's ``import_aster``
(tpgsr_tpu/interop/torch_import.py:195) unchanged:

* ``stn_head.*``: the recognizer variant of the STN head (all five pools
  2x2, 3 channels, a 32x64 input);
* ``encoder.layer0.{0,1}`` (conv, BatchNorm), ``encoder.layer{1..5}.{i}``
  (``AsterBlock``: ``conv1``, ``bn1``, ``conv2``, ``bn2``,
  ``downsample.{0,1}``) and ``encoder.rnn``, a 2-layer bidirectional
  ``nn.LSTM(512, 256)``;
* ``decoder.decoder.*``: ``attention_unit.{sEmbed,xEmbed,wEmbed}``,
  ``tgt_embedding`` (one row more than the classes: <BOS>), ``gru`` (one
  torch-GRU step a decode step, gate order r, z, n) and ``fc``.

The original's TPS keeps constant buffers (``tps.*``); the port builds them
from the sizes (``models.stn``), and ``ORIGINAL_CONSTANTS`` names what a
loader may drop.  The decode loops are Python loops over ``max_len`` steps of
stock torch ops; ``xEmbed`` of the encoder features, the same at every step,
is computed once before the loop.  Beam search follows the JAX package's
vectorized form (tpgsr_tpu/models/aster.py:207-272): b x k beams flattened,
the top k of k x C candidates a step, finished beams frozen at zero cost,
backtracking from the best last-step beam.
"""

from __future__ import annotations

import string
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from tpgsr_tpu_torch.models.layers import init_torch_defaults_
from tpgsr_tpu_torch.models.stn import STNHead, TPSSpatialTransformer
from tpgsr_tpu_torch.ops.resize import interpolate_bilinear

# (planes, blocks, stride) of encoder.layer1..5: 32x100 -> 1x25
_STAGES = ((32, 3, (2, 2)), (64, 4, (2, 2)), (128, 6, (2, 1)), (256, 6, (2, 1)), (512, 3, (2, 1)))
ORIGINAL_CONSTANTS = ("tps.",)


class AsterBlock(nn.Module):
    """conv1x1(stride)-BN-ReLU-conv3x3-BN plus the residual, through a
    conv1x1(stride)-BN ``downsample`` in a stage's first block."""

    def __init__(self, c_in: int, planes: int, stride=(1, 1), downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(c_in, planes, 1, stride, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = (nn.Sequential(nn.Conv2d(c_in, planes, 1, stride, bias=False), nn.BatchNorm2d(planes))
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(out)) + residual)


class ResNetAster(nn.Module):
    """[B, 3, 32, W] -> [B, W // 4, 512]: the stem, five stages and the BiLSTM."""

    def __init__(self):
        super().__init__()
        self.layer0 = nn.Sequential(nn.Conv2d(3, 32, 3, 1, 1, bias=False), nn.BatchNorm2d(32), nn.ReLU(inplace=True))
        c_in = 32
        for i, (planes, blocks, stride) in enumerate(_STAGES, start=1):
            layer = [AsterBlock(c_in, planes, stride, downsample=True)]
            layer += [AsterBlock(planes, planes) for _ in range(blocks - 1)]
            setattr(self, f"layer{i}", nn.Sequential(*layer))
            c_in = planes
        self.rnn = nn.LSTM(512, 256, num_layers=2, bidirectional=True, batch_first=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(len(_STAGES) + 1):
            x = getattr(self, f"layer{i}")(x)
        if x.shape[2] != 1:
            raise ValueError(f"the encoder must reduce the height to 1, got {x.shape[2]}")
        feats, _ = self.rnn(x.squeeze(2).transpose(1, 2))
        return feats


class AttentionUnit(nn.Module):
    """Additive attention: softmax over T of wEmbed(tanh(xEmbed(x) + sEmbed(s)))."""

    def __init__(self, s_dim: int, x_dim: int, att_dim: int):
        super().__init__()
        self.sEmbed = nn.Linear(s_dim, att_dim)
        self.xEmbed = nn.Linear(x_dim, att_dim)
        self.wEmbed = nn.Linear(att_dim, 1)

    def forward(self, x_proj: torch.Tensor, s_prev: torch.Tensor) -> torch.Tensor:
        """``x_proj`` = xEmbed(x) [B, T, att], s_prev [B, s_dim] -> alpha [B, T]."""
        v = self.wEmbed(torch.tanh(x_proj + self.sEmbed(s_prev)[:, None, :]))
        return torch.softmax(v[..., 0], dim=1)


def gru_step(x: torch.Tensor, h: torch.Tensor, w_ih, w_hh, b_ih, b_hh) -> torch.Tensor:
    """One torch-GRU step, gate order r, z, n, written as the JAX package
    writes it (tpgsr_tpu/models/aster.py:131-138)."""
    i_r, i_z, i_n = F.linear(x, w_ih, b_ih).chunk(3, dim=-1)
    h_r, h_z, h_n = F.linear(h, w_hh, b_hh).chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h


class DecoderUnit(nn.Module):
    """One decode step: attention, the previous symbol's embedding and the
    context through one GRU step, then fc to the classes."""

    def __init__(self, num_classes: int, x_dim: int = 512, s_dim: int = 512, att_dim: int = 512):
        super().__init__()
        self.attention_unit = AttentionUnit(s_dim, x_dim, att_dim)
        self.tgt_embedding = nn.Embedding(num_classes + 1, att_dim)
        self.gru = nn.GRU(att_dim + x_dim, s_dim, batch_first=True)  # its parameters; the step is gru_step
        self.fc = nn.Linear(s_dim, num_classes)

    def forward(self, x: torch.Tensor, x_proj: torch.Tensor, state: torch.Tensor,
                y_prev: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B, T, x_dim], its xEmbed [B, T, att], state [B, s_dim], y_prev
        [B] ids (num_classes is <BOS>) -> (logits [B, C], new state)."""
        alpha = self.attention_unit(x_proj, state)
        context = torch.bmm(alpha[:, None, :], x)[:, 0]
        gru_in = torch.cat([self.tgt_embedding(y_prev), context], dim=-1)
        g = self.gru
        new_state = gru_step(gru_in, state, g.weight_ih_l0, g.weight_hh_l0, g.bias_ih_l0, g.bias_hh_l0)
        return self.fc(new_state), new_state


class BeamResult(NamedTuple):
    """ids [B, max_len] of the best beam; its log-probability [B]; and
    [B] the least gap, over the steps, between the k-th and (k+1)-th
    candidate and, at the end, between the best beam and the next: ids
    computed elsewhere agree wherever this margin exceeds their scores'
    error."""

    ids: torch.Tensor
    scores: torch.Tensor
    margins: torch.Tensor


class AttentionRecognitionHead(nn.Module):
    """Teacher-forced ``forward``, greedy ``sample`` and ``beam_search``."""

    def __init__(self, num_classes: int, in_planes: int = 512, s_dim: int = 512, att_dim: int = 512,
                 max_len: int = 100):
        super().__init__()
        self.num_classes, self.s_dim, self.max_len = num_classes, s_dim, max_len
        self.decoder = DecoderUnit(num_classes, in_planes, s_dim, att_dim)

    def _start(self, x: torch.Tensor, state0: Optional[torch.Tensor] = None):
        """(xEmbed(x), the first state: ``state0`` or zeros, <BOS> ids) for the
        rows of ``x``."""
        b = x.shape[0]
        bos = torch.full((b,), self.num_classes, dtype=torch.long, device=x.device)
        state = x.new_zeros(b, self.s_dim) if state0 is None else state0
        return self.decoder.attention_unit.xEmbed(x), state, bos

    def forward(self, x: torch.Tensor, targets: torch.Tensor, state0: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, T, C], targets [B, L] -> logits [B, L, num_classes], step i
        fed targets[:, i - 1] (<BOS> at step 0).  ``state0`` [B, s_dim] seeds
        the GRU state (SEED's; zeros by default, ASTER's)."""
        x_proj, state, y = self._start(x, state0)
        logits = []
        for i in range(targets.shape[1]):
            out, state = self.decoder(x, x_proj, state, y)
            logits.append(out)
            y = targets[:, i].long()
        return torch.stack(logits, dim=1)

    def sample(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Greedy decode: ([B, max_len] ids, [B, max_len] their probabilities)."""
        x_proj, state, y = self._start(x)
        ids, scores = [], []
        for _ in range(self.max_len):
            logits, state = self.decoder(x, x_proj, state, y)
            probs = torch.softmax(logits, dim=-1)
            y = torch.argmax(probs, dim=-1)
            ids.append(y)
            scores.append(probs.max(dim=-1).values)
        return torch.stack(ids, dim=1), torch.stack(scores, dim=1)

    def beam_search(self, x: torch.Tensor, beam_width: int = 5, eos: int = 0,
                    state0: Optional[torch.Tensor] = None) -> BeamResult:
        """The JAX package's vectorized beam search: its ids, with the best
        beam's score and the selection margin (``BeamResult``).  Candidates
        are ranked by a stable sort, so ties go to the lower index, as XLA's
        top-k gives them.  ``state0`` [B, s_dim] seeds every beam of its row
        (SEED's; zeros by default, ASTER's)."""
        b, k, c = x.shape[0], beam_width, self.num_classes
        x_proj, state, _ = self._start(x, state0)
        x_inf, x_proj = x.repeat_interleave(k, dim=0), x_proj.repeat_interleave(k, dim=0)
        state = state.repeat_interleave(k, dim=0)
        y = torch.full((b * k,), c, dtype=torch.long, device=x.device)
        rows = torch.arange(b * k, device=x.device)
        seq_scores = torch.where(rows % k == 0, 0.0, float("-inf")).to(x.dtype)
        pos_index = (torch.arange(b, device=x.device) * k)[:, None]
        eos_row = torch.full((c,), float("-inf"), dtype=x.dtype, device=x.device)
        eos_row[eos] = 0.0
        margins = x.new_full((b,), float("inf"))
        s_scores, s_pred, s_sym = [], [], []
        for _ in range(self.max_len):
            logits, new_state = self.decoder(x_inf, x_proj, state, y)
            logp = torch.log_softmax(logits, dim=-1)
            # a beam that has emitted <EOS> only re-emits it, at zero cost
            logp = torch.where((y == eos)[:, None], eos_row, logp)
            cand = (seq_scores[:, None] + logp).view(b, k * c)
            ranked, order = torch.sort(cand, dim=1, descending=True, stable=True)
            margins = torch.minimum(margins, ranked[:, k - 1] - ranked[:, k])
            candidates = order[:, :k]
            y = (candidates % c).view(-1)
            seq_scores = ranked[:, :k].reshape(-1)
            predecessors = (candidates // c + pos_index).view(-1)
            state = new_state[predecessors]
            s_scores.append(seq_scores)
            s_pred.append(predecessors)
            s_sym.append(y)
        last, best = torch.sort(s_scores[-1].view(b, k), dim=1, descending=True, stable=True)
        margins = torch.minimum(margins, last[:, 0] - last[:, 1])
        t_pred = (best + pos_index).view(-1)
        syms = []
        for sym, pred in zip(reversed(s_sym), reversed(s_pred)):
            syms.append(sym[t_pred])
            t_pred = pred[t_pred]
        ids = torch.stack(syms[::-1]).view(self.max_len, b, k)[:, :, 0].t()
        return BeamResult(ids, last[:, 0], margins)


class RecognizerBuilder(nn.Module):
    """ASTER: STN head on a bilinear (align_corners) 32x64 copy of the input,
    TPS to 32x100 with margins 0.05, the encoder, then beam search."""

    def __init__(self, rec_num_classes: int, eos_id: int, s_dim: int = 512, att_dim: int = 512,
                 max_len_labels: int = 100, beam_width: int = 5):
        super().__init__()
        self.eos_id, self.beam_width = eos_id, beam_width
        self.encoder = ResNetAster()
        self.decoder = AttentionRecognitionHead(rec_num_classes, 512, s_dim, att_dim, max_len_labels)
        self.stn_head = STNHead(3, (32, 64), last_pool=(2, 2))
        self.tps = TPSSpatialTransformer((32, 100))

    def init_from_(self, generator: torch.Generator) -> "RecognizerBuilder":
        """The JAX package's draws (tpgsr_tpu/models/aster.py): torch's
        default ranges for convs, linears and recurrent weights, N(0, 1) for
        the target embedding, the STN head's own init, BatchNorm at its
        defaults."""
        return init_torch_defaults_(self, generator)

    def rectify(self, x: torch.Tensor) -> torch.Tensor:
        """[B, 3, 32, 128] in [-1, 1] -> the rectified [B, 3, 32, 100]."""
        _, ctrl_points = self.stn_head(interpolate_bilinear(x, (32, 64), align_corners=True))
        return self.tps(x, ctrl_points)[0]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, 3, 32, 128] in [-1, 1] (parse_aster_data) -> beam-search ids
        [B, max_len_labels]."""
        return self.decoder.beam_search(self.encoder(self.rectify(x)), self.beam_width, self.eos_id).ids


def decode_aster_ids(ids, aster_info) -> List[str]:
    """ids [B, L] -> strings (reference utils/metrics.py:20-68): stop at EOS,
    skip UNKNOWN, keep alphanumerics, lowercase.  As in the original's
    ``_normalize_text``, which tests tokens by substring, a multi-character
    token such as 'PADDING' drops whole."""
    ids = ids.detach().cpu().numpy() if isinstance(ids, torch.Tensor) else np.asarray(ids)
    keep = set(string.digits + string.ascii_letters)
    end = aster_info.char2id[aster_info.EOS]
    unk = aster_info.char2id[aster_info.UNKNOWN]
    out = []
    for row in ids:
        chars = []
        for v in row.tolist():
            if v == end:
                break
            tok = aster_info.id2char[v]
            if v != unk and len(tok) == 1 and tok in keep:
                chars.append(tok)
        out.append("".join(chars).lower())
    return out
