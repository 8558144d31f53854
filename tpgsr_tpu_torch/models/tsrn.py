"""TSRN, TSRN_TL, TSRN_C2F and SEM_TSRN, the recurrent SR backbones
(counterpart of tpgsr_tpu/models/tsrn.py:42-346; reference
model/tsrn.py:18-370).

NCHW, with the reference's keys: ``block1.{0,1}``, ``block{2..srb+1}.*``,
``infoGen.*`` (TSRN_TL), ``block{srb+2}.{0,1}``, ``block{srb+3}.{j}.conv``
and the final ``block{srb+3}.{ups}`` conv; ``coarse_proj`` (TSRN_C2F),
``w2v_proj.vec_proj`` and each block's ``feature_enhancer.*`` (SEM_TSRN).
The head is the original form (upsample conv, PixelShuffle, mish, 9x9 conv
at HR), which equals the JAX package's fused 5x5 LR head of TSRN and TSRN_TL
exactly and is the JAX package's own head of the other two.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn as nn

from tpgsr_tpu_torch.models.layers import GruBlock, UpsampleBlock, mish
from tpgsr_tpu_torch.models.prior import TSRN_PADDINGS, InfoGenP
from tpgsr_tpu_torch.models.stn import STNHead, TPSSpatialTransformer
from tpgsr_tpu_torch.models.transformer import FeatureEnhancerW2V, ImFeat2WordVec
from tpgsr_tpu_torch.ops.resize import interpolate_bilinear


class RecurrentResidualBlock(nn.Module):
    """conv-BN-mish-conv-BN, BiGRU over H on the residual (the H/W transpose
    around ``gru1``), then BiGRU over W on x + residual (reference
    model/tsrn.py:373-394).  With ``text_channels`` the prior map is
    concatenated to the residual before ``gru1`` (model/tsrn.py:397-426)."""

    def __init__(self, channels: int, text_channels: int = 0):
        super().__init__()
        self.conv1 = nn.Conv2d(channels, channels, 3, padding=1)
        self.bn1 = nn.BatchNorm2d(channels)
        self.gru1 = GruBlock(channels + text_channels, channels)
        self.conv2 = nn.Conv2d(channels, channels, 3, padding=1)
        self.bn2 = nn.BatchNorm2d(channels)
        self.gru2 = GruBlock(channels, channels)

    def forward(self, x: torch.Tensor, text_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        residual = mish(self.bn1(self.conv1(x)))
        residual = self.bn2(self.conv2(residual))
        if text_emb is not None:
            residual = torch.cat([residual, text_emb], 1)
        residual = self.gru1(residual.transpose(-1, -2)).transpose(-1, -2)
        return self.gru2(x + residual)


class RecurrentResidualBlockTL(RecurrentResidualBlock):
    """The recurrent block that takes the prior map."""

    def __init__(self, channels: int, text_channels: int):
        super().__init__(channels, text_channels)


# the reference's InfoGen of TSRN (model/tsrn.py:81-108)
InfoGen = functools.partial(InfoGenP, paddings=TSRN_PADDINGS)
# TSRN_TL fuses the prior in SRBs 2..6 only; plain SRBs follow
# (tpgsr_tpu/models/tsrn.py:199-207)
TL_BLOCKS = 5


class TSRN(nn.Module):
    """Baseline TSRN (arch tsrn): ``srb_nums`` plain recurrent blocks.

    With ``stn=True`` the STN head and the TPS transformer rectify the input
    in train mode, at (height, width) / scale, before ``block1``; eval skips
    them (tpgsr_tpu/models/tsrn.py:126-131)."""

    def __init__(self, scale_factor: int = 2, width: int = 128, height: int = 32, stn: bool = False,
                 srb_nums: int = 5, mask: bool = True, hidden_units: int = 32):
        super().__init__()
        self._build(scale_factor, width, height, stn, srb_nums, mask, hidden_units)

    def _build(self, scale_factor, width, height, stn, srb_nums, mask, hidden_units, text_emb=0,
               out_text_channels=0, block=RecurrentResidualBlock, head_extra=0):
        """Register the trunk in the reference's order; with ``text_emb`` the
        first ``TL_BLOCKS`` SRBs take the prior and ``infoGen`` follows the
        SRBs.  ``block(ch)`` builds each other SRB; the upsampling head takes
        ``head_extra`` channels more than the trunk's."""
        self.in_planes = 4 if mask else 3
        self.stn = stn
        self.srb_nums = srb_nums
        ch = 2 * hidden_units
        self.block1 = nn.Sequential(nn.Conv2d(self.in_planes, ch, 9, padding=4), nn.PReLU())
        for i in range(srb_nums):
            setattr(self, f"block{i + 2}", RecurrentResidualBlockTL(ch, out_text_channels)
                    if text_emb and i < TL_BLOCKS else block(ch))
        if text_emb:
            self.infoGen = InfoGenP(text_emb, out_text_channels, TSRN_PADDINGS)
        setattr(self, f"block{srb_nums + 2}", nn.Sequential(nn.Conv2d(ch, ch, 3, padding=1), nn.BatchNorm2d(ch)))
        head_ch = ch + head_extra
        head = [UpsampleBlock(head_ch, 2) for _ in range(int(math.log2(scale_factor)))]
        head.append(nn.Conv2d(head_ch, self.in_planes, 9, padding=4))
        setattr(self, f"block{srb_nums + 3}", nn.Sequential(*head))
        if stn:
            lr_size = (height // scale_factor, width // scale_factor)
            self.tps = TPSSpatialTransformer(lr_size)
            self.stn_head = STNHead(self.in_planes, input_size=lr_size)

    def _rectify(self, x: torch.Tensor) -> torch.Tensor:
        if self.stn and self.training:
            x, _ = self.tps(x, self.stn_head(x)[1])
        return x

    def _trunk(self, x: torch.Tensor, spatial: Optional[torch.Tensor] = None) -> torch.Tensor:
        block1 = self.block1(x)
        b = block1
        for i in range(self.srb_nums):
            block = getattr(self, f"block{i + 2}")
            b = block(b, spatial) if isinstance(block, RecurrentResidualBlockTL) else block(b)
        b = getattr(self, f"block{self.srb_nums + 2}")(b)
        return torch.tanh(getattr(self, f"block{self.srb_nums + 3}")(block1 + b))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, in_planes, h, w] -> [B, in_planes, 2h, 2w]."""
        return self._trunk(self._rectify(x))


class TSRN_TL(TSRN):
    """TSRN with text-prior fusion (archs tsrn_tl / tsrn_tl_cascade): SRBs
    2..6 concatenate the prior map, any beyond them are plain."""

    def __init__(self, scale_factor: int = 2, width: int = 128, height: int = 32, stn: bool = False,
                 srb_nums: int = 5, mask: bool = True, hidden_units: int = 32, text_emb: int = 37,
                 out_text_channels: int = 32):
        nn.Module.__init__(self)
        self.text_emb = text_emb
        self._build(scale_factor, width, height, stn, srb_nums, mask, hidden_units, text_emb, out_text_channels)

    def forward(self, x: torch.Tensor, text_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, in_planes, h, w], text_emb [B, 37, 1, T] -> [B, in_planes, 2h, 2w]."""
        x = self._rectify(x)
        if text_emb is None:
            text_emb = x.new_zeros(x.shape[0], self.text_emb, 1, 26)
        spatial = interpolate_bilinear(self.infoGen(text_emb), (x.shape[2], x.shape[3]), align_corners=True)
        return self._trunk(x, spatial)


class TSRN_C2F(TSRN):
    """Coarse-to-fine TSRN (arch tsrn_c2f; tpgsr_tpu/models/tsrn.py:229-269,
    reference model/tsrn.py:218-283): the plain SRB trunk, ``coarse_proj`` (a
    9x9 conv to ``in_planes`` at LR), and the head over the concatenation
    [block1 + trunk, coarse], so its upsample blocks take ``2 hidden_units +
    in_planes`` channels; it ends in the HR 9x9 conv and tanh."""

    def __init__(self, scale_factor: int = 2, width: int = 128, height: int = 32, stn: bool = False,
                 srb_nums: int = 5, mask: bool = True, hidden_units: int = 32):
        nn.Module.__init__(self)
        in_planes = 4 if mask else 3
        self._build(scale_factor, width, height, stn, srb_nums, mask, hidden_units, head_extra=in_planes)
        self.coarse_proj = nn.Conv2d(2 * hidden_units, in_planes, 9, padding=4)

    def forward(self, x: torch.Tensor):
        """x [B, in_planes, h, w] -> (SR [B, in_planes, 2h, 2w], coarse [B, in_planes, h, w])."""
        x = self._rectify(x)
        block1 = self.block1(x)
        b = block1
        for i in range(self.srb_nums):
            b = getattr(self, f"block{i + 2}")(b)
        b = getattr(self, f"block{self.srb_nums + 2}")(b)
        coarse = self.coarse_proj(b)
        sr = getattr(self, f"block{self.srb_nums + 3}")(torch.cat([block1 + b, coarse], 1))
        return torch.tanh(sr), coarse


class ReasoningResidualBlock(nn.Module):
    """conv-BN-mish-conv-BN, then ``feature_enhancer``'s self-attention over
    the H x W positions, added to x (reference model/tsrn.py:430-461)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = nn.Conv2d(channels, channels, 3, padding=1)
        self.bn1 = nn.BatchNorm2d(channels)
        self.conv2 = nn.Conv2d(channels, channels, 3, padding=1)
        self.bn2 = nn.BatchNorm2d(channels)
        self.feature_enhancer = FeatureEnhancerW2V(300, channels, 4)

    def forward(self, x: torch.Tensor, word_vecs: Optional[torch.Tensor] = None) -> torch.Tensor:
        residual = self.bn2(self.conv2(mish(self.bn1(self.conv1(x)))))
        b, c, h, w = residual.shape
        residual = self.feature_enhancer(residual.reshape(b, c, h * w), word_vecs)
        return x + residual.reshape(b, c, h, w)


class SEM_TSRN(TSRN):
    """Semantic-reasoning TSRN (arch sem_tsrn; tpgsr_tpu/models/tsrn.py:272-346,
    reference model/tsrn.py:286-370): ``ReasoningResidualBlock``s, each after
    ``w2v_proj`` predicts a word vector from its input.  In train mode with
    ``word_vecs`` given the blocks get those, otherwise the predicted ones;
    either way their feature enhancer ignores them."""

    def __init__(self, scale_factor: int = 2, width: int = 128, height: int = 32, stn: bool = False,
                 srb_nums: int = 5, mask: bool = True, hidden_units: int = 32, word_vec_d: int = 300):
        nn.Module.__init__(self)
        self._build(scale_factor, width, height, stn, srb_nums, mask, hidden_units, block=ReasoningResidualBlock)
        self.w2v_proj = ImFeat2WordVec(2 * hidden_units, word_vec_d)

    def forward(self, x: torch.Tensor, word_vecs: Optional[torch.Tensor] = None):
        """x [B, in_planes, h, w] -> (SR [B, in_planes, 2h, 2w], [the
        ``srb_nums`` predicted word vectors, each [B, word_vec_d]])."""
        x = self._rectify(x)
        block1 = self.block1(x)
        b, pred_vecs = block1, []
        for i in range(self.srb_nums):
            pred_vecs.append(self.w2v_proj(b))
            wv = word_vecs if self.training and word_vecs is not None else pred_vecs[-1]
            b = getattr(self, f"block{i + 2}")(b, wv)
        b = getattr(self, f"block{self.srb_nums + 2}")(b)
        return torch.tanh(getattr(self, f"block{self.srb_nums + 3}")(block1 + b)), pred_vecs
