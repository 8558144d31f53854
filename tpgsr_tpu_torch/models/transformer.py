"""The annotated-transformer pieces of ``sem_tsrn`` (counterpart of
tpgsr_tpu/models/transformer.py; reference model/model_transformer.py:18-120,
407-446 and model/tsrn.py:511-524).

* ``LayerNorm``: a_2 (x - mean) / (std + eps) + b_2 with the unbiased std and
  eps 1e-6 added to the std, not ``nn.LayerNorm``;
* ``MultiHeadedAttention``: four linears (``linears.0..3``: query, key,
  value, output) around scaled dot-product attention over ``h`` heads,
  written as plain ``torch.matmul`` and softmax, as the JAX package writes it
  with ``einsum``;
* ``PositionwiseFeedForward``: ``w_1``, ReLU, ``w_2``;
* ``FeatureEnhancerW2V``: self-attention and the feed-forward, each with a
  residual and a ``LayerNorm``, over the [B, C, T] features.  The original
  declares a ``w2v_proj`` linear and bypasses it in its forward; the port
  declares it too, so that an original file loads strictly, and never
  calls it;
* ``ImFeat2WordVec``: the features' global average through ``vec_proj``.

Dropout is off, as in the JAX package.  Under bf16 autocast the softmax is
rounded to the scores' dtype, as the JAX package computes it in bf16
(autocast would keep it in fp32).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


class LayerNorm(nn.Module):
    """a_2 * (x - mean) / (std + eps) + b_2 over the last axis, std unbiased."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.a_2 = nn.Parameter(torch.ones(features))
        self.b_2 = nn.Parameter(torch.zeros(features))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(-1, keepdim=True)
        std = x.std(-1, keepdim=True)
        return self.a_2 * (x - mean) / (std + self.eps) + self.b_2


class MultiHeadedAttention(nn.Module):
    """``h``-head scaled dot-product attention with four projections."""

    def __init__(self, h: int = 4, d_model: int = 64):
        super().__init__()
        if d_model % h:
            raise ValueError(f"d_model {d_model} is not a multiple of {h} heads")
        self.h, self.d_k = h, d_model // h
        self.linears = nn.ModuleList([nn.Linear(d_model, d_model) for _ in range(4)])

    def forward(self, query: torch.Tensor, key: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
        """[B, T, d_model] each -> [B, T, d_model]."""
        b = query.shape[0]
        q, k, v = (lin(x).view(b, -1, self.h, self.d_k).transpose(1, 2)
                   for lin, x in zip(self.linears, (query, key, value)))
        scores = torch.matmul(q, k.transpose(-2, -1)) / math.sqrt(self.d_k)
        attn = torch.softmax(scores, dim=-1).to(scores.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, -1, self.h * self.d_k)
        return self.linears[3](out)


class PositionwiseFeedForward(nn.Module):
    def __init__(self, d_model: int, d_ff: int):
        super().__init__()
        self.w_1 = nn.Linear(d_model, d_ff)
        self.w_2 = nn.Linear(d_ff, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w_2(F.relu(self.w_1(x)))


class FeatureEnhancerW2V(nn.Module):
    """Self-attention and feed-forward over [B, C, T] conv features
    (model_transformer.py:407-446); the word vectors are ignored, as the
    original's forward ignores them."""

    def __init__(self, vec_d: int = 300, feature_size: int = 64, head_num: int = 4):
        super().__init__()
        self.mask_multihead = MultiHeadedAttention(head_num, feature_size)
        self.mul_layernorm1 = LayerNorm(feature_size)
        self.pff = PositionwiseFeedForward(feature_size, feature_size)
        self.mul_layernorm3 = LayerNorm(feature_size)
        self.w2v_proj = nn.Linear(vec_d, feature_size)  # declared and bypassed, as in the original

    def forward(self, conv_feature: torch.Tensor, word2vec=None) -> torch.Tensor:
        x = conv_feature.transpose(1, 2)  # [B, T, C]
        x = self.mul_layernorm1(x + self.mask_multihead(x, x, x))
        x = self.mul_layernorm3(x + self.pff(x))
        return x.transpose(1, 2)


class ImFeat2WordVec(nn.Module):
    """[B, C, H, W] -> the global average through ``vec_proj`` [B, vec_d]."""

    def __init__(self, in_channels: int, vec_d: int = 300):
        super().__init__()
        self.vec_proj = nn.Linear(in_channels, vec_d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.vec_proj(x.mean(dim=(2, 3)))
