"""CRNN recognizer: the text-prior generator and the eval recognizer
(counterpart of tpgsr_tpu/models/crnn.py; reference model/crnn/crnn.py:5-90).

7-conv VGG trunk over [B, 1, 32, W] grayscale, then two BiLSTM heads;
output [T, B, nclass] logits (T = 26 at W = 100).  Keys follow the meijieru
CRNN: ``cnn.conv{i}``, ``cnn.batchnorm{i}``, ``rnn.{j}.rnn``, ``rnn.{j}.embedding``.
"""

from __future__ import annotations

import torch
import torch.nn as nn


class BidirectionalLSTM(nn.Module):
    """nn.LSTM(bidirectional) over [T, B, C], then a per-step Linear.

    A bf16 ``x`` (the trunk's output under autocast) runs the LSTM in bf16
    with its fp32 weights cast to bf16, as the JAX layers cast theirs
    (tpgsr_tpu/models/layers.py:259), and autocast off around it: CUDA's
    autocast would run cuDNN's LSTM in fp16 whatever dtype it was given."""

    def __init__(self, n_in: int, hidden: int, n_out: int):
        super().__init__()
        self.rnn = nn.LSTM(n_in, hidden, bidirectional=True)
        self.embedding = nn.Linear(hidden * 2, n_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.float32:
            rec, _ = self.rnn(x)
        else:
            weights = {k: p.to(x.dtype) for k, p in self.rnn.named_parameters()}
            with torch.autocast(x.device.type, enabled=False):
                rec, _ = torch.func.functional_call(self.rnn, weights, (x,))
        return self.embedding(rec)


# (kernel, padding, out_channels, batchnorm) of conv0..conv6
_CONVS = ((3, 1, 64, False), (3, 1, 128, False), (3, 1, 256, True), (3, 1, 256, False),
          (3, 1, 512, True), (3, 1, 512, False), (2, 0, 512, True))


class CRNN(nn.Module):
    def __init__(self, nclass: int = 37, nh: int = 256, nc: int = 1):
        super().__init__()
        cnn = nn.Sequential()
        cin = nc
        for i, (k, p, cout, bn) in enumerate(_CONVS):
            cnn.add_module(f"conv{i}", nn.Conv2d(cin, cout, k, 1, p))
            if bn:
                cnn.add_module(f"batchnorm{i}", nn.BatchNorm2d(cout))
            cnn.add_module(f"relu{i}", nn.ReLU(True))
            if i in (0, 1):
                cnn.add_module(f"pooling{i}", nn.MaxPool2d(2, 2))
            elif i in (3, 5):
                # the W-padded pools of tpgsr_tpu/models/crnn.py:58,61
                cnn.add_module(f"pooling{i // 2 + 1}", nn.MaxPool2d((2, 2), (2, 1), (0, 1)))
            cin = cout
        self.cnn = cnn
        self.rnn = nn.Sequential(BidirectionalLSTM(512, nh, nh), BidirectionalLSTM(nh, nh, nclass))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, 1, 32, W] -> [T, B, nclass]."""
        conv = self.cnn(x)
        if conv.shape[2] != 1:
            raise ValueError(f"the height of conv must be 1, got {conv.shape[2]}")
        return self.rnn(conv.squeeze(2).permute(2, 0, 1))
