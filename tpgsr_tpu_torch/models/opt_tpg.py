"""The "OPT" text-prior generator of ``--tpg OPT``: clova's recognizer in
TPGSR's None-ResNet-None-CTC configuration (counterpart of
tpgsr_tpu/models/opt_tpg.py:26-111; reference model/crnn/model.py:25-95,
modules/feature_extraction.py:54-246, main.py:60-75).

The FAN ResNet (``BasicBlock`` stages of [1, 2, 5, 3] blocks with conv-BN
and max-pools between them; stage 3's pool pads the width by 1 on each
side, as clova's ``MaxPool2d(2, (2, 1), (0, 1))``, whose padding never wins
a max), the average over the height, and the ``Prediction`` linear.  Keys
are clova's: ``FeatureExtraction.ConvNet.*`` and ``Prediction.*``, as the
JAX package's ``import_opt`` reads them (tpgsr_tpu/interop/torch_import.py:317-326).

It takes what the CRNN takes, [B, 1, 32, W] gray, and gives what it gives,
[T, B, nclass] logits (T = 26 at a width of 100), so it stands in the
teacher's and the students' place.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

LAYERS = (1, 2, 5, 3)


class BasicBlock(nn.Module):
    """conv3x3-BN-ReLU-conv3x3-BN plus the residual, through a conv1x1-BN
    ``downsample`` where the width changes (feature_extraction.py:117-150)."""

    def __init__(self, inplanes: int, planes: int):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, 1, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = (nn.Sequential(nn.Conv2d(inplanes, planes, 1, 1, bias=False), nn.BatchNorm2d(planes))
                           if inplanes != planes else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(out)) + residual)


class ResNet(nn.Module):
    """The FAN ResNet: [B, 1, 32, W] -> [B, output_channel, 1, W / 4 + 1]."""

    def __init__(self, input_channel: int = 1, output_channel: int = 512):
        super().__init__()
        oc = output_channel
        blocks = (oc // 4, oc // 2, oc, oc)
        self.conv0_1 = nn.Conv2d(input_channel, oc // 16, 3, 1, 1, bias=False)
        self.bn0_1 = nn.BatchNorm2d(oc // 16)
        self.conv0_2 = nn.Conv2d(oc // 16, oc // 8, 3, 1, 1, bias=False)
        self.bn0_2 = nn.BatchNorm2d(oc // 8)
        self.maxpool1 = nn.MaxPool2d(2, 2, 0)
        self.maxpool2 = nn.MaxPool2d(2, 2, 0)
        self.maxpool3 = nn.MaxPool2d(2, (2, 1), (0, 1))
        inplanes = oc // 8
        for i, (planes, n) in enumerate(zip(blocks, LAYERS), start=1):
            setattr(self, f"layer{i}", nn.Sequential(BasicBlock(inplanes, planes),
                                                     *(BasicBlock(planes, planes) for _ in range(n - 1))))
            inplanes = planes
            if i < 4:
                setattr(self, f"conv{i}", nn.Conv2d(planes, planes, 3, 1, 1, bias=False))
                setattr(self, f"bn{i}", nn.BatchNorm2d(planes))
        self.conv4_1 = nn.Conv2d(oc, oc, 2, (2, 1), (0, 1), bias=False)
        self.bn4_1 = nn.BatchNorm2d(oc)
        self.conv4_2 = nn.Conv2d(oc, oc, 2, 1, 0, bias=False)
        self.bn4_2 = nn.BatchNorm2d(oc)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn0_1(self.conv0_1(x)))
        x = F.relu(self.bn0_2(self.conv0_2(x)))
        for i in range(1, 5):
            if i < 4:
                x = getattr(self, f"maxpool{i}")(x)
            x = getattr(self, f"layer{i}")(x)
            if i < 4:
                x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        x = F.relu(self.bn4_1(self.conv4_1(x)))
        return F.relu(self.bn4_2(self.conv4_2(x)))


class FeatureExtractor(nn.Module):
    """clova's ``ResNet_FeatureExtractor``: the ResNet as ``ConvNet``."""

    def __init__(self, input_channel: int = 1, output_channel: int = 512):
        super().__init__()
        self.ConvNet = ResNet(input_channel, output_channel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ConvNet(x)


class OPTModel(nn.Module):
    """None-ResNet-None-CTC: [B, 1, 32, W] -> [T, B, nclass] logits."""

    def __init__(self, nclass: int = 37, output_channel: int = 512):
        super().__init__()
        self.FeatureExtraction = FeatureExtractor(1, output_channel)
        self.Prediction = nn.Linear(output_channel, nclass)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # AdaptiveAvgPool2d((None, 1)) over [B, W, C, H]: the mean over the height
        feats = self.FeatureExtraction(x).mean(dim=2).transpose(1, 2)  # [B, W', C]
        return self.Prediction(feats).transpose(0, 1)  # [T, B, C]
