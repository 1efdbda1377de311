"""CNN backbones (PyTorch port of the ResNet and WideResNet parts of
`happypose_tpu/models/backbones.py`): a torchvision-style ResNet v1 (the
MegaPose backbone) and the pre-activation WideResNet18/34 with a 5x5/s2
stem (the CosyPose backbones), each with a free number of input channels.
The convolutions go to cuDNN on the card.

Layout is NCHW, PyTorch's own; the Flax model runs NHWC, and the weight
bridge (`utils/weights_from_jax.py`) converts its kernels.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

BN_EPS = 1e-5  # flax.linen.BatchNorm's default epsilon


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=BN_EPS, momentum=0.1)


class BasicBlockV1(nn.Module):
    """Post-activation residual block (torchvision ResNet v1)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, padding=1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, padding=1, bias=False)
        self.bn2 = _bn(planes)
        self.downsample = (
            nn.Sequential(nn.Conv2d(inplanes, planes, 1, stride, bias=False), _bn(planes))
            if downsample else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + residual)


class ResNet(nn.Module):
    """7x7/s2 stem + BN + ReLU + 3x3/s2 max-pool, four v1 stages, global
    average pool. Input [B, n_inputs, H, W] -> features [B, 512]."""

    n_features = 512

    def __init__(self, layers: Sequence[int], n_inputs: int):
        super().__init__()
        self.conv1 = nn.Conv2d(n_inputs, 64, 7, 2, padding=3, bias=False)
        self.bn1 = _bn(64)
        self.maxpool = nn.MaxPool2d(3, 2, padding=1)
        blocks = []
        inplanes = 64
        for stage, (planes, n_blocks) in enumerate(zip((64, 128, 256, 512), layers)):
            stride = 1 if stage == 0 else 2
            for i in range(n_blocks):
                s = stride if i == 0 else 1
                ds = i == 0 and (s != 1 or inplanes != planes)
                blocks.append(BasicBlockV1(inplanes, planes, s, ds))
                inplanes = planes
        self.blocks = nn.Sequential(*blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        return self.blocks(x).mean(dim=(2, 3))


def ResNet34(n_inputs: int) -> ResNet:
    return ResNet(layers=(3, 4, 6, 3), n_inputs=n_inputs)


class BasicBlockV2(nn.Module):
    """Pre-activation residual block (He et al. 2016, identity mappings).
    The projection shortcut reads the pre-activated input."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.bn1 = _bn(inplanes)
        self.downsample = (
            nn.Conv2d(inplanes, planes, 1, stride, bias=False) if downsample else None
        )
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, padding=1, bias=False)
        self.bn2 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(x))
        residual = x if self.downsample is None else self.downsample(out)
        out = torch.relu(self.bn2(self.conv1(out)))
        return self.conv2(out) + residual


class WideResNet(nn.Module):
    """5x5/s2 stem + BN + ReLU + 3x3/s2 max-pool, four v2 stages of widths
    (64, 128, 256, 512) x `width`, global average pool.
    Input [B, n_inputs, H, W] -> features [B, n_features]."""

    def __init__(self, layers: Sequence[int], n_inputs: int, width: float = 1.0):
        super().__init__()
        config = [int(v * width) for v in (64, 128, 256, 512)]
        self.n_features = config[-1]
        self.conv1 = nn.Conv2d(n_inputs, config[0], 5, 2, padding=2, bias=False)
        self.bn1 = _bn(config[0])
        self.maxpool = nn.MaxPool2d(3, 2, padding=1)
        blocks = []
        inplanes = config[0]
        for stage, (planes, n_blocks) in enumerate(zip(config, layers)):
            stride = 1 if stage == 0 else 2
            for i in range(n_blocks):
                s = stride if i == 0 else 1
                ds = i == 0 and (s != 1 or inplanes != planes)
                blocks.append(BasicBlockV2(inplanes, planes, s, ds))
                inplanes = planes
        self.blocks = nn.Sequential(*blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        return self.blocks(x).mean(dim=(2, 3))


def WideResNet18(n_inputs: int, width: float = 1.0) -> WideResNet:
    return WideResNet(layers=(2, 2, 2, 2), n_inputs=n_inputs, width=width)


def WideResNet34(n_inputs: int, width: float = 1.0) -> WideResNet:
    return WideResNet(layers=(3, 4, 6, 3), n_inputs=n_inputs, width=width)
