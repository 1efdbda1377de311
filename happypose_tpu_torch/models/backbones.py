"""CNN backbones (PyTorch port of the ResNet and WideResNet parts of
`happypose_tpu/models/backbones.py`): a torchvision-style ResNet v1 (the
MegaPose backbone) and the pre-activation WideResNet18/34 with a 5x5/s2
stem (the CosyPose backbones), each with a free number of input channels.
The convolutions go to cuDNN on the card.

Layout is NCHW, PyTorch's own; the Flax model runs NHWC, and the weight
bridge (`utils/weights_from_jax.py`) converts its kernels.

In train mode BatchNorm follows Flax's (`momentum=0.9`): it normalizes with
the batch's biased variance and moves the running variance towards that
same biased variance, where `nn.BatchNorm2d` would move it towards the
unbiased one (larger by n / (n - 1), 1.3% at a 4x5 map and B = 4).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5  # flax.linen.BatchNorm's default epsilon


class BatchNorm2d(nn.BatchNorm2d):
    """`nn.BatchNorm2d` whose train-mode update of the running statistics
    is Flax's: ra = 0.9 ra + 0.1 batch, with the biased batch variance,
    computed in float32 whatever the input's dtype. Both buffers move in
    one `_foreach_lerp_`; `num_batches_tracked` stays as loaded (the
    momentum is fixed, and Flax keeps no count). The statistics take a
    pass of their own before `F.batch_norm` (cuDNN on the card) normalizes:
    a refiner step is bound by the host's launches, not by these bytes."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), correction=0)
            torch._foreach_lerp_([self.running_mean, self.running_var], [mean, var],
                                 self.momentum)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


def _bn(c: int) -> BatchNorm2d:
    return BatchNorm2d(c, eps=BN_EPS, momentum=0.1)


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
