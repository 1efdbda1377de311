"""CNN backbones (PyTorch port of `happypose_tpu/models/backbones.py`): a
torchvision-style ResNet v1 (the MegaPose backbone), the pre-activation
WideResNet18/34 with a 5x5/s2 stem (the CosyPose backbones),
EfficientNet-B0/B3 (the backbone of CosyPose's published pose models) and
the FlowNetS encoder (DeepIM's), each with a free number of input
channels. On the card the convolutions go to cuDNN, EfficientNet's
depthwise ones to PyTorch's own kernels.

Layout is NCHW, PyTorch's own; the Flax model runs NHWC, and the weight
bridge (`utils/weights_from_jax.py`) converts its kernels.

In train mode BatchNorm follows Flax's (`momentum=0.9`): it normalizes with
the batch's biased variance and moves the running variance towards that
same biased variance, where `nn.BatchNorm2d` would move it towards the
unbiased one (larger by n / (n - 1), 1.3% at a 4x5 map and B = 4). With
a process group bound (`BatchNorm2d.group`, named by the model config's
`bn_axis_name` and bound by the data-parallel train step), train mode
normalizes with the statistics of the batch of every rank: Flax's
`BatchNorm(axis_name=...)`, the reference's `SyncBatchNorm`.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5  # flax.linen.BatchNorm's default epsilon


class _SyncBatchNorm(torch.autograd.Function):
    """Train-mode batch normalization over the union of the batches of every
    rank of `group`; returns (y, mean, biased var) of that global batch.

    Statistics: each rank takes its batch's mean and biased variance in
    float32 (`var_mean`: the mean of squared deviations), and one
    `all_gather` of (mean, var, count) a rank lets every rank merge them
    exactly (Chan's parallel formula). One collective a layer, as summing
    (sum, sum of squares, count) would take, without E[x^2] - E[x]^2's
    cancellation (Flax's formula, whose float32 error at 128 px is 1e-5 of
    the features); two all-reduces (the mean, then the squared deviations)
    would cost a second collective in each of ResNet34's 36 BatchNorms.

    Backward: y depends on the other ranks' inputs through the statistics,
    so the per-channel sums of dy and dy * xhat are summed over the group
    (one `all_reduce`), as `nn.SyncBatchNorm` does. With the train step's
    average of the parameters' gradients over the ranks, N ranks then give
    the gradient of the whole batch's mean loss on one."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        C = x.shape[1]
        xf = x.float()
        var_l, mean_l = torch.var_mean(xf, dim=(0, 2, 3), correction=0)
        local = torch.cat([mean_l, var_l, mean_l.new_full((1,), x.numel() // C)])
        stats = local.new_empty((dist.get_world_size(group), local.numel()))
        dist.all_gather(list(stats.unbind(0)), local, group=group)
        means, variances, counts = stats[:, :C], stats[:, C:2 * C], stats[:, 2 * C:]
        n = counts.sum()
        mean = (counts * means).sum(0) / n
        var = (counts * (variances + (means - mean) ** 2)).sum(0) / n
        y = F.batch_norm(xf, mean, var, weight, bias, False, 0.0, eps)
        ctx.save_for_backward(x, weight, mean, torch.rsqrt(var + eps))
        ctx.group, ctx.n = group, n
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, invstd = ctx.saved_tensors
        C = x.shape[1]
        xhat = (x.float() - mean[:, None, None]) * invstd[:, None, None]
        dyf = dy.float()
        sums = torch.cat([dyf.sum((0, 2, 3)), (dyf * xhat).sum((0, 2, 3))])
        d_bias, d_weight = sums[:C].clone(), sums[C:].clone()
        dist.all_reduce(sums, group=ctx.group)
        dx = (dyf - sums[:C, None, None] / ctx.n - xhat * (sums[C:] / ctx.n)[:, None, None]) \
            * (weight * invstd)[:, None, None]
        return dx.to(x.dtype), d_weight, d_bias, None, None


class BatchNorm2d(nn.BatchNorm2d):
    """`nn.BatchNorm2d` whose train-mode update of the running statistics
    is Flax's: ra = 0.9 ra + 0.1 batch, with the biased batch variance,
    computed in the buffers' dtype (float32 under bfloat16 autocast). Both
    buffers move in one `_foreach_lerp_`; `num_batches_tracked` stays as
    loaded (the momentum is fixed, and Flax keeps no count). The statistics
    take a pass of their own before `F.batch_norm` (cuDNN on the card)
    normalizes: a refiner step is bound by the host's launches, not by
    these bytes.

    `axis_name` names the mesh axis whose ranks share the statistics in
    train mode (None: this rank's batch); `group` is that axis's process
    group while a data-parallel step runs, else None."""

    axis_name: Optional[str] = None
    group: Optional[object] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.group is not None:
            y, mean, var = _SyncBatchNorm.apply(x, self.weight, self.bias, self.eps, self.group)
        else:
            with torch.no_grad():
                var, mean = torch.var_mean(x.to(self.running_mean.dtype), dim=(0, 2, 3),
                                           correction=0)
            y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        with torch.no_grad():
            torch._foreach_lerp_([self.running_mean, self.running_var], [mean, var],
                                 self.momentum)
        return y


def set_bn_axis_name(module: nn.Module, axis_name: Optional[str]) -> None:
    """Name the mesh axis whose ranks every `BatchNorm2d` of `module` syncs
    its train-mode statistics over (the Flax modules' `bn_axis_name`)."""
    for m in module.modules():
        if isinstance(m, BatchNorm2d):
            m.axis_name = axis_name


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


class MBConv(nn.Module):
    """Mobile inverted bottleneck (the EfficientNet block): an optional 1x1
    expansion, a depthwise k x k convolution carrying the stride, a
    squeeze-excite gate sized from the block's input channels, and a 1x1
    projection; the residual only where the shape is kept. No drop-connect,
    as in the JAX package."""

    def __init__(self, in_ch: int, out_ch: int, expand: int, kernel: int, stride: int,
                 se_ratio: float = 0.25):
        super().__init__()
        mid = in_ch * expand
        self.expand_conv = nn.Conv2d(in_ch, mid, 1, bias=False) if expand != 1 else None
        self.bn0 = _bn(mid) if expand != 1 else None
        self.depthwise = nn.Conv2d(mid, mid, kernel, stride, padding=kernel // 2, groups=mid,
                                   bias=False)
        self.bn1 = _bn(mid)
        se_ch = max(1, int(in_ch * se_ratio))
        self.se_reduce = nn.Conv2d(mid, se_ch, 1)
        self.se_expand = nn.Conv2d(se_ch, mid, 1)
        self.project = nn.Conv2d(mid, out_ch, 1, bias=False)
        self.bn2 = _bn(out_ch)
        self.residual = stride == 1 and in_ch == out_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        if self.expand_conv is not None:
            h = F.silu(self.bn0(self.expand_conv(h)))
        h = F.silu(self.bn1(self.depthwise(h)))
        s = h.mean(dim=(2, 3), keepdim=True)
        s = torch.sigmoid(self.se_expand(F.silu(self.se_reduce(s))))
        h = self.bn2(self.project(h * s))
        return h + x if self.residual else h


class EfficientNet(nn.Module):
    """EfficientNet (Tan & Le, ICML'19) with a free number of input
    channels: 3x3/s2 stem, the seven MBConv stages of B0 scaled by
    `width_mult` (channels, rounded as the reference rounds them) and
    `depth_mult` (blocks a stage), a 1x1 head, global average pool.
    Input [B, n_inputs, H, W] -> features [B, n_features]."""

    # (expand, out_ch, n_repeat, stride, kernel) per stage (B0 base)
    STAGES = (
        (1, 16, 1, 1, 3),
        (6, 24, 2, 2, 3),
        (6, 40, 2, 2, 5),
        (6, 80, 3, 2, 3),
        (6, 112, 3, 1, 5),
        (6, 192, 4, 2, 5),
        (6, 320, 1, 1, 3),
    )

    def __init__(self, n_inputs: int, width_mult: float = 1.0, depth_mult: float = 1.0):
        super().__init__()
        self.width_mult = width_mult
        stem = self._round_ch(32)
        self.conv_stem = nn.Conv2d(n_inputs, stem, 3, 2, padding=1, bias=False)
        self.bn_stem = _bn(stem)
        blocks, in_ch = [], stem
        for expand, out_ch, repeats, stride, kernel in self.STAGES:
            out_ch = self._round_ch(out_ch)
            for r in range(int(math.ceil(repeats * depth_mult))):
                blocks.append(MBConv(in_ch, out_ch, expand, kernel, stride if r == 0 else 1))
                in_ch = out_ch
        self.blocks = nn.Sequential(*blocks)
        self.n_features = self._round_ch(1280)
        self.conv_head = nn.Conv2d(in_ch, self.n_features, 1, bias=False)
        self.bn_head = _bn(self.n_features)

    def _round_ch(self, ch: int) -> int:
        ch = ch * self.width_mult
        out = max(8, int(ch + 4) // 8 * 8)
        if out < 0.9 * ch:
            out += 8
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.silu(self.bn_stem(self.conv_stem(x)))
        x = F.silu(self.bn_head(self.conv_head(self.blocks(x))))
        return x.mean(dim=(2, 3))


def EfficientNetB0(n_inputs: int) -> EfficientNet:
    return EfficientNet(n_inputs, width_mult=1.0, depth_mult=1.0)


def EfficientNetB3(n_inputs: int) -> EfficientNet:
    """The backbone of CosyPose's published pose models: a 40-channel stem,
    26 blocks, 1536 features."""
    return EfficientNet(n_inputs, width_mult=1.2, depth_mult=1.4)


class FlowNetS(nn.Module):
    """The FlowNetS contracting path (the 'flownet' pose backbone, DeepIM's
    encoder): ten convolutions, LeakyReLU(0.1), global average pool; a
    convolution has a bias only without BatchNorm. Input [B, n_inputs, H, W]
    -> features [B, 1024]."""

    n_features = 1024
    # (out channels, kernel, stride): conv1, conv2, conv3, conv3_1, ..., conv6_1
    LAYERS = ((64, 7, 2), (128, 5, 2), (256, 5, 2), (256, 3, 1), (512, 3, 2), (512, 3, 1),
              (512, 3, 2), (512, 3, 1), (1024, 3, 2), (1024, 3, 1))

    def __init__(self, n_inputs: int, use_batchnorm: bool = False):
        super().__init__()
        convs, in_ch = [], n_inputs
        for ch, k, s in self.LAYERS:
            convs.append(nn.Conv2d(in_ch, ch, k, s, padding=(k - 1) // 2, bias=not use_batchnorm))
            in_ch = ch
        self.convs = nn.ModuleList(convs)
        self.bns = (nn.ModuleList(_bn(ch) for ch, _, _ in self.LAYERS)
                    if use_batchnorm else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, conv in enumerate(self.convs):
            x = conv(x)
            if self.bns is not None:
                x = self.bns[i](x)
            x = F.leaky_relu(x, 0.1)
        return x.mean(dim=(2, 3))
