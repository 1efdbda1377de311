"""ResNet34 (He et al. 2016, torchvision's v1 layout) and EfficientNet-B3
(Tan & Le 2019) as plain functions of a dictionary of tensors, and the
tables of their parameters.

The names are those of the program's state dict, so the same dictionary
loads into the program (`load_state_dict(strict=True)` checks every name
and shape) and feeds the reference. Batch normalization runs in eval mode
from the running statistics, or with `train=True` from the batch's
(biased) statistics, moving the running ones by 0.1 towards them.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import math

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
BN_MOMENTUM = 0.1
RESNET34 = (3, 4, 6, 3)
N_FEATURES = 512

Param = Tuple[str, Tuple[int, ...], str]  # name, shape, kind


def _bn(prefix: str, c: int) -> List[Param]:
    return [(f"{prefix}.weight", (c,), "bn_weight"), (f"{prefix}.bias", (c,), "bn_bias"),
            (f"{prefix}.running_mean", (c,), "bn_mean"),
            (f"{prefix}.running_var", (c,), "bn_var"),
            (f"{prefix}.num_batches_tracked", (), "count")]


def _blocks(layers=RESNET34):
    """(index, in, out, stride, has projection) of each basic block."""
    out, i, inplanes = [], 0, 64
    for stage, (planes, n) in enumerate(zip((64, 128, 256, 512), layers)):
        for j in range(n):
            s = 2 if (stage > 0 and j == 0) else 1
            out.append((i, inplanes, planes, s, j == 0 and (s != 1 or inplanes != planes)))
            inplanes = planes
            i += 1
    return out


def resnet34_params(n_inputs: int, prefix: str = "backbone") -> List[Param]:
    p: List[Param] = [(f"{prefix}.conv1.weight", (64, n_inputs, 7, 7), "conv")]
    p += _bn(f"{prefix}.bn1", 64)
    for i, cin, cout, _, proj in _blocks():
        b = f"{prefix}.blocks.{i}"
        p += [(f"{b}.conv1.weight", (cout, cin, 3, 3), "conv")] + _bn(f"{b}.bn1", cout)
        p += [(f"{b}.conv2.weight", (cout, cout, 3, 3), "conv")] + _bn(f"{b}.bn2", cout)
        if proj:
            p += [(f"{b}.downsample.0.weight", (cout, cin, 1, 1), "conv")]
            p += _bn(f"{b}.downsample.1", cout)
    return p


def _batch_norm(P: Dict[str, torch.Tensor], name: str, x: torch.Tensor, train: bool):
    w, b = P[f"{name}.weight"], P[f"{name}.bias"]
    if not train:
        return F.batch_norm(x, P[f"{name}.running_mean"], P[f"{name}.running_var"], w, b,
                            False, 0.0, BN_EPS)
    with torch.no_grad():
        var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
        for key, stat in (("running_mean", mean), ("running_var", var)):
            P[f"{name}.{key}"].mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * stat)
    return F.batch_norm(x, None, None, w, b, True, 0.0, BN_EPS)


def resnet34(P: Dict[str, torch.Tensor], x: torch.Tensor, train: bool = False,
             prefix: str = "backbone", conv=F.conv2d) -> torch.Tensor:
    """Features [B, 512] of images [B, C, H, W]."""
    def conv_bn(name, bn, y, stride, pad):
        return _batch_norm(P, f"{prefix}.{bn}", conv(
            y, P[f"{prefix}.{name}.weight"], stride=stride, padding=pad), train)

    y = torch.relu(conv_bn("conv1", "bn1", x, 2, 3))
    y = F.max_pool2d(y, 3, 2, padding=1)
    for i, _, _, s, proj in _blocks():
        b = f"blocks.{i}"
        out = torch.relu(conv_bn(f"{b}.conv1", f"{b}.bn1", y, s, 1))
        out = conv_bn(f"{b}.conv2", f"{b}.bn2", out, 1, 1)
        short = conv_bn(f"{b}.downsample.0", f"{b}.downsample.1", y, s, 0) if proj else y
        y = torch.relu(out + short)
    return y.mean(dim=(2, 3))


# EfficientNet-B0's stages: expansion, channels, repeats, stride, kernel
EFFNET_STAGES = ((1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5), (6, 80, 3, 2, 3),
                 (6, 112, 3, 1, 5), (6, 192, 4, 2, 5), (6, 320, 1, 1, 3))
B3 = (1.2, 1.4)  # width, depth


def _round_ch(c: float, width: float) -> int:
    c = c * width
    out = max(8, int(c + 4) // 8 * 8)
    return out + 8 if out < 0.9 * c else out


def _mbconvs(width=B3[0], depth=B3[1]):
    """(index, in, out, expansion, kernel, stride) of each MBConv block."""
    out, i, cin = [], 0, _round_ch(32, width)
    for e, c, r, s, k in EFFNET_STAGES:
        cout = _round_ch(c, width)
        for j in range(int(math.ceil(r * depth))):
            out.append((i, cin, cout, e, k, s if j == 0 else 1))
            cin, i = cout, i + 1
    return out


def effnet_features(width=B3[0]) -> int:
    return _round_ch(1280, width)


def effnet_b3_params(n_inputs: int, prefix: str = "backbone") -> List[Param]:
    stem = _round_ch(32, B3[0])
    p: List[Param] = [(f"{prefix}.conv_stem.weight", (stem, n_inputs, 3, 3), "conv")]
    p += _bn(f"{prefix}.bn_stem", stem)
    for i, cin, cout, e, k, _ in _mbconvs():
        b, mid, se = f"{prefix}.blocks.{i}", cin * e, max(1, int(cin * 0.25))
        if e != 1:
            p += [(f"{b}.expand_conv.weight", (mid, cin, 1, 1), "conv")] + _bn(f"{b}.bn0", mid)
        p += [(f"{b}.depthwise.weight", (mid, 1, k, k), "conv")] + _bn(f"{b}.bn1", mid)
        p += [(f"{b}.se_reduce.weight", (se, mid, 1, 1), "conv"), (f"{b}.se_reduce.bias", (se,), "zero"),
              (f"{b}.se_expand.weight", (mid, se, 1, 1), "conv"), (f"{b}.se_expand.bias", (mid,), "zero"),
              (f"{b}.project.weight", (cout, mid, 1, 1), "conv")] + _bn(f"{b}.bn2", cout)
    head = effnet_features()
    p += [(f"{prefix}.conv_head.weight", (head, _mbconvs()[-1][2], 1, 1), "conv")]
    return p + _bn(f"{prefix}.bn_head", head)


def effnet_b3(P: Dict[str, torch.Tensor], x: torch.Tensor, train: bool = False,
              prefix: str = "backbone", conv=F.conv2d) -> torch.Tensor:
    """Features [B, 1536]: 3x3/2 stem, 26 MBConv blocks (1x1 expansion,
    depthwise k x k carrying the stride, squeeze-excitation from a quarter
    of the block's input channels, 1x1 projection, the residual where the
    shape is kept), 1x1 head, global average pool; SiLU activations."""
    def bn(name, y):
        return _batch_norm(P, f"{prefix}.{name}", y, train)

    def w(name):
        return P[f"{prefix}.{name}.weight"]

    y = F.silu(bn("bn_stem", conv(x, w("conv_stem"), stride=2, padding=1)))
    for i, cin, cout, e, k, s in _mbconvs():
        b = f"blocks.{i}"
        h = F.silu(bn(f"{b}.bn0", conv(y, w(f"{b}.expand_conv")))) if e != 1 else y
        h = F.silu(bn(f"{b}.bn1", conv(h, w(f"{b}.depthwise"), stride=s, padding=k // 2,
                                       groups=h.shape[1])))
        g = h.mean(dim=(2, 3), keepdim=True)
        g = F.silu(conv(g, w(f"{b}.se_reduce"), bias=P[f"{prefix}.{b}.se_reduce.bias"]))
        g = torch.sigmoid(conv(g, w(f"{b}.se_expand"), bias=P[f"{prefix}.{b}.se_expand.bias"]))
        h = bn(f"{b}.bn2", conv(h * g, w(f"{b}.project")))
        y = h + y if s == 1 and cin == cout else h
    y = F.silu(bn("bn_head", conv(y, w("conv_head"))))
    return y.mean(dim=(2, 3))
