"""Model FLOPs of the configurations' networks, counted from their layer
tables at the input size: every convolution and linear layer counts
2 x its multiply-accumulates; normalization, activations and pooling count
nothing. The tables follow the published architectures (ResNet: He et
al. 2016, torchvision's layout; EfficientNet: Tan & Le 2019), never the
program's modules or the kernels it launches.
"""

from __future__ import annotations

import math


def _out(n: int, k: int, s: int) -> int:
    """Output length of a 'same'-padded convolution."""
    return (n + s - 1) // s if k > 1 or s > 1 else n


class _Shape:
    def __init__(self, c: int, h: int, w: int):
        self.c, self.h, self.w = c, h, w
        self.macs = 0

    def conv(self, out_c: int, k: int, s: int = 1, groups: int = 1) -> "_Shape":
        h, w = _out(self.h, k, s), _out(self.w, k, s)
        self.macs += h * w * out_c * k * k * self.c // groups
        self.c, self.h, self.w = out_c, h, w
        return self

    def pool(self, s: int) -> "_Shape":
        self.h, self.w = _out(self.h, 3, s), _out(self.w, 3, s)
        return self


def resnet_macs(layers, bottleneck: bool, n_inputs: int, h: int, w: int,
                n_outputs: int = 0) -> int:
    """ResNet v1 (7x7/2 stem, 3x3/2 max-pool, four stages of basic or
    bottleneck blocks, global pool) and a linear head of `n_outputs`."""
    x = _Shape(n_inputs, h, w).conv(64, 7, 2).pool(2)
    widths = (64, 128, 256, 512)
    expansion = 4 if bottleneck else 1
    for stage, (planes, n) in enumerate(zip(widths, layers)):
        for i in range(n):
            s = 2 if (stage > 0 and i == 0) else 1
            c_in, h_in, w_in = x.c, x.h, x.w
            if bottleneck:
                x.conv(planes, 1).conv(planes, 3, s).conv(planes * expansion, 1)
            else:
                x.conv(planes, 3, s).conv(planes, 3)
            if i == 0 and (s != 1 or c_in != planes * expansion):
                x.macs += _out(h_in, 1, s) * _out(w_in, 1, s) * planes * expansion * c_in
    return x.macs + x.c * n_outputs


def _round_filters(c: float, width: float, divisor: int = 8) -> int:
    c *= width
    new = max(divisor, int(c + divisor / 2) // divisor * divisor)
    return int(new + divisor) if new < 0.9 * c else int(new)


# EfficientNet-B0's stages: expansion, kernel, stride, channels, repeats
_EFFNET_B0 = ((1, 3, 1, 16, 1), (6, 3, 2, 24, 2), (6, 5, 2, 40, 2), (6, 3, 2, 80, 3),
              (6, 5, 1, 112, 3), (6, 5, 2, 192, 4), (6, 3, 1, 320, 1))


def efficientnet_macs(width: float, depth: float, n_inputs: int, h: int, w: int,
                      n_outputs: int = 0) -> int:
    """EfficientNet (MBConv blocks with squeeze-excitation at 1/4 of the
    block's input channels, a 1x1 head of 1280 x width) and a linear head."""
    x = _Shape(n_inputs, h, w).conv(_round_filters(32, width), 3, 2)
    for e, k, s, c, r in _EFFNET_B0:
        out_c = _round_filters(c, width)
        for i in range(int(math.ceil(r * depth))):
            c_in = x.c
            mid = c_in * e
            if e != 1:
                x.conv(mid, 1)
            x.conv(mid, k, s if i == 0 else 1, groups=mid)
            se = max(1, int(c_in * 0.25))
            x.macs += 2 * mid * se
            x.conv(out_c, 1)
    x.conv(_round_filters(1280, width), 1)
    return x.macs + x.c * n_outputs


def fcos_macs(n_classes: int, h: int, w: int, channels: int = 256, n_prototypes: int = 16,
              head_depth: int = 2) -> int:
    """FCOS on a ResNet50-FPN (P3-P7, strides 8-128) with YOLACT's
    prototype branch at stride 4: the trunk, the lateral and smoothing
    convolutions, P6-P7, the shared heads at every level, the prototypes."""
    c = channels
    trunk = resnet_macs((3, 4, 6, 3), True, 3, h, w, 0)
    sizes = []
    hh, ww = h, w
    for k, s in ((7, 2), (3, 2), (3, 2), (3, 2), (3, 2)):  # stem, pool, C3, C4, C5
        hh, ww = _out(hh, k, s), _out(ww, k, s)
        sizes.append((hh, ww))
    (h3, w3), (h4, w4), (h5, w5) = sizes[2:]
    h6, w6 = _out(h5, 3, 2), _out(w5, 3, 2)
    h7, w7 = _out(h6, 3, 2), _out(w6, 3, 2)
    levels = [(h3, w3), (h4, w4), (h5, w5), (h6, w6), (h7, w7)]
    fpn = h3 * w3 * c * 512 + h4 * w4 * c * 1024 + h5 * w5 * c * 2048
    fpn += 9 * c * c * (h3 * w3 + h4 * w4 + h5 * w5) + 9 * c * c * (h6 * w6 + h7 * w7)
    per_loc = 9 * c * (2 * head_depth * c + n_classes + 4 + 1 + n_prototypes)
    heads = per_loc * sum(a * b for a, b in levels)
    proto = h3 * w3 * 9 * (c * c // 2 + (c // 2) ** 2) + 4 * h3 * w3 * (c // 2) * n_prototypes
    return trunk + fpn + heads + proto


def forward_flops(backbone: str, n_inputs: int, h: int, w: int, n_outputs: int) -> int:
    """FLOPs (2 x MACs) of one forward of a configuration's network."""
    if backbone == "resnet34":
        macs = resnet_macs((3, 4, 6, 3), False, n_inputs, h, w, n_outputs)
    elif backbone == "resnet50":
        macs = resnet_macs((3, 4, 6, 3), True, n_inputs, h, w, n_outputs)
    elif backbone == "efficientnet_b3":
        macs = efficientnet_macs(1.2, 1.4, n_inputs, h, w, n_outputs)
    else:
        raise ValueError(f"no layer table for backbone {backbone!r}")
    return 2 * macs
