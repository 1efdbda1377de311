"""Object detector with instance masks (PyTorch port of
`happypose_tpu/models/detector.py`): an anchor-free FCOS-style dense
detector (Tian et al., ICCV'19) with a YOLACT-style prototype mask branch
(Bolya et al., ICCV'19) on a ResNet50-FPN. Convolutions go to cuDNN on the
card; decoding and NMS keep the JAX package's fixed output shapes.

Outputs keep the JAX package's layouts: per-location tensors are
[B, L, ...] over the pyramid locations, level by level in row-major order,
and the prototypes are channels-last [B, Hp, Wp, n_prototypes].
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from happypose_tpu_torch.models.backbones import _bn, set_bn_axis_name
from happypose_tpu_torch.ops.nms import nms

RESNET50_LAYERS = (3, 4, 6, 3)
_CLS_PRIOR_BIAS = -4.6  # focal-loss prior: sigmoid(-4.6) ~ 0.01
_PROTO_STRIDE = 4.0  # prototypes are at P3/2 = stride 4


class Bottleneck(nn.Module):
    """ResNet v1.5 bottleneck: 1x1, 3x3 (strided), 1x1 (x4), post-activation."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, padding=1, bias=False)
        self.bn2 = _bn(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = _bn(planes * 4)
        self.downsample = (
            nn.Sequential(nn.Conv2d(inplanes, planes * 4, 1, stride, bias=False), _bn(planes * 4))
            if downsample else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + residual)


class ResNet50Trunk(nn.Module):
    """ResNet50 (v1.5 bottlenecks): the trunk both detectors' pyramids share.
    `trunk(x)`: input [B, 3, H, W] -> [C2, C3, C4, C5] (strides 4 to 32)."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, padding=3, bias=False)
        self.bn1 = _bn(64)
        self.maxpool = nn.MaxPool2d(3, 2, padding=1)
        stages = []
        inplanes = 64
        for stage, (planes, n_blocks) in enumerate(zip((64, 128, 256, 512), RESNET50_LAYERS)):
            stride = 1 if stage == 0 else 2
            blocks = []
            for b in range(n_blocks):
                blocks.append(Bottleneck(inplanes, planes, stride if b == 0 else 1, b == 0))
                inplanes = planes * 4
            stages.append(nn.Sequential(*blocks))
        self.stages = nn.ModuleList(stages)

    def trunk(self, x: torch.Tensor):
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        feats = []
        for stage in self.stages:
            x = stage(x)
            feats.append(x)
        return feats


class ResNet50FPN(ResNet50Trunk):
    """ResNet50 backbone + FPN. Input [B, 3, H, W] -> ([P3..P7], C2)."""

    def __init__(self, fpn_channels: int = 256):
        super().__init__()
        c = fpn_channels
        self.lat3 = nn.Conv2d(512, c, 1)
        self.lat4 = nn.Conv2d(1024, c, 1)
        self.lat5 = nn.Conv2d(2048, c, 1)
        self.smooth3 = nn.Conv2d(c, c, 3, padding=1)
        self.smooth4 = nn.Conv2d(c, c, 3, padding=1)
        self.smooth5 = nn.Conv2d(c, c, 3, padding=1)
        self.p6 = nn.Conv2d(c, c, 3, 2, padding=1)
        self.p7 = nn.Conv2d(c, c, 3, 2, padding=1)

    def forward(self, x: torch.Tensor):
        c2, c3, c4, c5 = self.trunk(x)
        # top-down; jax.image.resize's "nearest" samples at half-pixel
        # centres, which is torch's "nearest-exact" (not "nearest") when the
        # ratio is not 2, as for 8x10 -> 15x20 at a 240x320 input
        p5 = self.lat5(c5)
        p4 = self.lat4(c4) + F.interpolate(p5, size=c4.shape[-2:], mode="nearest-exact")
        p3 = self.lat3(c3) + F.interpolate(p4, size=c3.shape[-2:], mode="nearest-exact")
        p3, p4, p5 = self.smooth3(p3), self.smooth4(p4), self.smooth5(p5)
        p6 = self.p6(p5)
        p7 = self.p7(torch.relu(p6))
        return [p3, p4, p5, p6, p7], c2


class ResNet50FPNMaxPool(ResNet50Trunk):
    """The same trunk with Mask R-CNN's pyramid (torchvision's
    `resnet_fpn_backbone` with `LastLevelMaxPool`): a lateral 1x1 and an
    output 3x3 at C2-C5, a nearest-neighbour top-down path (torchvision's
    "nearest"), and P6 = P5 subsampled by a 1x1 max-pool of stride 2.
    Input [B, 3, H, W] -> [P2, P3, P4, P5, P6]."""

    def __init__(self, fpn_channels: int = 256):
        super().__init__()
        c = fpn_channels
        for lvl, cin in ((2, 256), (3, 512), (4, 1024), (5, 2048)):
            self.add_module(f"lat{lvl}", nn.Conv2d(cin, c, 1))
            self.add_module(f"smooth{lvl}", nn.Conv2d(c, c, 3, padding=1))

    def forward(self, x: torch.Tensor):
        feats = self.trunk(x)
        inner = self.lat5(feats[3])
        out = [self.smooth5(inner)]
        for lvl in (4, 3, 2):
            lateral = getattr(self, f"lat{lvl}")(feats[lvl - 2])
            inner = lateral + F.interpolate(inner, size=lateral.shape[-2:], mode="nearest")
            out.insert(0, getattr(self, f"smooth{lvl}")(inner))
        return out + [F.max_pool2d(out[-1], 1, 2, 0)]


@dataclass(frozen=True)
class DetectorConfig:
    n_classes: int  # number of object labels (background-free)
    n_prototypes: int = 16
    fpn_channels: int = 256
    head_depth: int = 2
    strides: Tuple[int, ...] = (8, 16, 32, 64, 128)
    compute_dtype: str = "float32"  # float32 | bfloat16 (the whole network; outputs float32)
    # the mesh axis whose ranks share the BatchNorm statistics in train mode
    bn_axis_name: Optional[str] = None


class DetectorOutputs(NamedTuple):
    cls_logits: torch.Tensor  # [B, L, n_classes] over all pyramid locations
    box_reg: torch.Tensor  # [B, L, 4] distances l, t, r, b (stride-scaled)
    centerness: torch.Tensor  # [B, L]
    mask_coeffs: torch.Tensor  # [B, L, n_proto]
    prototypes: torch.Tensor  # [B, Hp, Wp, n_proto] (P3/2 resolution)
    locations: torch.Tensor  # [L, 2] (u, v) pixel centres
    level_ids: torch.Tensor  # [L]


def _flat(x: torch.Tensor) -> torch.Tensor:
    """[B, C, h, w] -> [B, h*w, C] (row-major locations)."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, x.shape[1])


class FCOSDetector(nn.Module):
    def __init__(self, cfg: DetectorConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg.fpn_channels
        self.backbone = ResNet50FPN(c)
        self.cls_tower = nn.ModuleList(nn.Conv2d(c, c, 3, padding=1) for _ in range(cfg.head_depth))
        self.box_tower = nn.ModuleList(nn.Conv2d(c, c, 3, padding=1) for _ in range(cfg.head_depth))
        self.cls_head = nn.Conv2d(c, cfg.n_classes, 3, padding=1)
        self.box_head = nn.Conv2d(c, 4, 3, padding=1)
        self.ctr_head = nn.Conv2d(c, 1, 3, padding=1)
        self.coef_head = nn.Conv2d(c, cfg.n_prototypes, 3, padding=1)
        self.proto = nn.ModuleList([nn.Conv2d(c, c // 2, 3, padding=1),
                                    nn.Conv2d(c // 2, c // 2, 3, padding=1)])
        self.proto_out = nn.Conv2d(c // 2, cfg.n_prototypes, 1)
        set_bn_axis_name(self.backbone, cfg.bn_axis_name)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "FCOSDetector":
        """Fresh seeded weights: LeCun-normal convolutions (the Flax
        default), zero biases, unit BatchNorm, and the classifier's focal
        prior bias of -4.6."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                m.weight.copy_(
                    torch.randn(m.weight.shape, generator=generator) / math.sqrt(m.weight[0].numel())
                )
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
        self.cls_head.bias.fill_(_CLS_PRIOR_BIAS)
        return self

    def forward(self, images: torch.Tensor) -> DetectorOutputs:
        """images: [B, 3, H, W] in [0, 1]. With `compute_dtype="bfloat16"`
        the network runs under bfloat16 autocast (the parameters stay
        float32, as Flax's `dtype=` keeps them) and the outputs come back
        in float32, as the JAX package casts them."""
        if self.cfg.compute_dtype != "bfloat16":
            return self._forward(images)
        with torch.autocast(device_type=images.device.type, dtype=torch.bfloat16):
            out = self._forward(images)
        return DetectorOutputs(*(x.float() if x.is_floating_point() else x for x in out))

    def _forward(self, images: torch.Tensor) -> DetectorOutputs:
        pyramid, _ = self.backbone(images)
        all_cls, all_box, all_ctr, all_coef, all_loc, all_lvl = [], [], [], [], [], []
        for lvl, (p, stride) in enumerate(zip(pyramid, self.cfg.strides)):
            c = p
            for conv in self.cls_tower:
                c = torch.relu(conv(c))
            b = p
            for conv in self.box_tower:
                b = torch.relu(conv(b))
            all_cls.append(_flat(self.cls_head(c)))
            all_box.append(_flat(torch.exp(self.box_head(b)) * stride))  # positive distances
            all_ctr.append(_flat(self.ctr_head(b))[..., 0])
            all_coef.append(_flat(torch.tanh(self.coef_head(c))))
            Hl, Wl = p.shape[-2:]
            uu = (torch.arange(Wl, device=p.device, dtype=torch.float32) + 0.5) * stride
            vv = (torch.arange(Hl, device=p.device, dtype=torch.float32) + 0.5) * stride
            all_loc.append(torch.stack([uu.repeat(Hl), vv.repeat_interleave(Wl)], dim=-1))
            all_lvl.append(torch.full((Hl * Wl,), lvl, dtype=torch.int64, device=p.device))

        # prototype masks from P3, upsampled 2x (bilinear, half-pixel centres)
        proto = pyramid[0]
        for conv in self.proto:
            proto = torch.relu(conv(proto))
        proto = F.interpolate(proto, scale_factor=2, mode="bilinear", align_corners=False)
        proto = torch.relu(self.proto_out(proto)).permute(0, 2, 3, 1)

        return DetectorOutputs(
            cls_logits=torch.cat(all_cls, dim=1),
            box_reg=torch.cat(all_box, dim=1),
            centerness=torch.cat(all_ctr, dim=1),
            mask_coeffs=torch.cat(all_coef, dim=1),
            prototypes=proto,
            locations=torch.cat(all_loc, dim=0),
            level_ids=torch.cat(all_lvl, dim=0),
        )


# ----------------------------------------------------------------------
# Inference: decode + NMS (fixed output shapes)
# ----------------------------------------------------------------------


def decode_boxes(locations: torch.Tensor, box_reg: torch.Tensor) -> torch.Tensor:
    """FCOS distances (l, t, r, b) -> (x1, y1, x2, y2)."""
    u, v = locations[..., 0], locations[..., 1]
    l, t, r, b = box_reg.unbind(-1)
    return torch.stack([u - l, v - t, u + r, v + b], dim=-1)


def nms_fixed(
    boxes: torch.Tensor, scores: torch.Tensor, labels: torch.Tensor,
    iou_threshold: float = 0.5, max_out: int = 32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Class-aware greedy NMS over a fixed candidate budget, batched over
    leading dims: boxes [..., N, 4], scores / labels [..., N].

    Returns (keep_idx [..., max_out], keep_valid [..., max_out]): the JAX
    `fori_loop`'s scan, in the order of a stable descending sort of the
    scores (ties: lowest index first); unused slots hold index 0, invalid.
    It is `ops.nms` with every candidate valid and the labels as groups
    (the card's kernels on a CUDA tensor, `nms_reference` on a CPU one;
    nothing is read to the host). Its IoU is the JAX package's without the
    clamps, in the same float operations and order: on boxes with x2 >= x1
    and y2 >= y1 the area clamps never fire, and the union's (at least
    1e-9) only acts where both areas are under 1e-9 px^2: two zero-area
    boxes give NaN > t and 0 > t, both false. FCOS decodes positive
    distances (exp(.) * stride), so its boxes meet that condition."""
    keep, kv = nms(boxes, scores, labels, torch.ones_like(scores, dtype=torch.bool),
                   iou_threshold, max_out)
    return torch.where(kv, keep, 0), kv


def detector_postprocess(
    out: DetectorOutputs,
    score_threshold: float = 0.3,
    iou_threshold: float = 0.5,
    pre_nms_topk: int = 256,
    max_detections: int = 32,
    mask_threshold: float = 0.5,
) -> Dict[str, torch.Tensor]:
    """Decode one batch of detector outputs into fixed-size detections.

    Returns a dict of [B, max_detections, ...] tensors (boxes, scores,
    labels, valid) and [B, max_detections, Hm, Wm] boolean instance masks
    at prototype resolution, cropped to their boxes."""
    probs = torch.sigmoid(out.cls_logits) * torch.sigmoid(out.centerness)[..., None]
    best_p, best_c = probs.max(dim=-1)  # ties: the first class, as jnp.argmax
    k = min(pre_nms_topk, best_p.shape[-1])
    # jax.lax.top_k: descending, ties lowest index first
    top_p, top_i = torch.sort(best_p, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :k], top_i[:, :k]
    boxes = decode_boxes(out.locations[top_i], torch.gather(
        out.box_reg, 1, top_i[..., None].expand(-1, -1, 4)))
    labels = torch.gather(best_c, 1, top_i)
    keep, kv = nms_fixed(boxes, top_p, labels, iou_threshold, max_detections)

    def take(x):
        idx = keep.reshape(keep.shape + (1,) * (x.ndim - 2))
        return torch.gather(x, 1, idx.expand(*keep.shape, *x.shape[2:]))

    sel_boxes, sel_scores, sel_labels = take(boxes), take(top_p), take(labels)
    sel_valid = kv & (sel_scores > score_threshold)
    n_proto = out.mask_coeffs.shape[-1]
    coeffs = torch.gather(out.mask_coeffs, 1, top_i[..., None].expand(-1, -1, n_proto))
    masks = torch.sigmoid(torch.einsum("bhwp,bnp->bnhw", out.prototypes, take(coeffs)))
    # crop masks to their boxes (YOLACT crop) at prototype scale
    Hm, Wm = masks.shape[-2:]
    mu = (torch.arange(Wm, device=masks.device, dtype=masks.dtype) + 0.5) * _PROTO_STRIDE
    mv = (torch.arange(Hm, device=masks.device, dtype=masks.dtype) + 0.5) * _PROTO_STRIDE
    b = sel_boxes[..., None, None, :]
    in_box = (
        (mu >= b[..., 0]) & (mu <= b[..., 2])
        & (mv[:, None] >= b[..., 1]) & (mv[:, None] <= b[..., 3])
    )
    masks = torch.where(in_box, masks, torch.zeros_like(masks)) > mask_threshold
    return {
        "boxes": sel_boxes, "scores": sel_scores, "labels": sel_labels,
        "valid": sel_valid, "masks": masks,
    }
