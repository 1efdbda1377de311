"""The detector of the CosyPose cell in plain PyTorch: FCOS (Tian et al.,
ICCV 2019) on a ResNet50-FPN (v1.5 bottlenecks, P3-P7), with YOLACT's
prototype masks (Bolya et al., ICCV 2019), its decoding (top 256 of
sigmoid(class) x sigmoid(centerness), distances to boxes) and class-aware
greedy NMS down to a fixed number of detections.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.nets import Param, _batch_norm, _bn

STRIDES = (8, 16, 32, 64, 128)
RESNET50 = (3, 4, 6, 3)


def _bottlenecks():
    """(stage, block, in, width, stride, has projection)."""
    out, cin = [], 64
    for s, (planes, n) in enumerate(zip((64, 128, 256, 512), RESNET50)):
        for b in range(n):
            out.append((s, b, cin, planes, (1 if s == 0 else 2) if b == 0 else 1, b == 0))
            cin = planes * 4
    return out


def fcos_params(n_classes: int, channels: int = 256, n_prototypes: int = 16,
                head_depth: int = 2) -> List[Param]:
    p: List[Param] = [("backbone.conv1.weight", (64, 3, 7, 7), "conv")] + _bn("backbone.bn1", 64)
    for s, b, cin, w, _, proj in _bottlenecks():
        n = f"backbone.stages.{s}.{b}"
        p += [(f"{n}.conv1.weight", (w, cin, 1, 1), "conv")] + _bn(f"{n}.bn1", w)
        p += [(f"{n}.conv2.weight", (w, w, 3, 3), "conv")] + _bn(f"{n}.bn2", w)
        p += [(f"{n}.conv3.weight", (4 * w, w, 1, 1), "conv")] + _bn(f"{n}.bn3", 4 * w)
        if proj:
            p += [(f"{n}.downsample.0.weight", (4 * w, cin, 1, 1), "conv")]
            p += _bn(f"{n}.downsample.1", 4 * w)
    c = channels

    def conv(name, cout, cin, k, bias="zero"):
        return [(f"{name}.weight", (cout, cin, k, k), "conv"), (f"{name}.bias", (cout,), bias)]

    for lvl, cin in ((3, 512), (4, 1024), (5, 2048)):
        p += conv(f"backbone.lat{lvl}", c, cin, 1)
    for lvl in (3, 4, 5):
        p += conv(f"backbone.smooth{lvl}", c, c, 3)
    p += conv("backbone.p6", c, c, 3) + conv("backbone.p7", c, c, 3)
    for tower in ("cls_tower", "box_tower"):
        for i in range(head_depth):
            p += conv(f"{tower}.{i}", c, c, 3)
    p += conv("cls_head", n_classes, c, 3, bias="cls_prior") + conv("box_head", 4, c, 3)
    p += conv("ctr_head", 1, c, 3) + conv("coef_head", n_prototypes, c, 3)
    p += conv("proto.0", c // 2, c, 3) + conv("proto.1", c // 2, c // 2, 3)
    return p + conv("proto_out", n_prototypes, c // 2, 1)


def _conv(P, name, x, stride=1, padding=None, conv=F.conv2d):
    w = P[f"{name}.weight"]
    pad = w.shape[-1] // 2 if padding is None else padding
    return conv(x, w, bias=P.get(f"{name}.bias"), stride=stride, padding=pad)


def forward(P: Dict[str, torch.Tensor], images: torch.Tensor, conv=F.conv2d) -> Dict:
    """The detector's outputs of images [B, 3, H, W]: per pyramid location
    (level by level, row-major) class logits, box distances, centerness,
    mask coefficients; prototypes [B, Hp, Wp, n] at stride 4; locations."""
    def cbr(name, bn, x, stride=1, relu=True):
        y = _batch_norm(P, f"backbone.{bn}", _conv(P, f"backbone.{name}", x, stride, conv=conv),
                        False)
        return torch.relu(y) if relu else y

    x = F.max_pool2d(cbr("conv1", "bn1", images, 2), 3, 2, padding=1)
    feats = []
    for s, b, _, _, stride, proj in _bottlenecks():
        n = f"stages.{s}.{b}"
        y = cbr(f"{n}.conv1", f"{n}.bn1", x)
        y = cbr(f"{n}.conv2", f"{n}.bn2", y, stride)
        y = cbr(f"{n}.conv3", f"{n}.bn3", y, relu=False)
        short = cbr(f"{n}.downsample.0", f"{n}.downsample.1", x, stride, relu=False) if proj else x
        x = torch.relu(y + short)
        if b == RESNET50[s] - 1:
            feats.append(x)
    _, c3, c4, c5 = feats
    p5 = _conv(P, "backbone.lat5", c5, conv=conv)
    p4 = _conv(P, "backbone.lat4", c4, conv=conv) + F.interpolate(
        p5, size=c4.shape[-2:], mode="nearest-exact")
    p3 = _conv(P, "backbone.lat3", c3, conv=conv) + F.interpolate(
        p4, size=c3.shape[-2:], mode="nearest-exact")
    p3, p4, p5 = (_conv(P, f"backbone.smooth{i}", p, conv=conv) for i, p in ((3, p3), (4, p4), (5, p5)))
    p6 = _conv(P, "backbone.p6", p5, 2, conv=conv)
    p7 = _conv(P, "backbone.p7", torch.relu(p6), 2, conv=conv)

    def flat(t):
        return t.permute(0, 2, 3, 1).reshape(t.shape[0], -1, t.shape[1])

    out = {k: [] for k in ("cls", "box", "ctr", "coef", "loc")}
    for p, stride in zip((p3, p4, p5, p6, p7), STRIDES):
        c, b = p, p
        for i in (0, 1):
            c = torch.relu(_conv(P, f"cls_tower.{i}", c, conv=conv))
            b = torch.relu(_conv(P, f"box_tower.{i}", b, conv=conv))
        out["cls"].append(flat(_conv(P, "cls_head", c, conv=conv)))
        out["box"].append(flat(torch.exp(_conv(P, "box_head", b, conv=conv)) * stride))
        out["ctr"].append(flat(_conv(P, "ctr_head", b, conv=conv))[..., 0])
        out["coef"].append(flat(torch.tanh(_conv(P, "coef_head", c, conv=conv))))
        h, w = p.shape[-2:]
        u = (torch.arange(w, device=p.device, dtype=torch.float32) + 0.5) * stride
        v = (torch.arange(h, device=p.device, dtype=torch.float32) + 0.5) * stride
        out["loc"].append(torch.stack([u.repeat(h), v.repeat_interleave(w)], dim=-1))
    proto = torch.relu(_conv(P, "proto.0", p3, conv=conv))
    proto = torch.relu(_conv(P, "proto.1", proto, conv=conv))
    proto = F.interpolate(proto, scale_factor=2, mode="bilinear", align_corners=False)
    proto = torch.relu(_conv(P, "proto_out", proto, conv=conv)).permute(0, 2, 3, 1)
    res = {k: torch.cat(v, dim=0 if k == "loc" else 1) for k, v in out.items()}
    res["proto"] = proto
    return res


def candidates(out: Dict, top_k: int = 256):
    """Per image the `top_k` locations by sigmoid(class) x sigmoid(center)
    (a stable descending sort), their boxes, scores and labels (the first
    class among equal probabilities)."""
    probs = torch.sigmoid(out["cls"]) * torch.sigmoid(out["ctr"])[..., None]
    best_p, best_c = probs.max(dim=-1)
    k = min(top_k, best_p.shape[-1])
    top_p, top_i = torch.sort(best_p, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :k], top_i[:, :k]
    loc = out["loc"][top_i]
    d = torch.gather(out["box"], 1, top_i[..., None].expand(-1, -1, 4))
    boxes = torch.stack([loc[..., 0] - d[..., 0], loc[..., 1] - d[..., 1],
                         loc[..., 0] + d[..., 2], loc[..., 1] + d[..., 3]], dim=-1)
    return boxes, top_p, torch.gather(best_c, 1, top_i)


def nms(boxes, scores, labels, iou_threshold: float, max_out: int):
    """Greedy class-aware NMS of one image's candidates (in order of a
    stable descending sort of the scores): indices of the kept, at most
    `max_out`."""
    area = (boxes[:, 2] - boxes[:, 0]).clamp(min=0) * (boxes[:, 3] - boxes[:, 1]).clamp(min=0)
    lo = torch.maximum(boxes[:, None, :2], boxes[None, :, :2])
    hi = torch.minimum(boxes[:, None, 2:], boxes[None, :, 2:])
    wh = (hi - lo).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    iou = inter / torch.clamp(area[:, None] + area[None, :] - inter, min=1e-9)
    suppress = ((iou > iou_threshold) & (labels[:, None] == labels[None, :])).cpu().numpy()
    order = torch.sort(scores, descending=True, stable=True).indices.cpu().numpy()
    alive, keep = np.ones(len(order), bool), []
    for i in order:
        if len(keep) == max_out:
            break
        if alive[i]:
            keep.append(int(i))
            alive &= ~suppress[i]
    return keep
