"""The detector of the Mask R-CNN cell in plain PyTorch: Mask R-CNN (He et
al., ICCV 2017) on a ResNet50-FPN as torchvision's `MaskRCNN` computes it
with CosyPose's arguments, float32, from a state dict of the program's
names. Greedy NMS is a Python scan, RoIAlign bilinear taps gathered from
the level, the masks pasted one by one with `F.interpolate`.

Departures from torchvision, each also the program's:
- the frame is taken at its size (torchvision's resize to min_size 480,
  max_size 640 is the identity at 480x640); padding to a multiple of 32;
- NMS computes IoUs from the boxes as they are, only within a group
  (torchvision's `batched_nms` offsets the boxes by group); candidates are
  visited in a stable descending sort of the scores (ties: the lower
  index first);
- the box NMS takes the `box_pair_budget` (proposal, class) pairs of the
  highest scores;
- labels come back as class - 1 (object ids).

Where a near-tie could flip a discrete choice (top-k, NMS, the level of a
box, a thresholded pixel), the comparisons give the reference the
program's choices: `select_proposals` and `select_detections` run on the
numbers given, and the heads on the boxes given.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.fcos import _bottlenecks
from benchmark.reference.nets import Param, _batch_norm, _bn

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
CLIP = math.log(1000.0 / 16)


# ---------------------------------------------------------------- weights


def trunk_params(channels: int) -> List[Param]:
    """The trunk and the P2-P5 pyramid, in `benchmark.world.make_weights`'
    kinds: LeCun-normal convolutions, batch norms near the identity, zero
    biases."""
    p: List[Param] = [("backbone.conv1.weight", (64, 3, 7, 7), "conv")] + _bn("backbone.bn1", 64)
    for s, b, cin, w, _, proj in _bottlenecks():
        n = f"backbone.stages.{s}.{b}"
        p += [(f"{n}.conv1.weight", (w, cin, 1, 1), "conv")] + _bn(f"{n}.bn1", w)
        p += [(f"{n}.conv2.weight", (w, w, 3, 3), "conv")] + _bn(f"{n}.bn2", w)
        p += [(f"{n}.conv3.weight", (4 * w, w, 1, 1), "conv")] + _bn(f"{n}.bn3", 4 * w)
        if proj:
            p += [(f"{n}.downsample.0.weight", (4 * w, cin, 1, 1), "conv")]
            p += _bn(f"{n}.downsample.1", 4 * w)
    for lvl, cin in ((2, 256), (3, 512), (4, 1024), (5, 2048)):
        p += [(f"backbone.lat{lvl}.weight", (channels, cin, 1, 1), "conv"),
              (f"backbone.lat{lvl}.bias", (channels,), "zero"),
              (f"backbone.smooth{lvl}.weight", (channels, channels, 3, 3), "conv"),
              (f"backbone.smooth{lvl}.bias", (channels,), "zero")]
    return p


def head_params(cfg: Dict) -> List[Param]:
    """The RPN, box and mask heads, in torchvision's initialisations:
    "rpn" normal at 0.01, "fan_out" Kaiming normal (fan out, ReLU),
    "linear" and "linear_bias" uniform at 1 / sqrt(fan in), "zero"."""
    c, K, rep = cfg["fpn_channels"], cfg["n_classes"], cfg["representation_size"]
    A = len(cfg["aspect_ratios"])
    p: List[Param] = [("rpn.conv.weight", (c, c, 3, 3), "rpn"), ("rpn.conv.bias", (c,), "zero"),
                      ("rpn.cls_logits.weight", (A, c, 1, 1), "rpn"),
                      ("rpn.cls_logits.bias", (A,), "zero"),
                      ("rpn.bbox_pred.weight", (4 * A, c, 1, 1), "rpn"),
                      ("rpn.bbox_pred.bias", (4 * A,), "zero")]
    n_in = c * cfg["box_roi_size"] ** 2
    for name, i, o in (("box_head.fc6", n_in, rep), ("box_head.fc7", rep, rep),
                       ("box_predictor.cls_score", rep, K),
                       ("box_predictor.bbox_pred", rep, 4 * K)):
        p += [(f"{name}.weight", (o, i), "linear"), (f"{name}.bias", (o,), "linear_bias")]
    cin = c
    for i, w in enumerate(cfg["mask_layers"]):
        p += [(f"mask_head.{i}.weight", (w, cin, 3, 3), "fan_out"),
              (f"mask_head.{i}.bias", (w,), "zero")]
        cin = w
    return p + [("mask_predictor.conv5_mask.weight", (cin, cin, 2, 2), "fan_out"),
                ("mask_predictor.conv5_mask.bias", (cin,), "conv_bias"),
                ("mask_predictor.mask_fcn_logits.weight", (K, cin, 1, 1), "fan_out"),
                ("mask_predictor.mask_fcn_logits.bias", (K,), "conv_bias")]


def head_weights(table: Sequence[Param], generator: torch.Generator, device) -> Dict:
    """Seeded head weights (`head_params`' kinds), two draws on the device.
    A weight's fan in is the product of its dims after the first, its fan
    out the first dim times the kernel (PyTorch's convention, a transposed
    conv's included); "linear_bias" and "conv_bias" take the fan in of the
    weight listed just before them."""
    n = sum(math.prod(s) for _, s, _ in table)
    z = torch.randn(n, generator=generator, device=device)
    u = torch.rand(n, generator=generator, device=device) * 2 - 1
    out, at, last = {}, 0, None
    for name, shape, kind in table:
        k = math.prod(shape)
        zi, ui = z[at:at + k].view(shape), u[at:at + k].view(shape)
        at += k
        if kind == "rpn":
            w = zi * 0.01
        elif kind == "fan_out":
            w = zi * math.sqrt(2.0 / (shape[0] * math.prod(shape[2:])))
        elif kind == "linear":
            w = ui / math.sqrt(shape[1])
        elif kind == "linear_bias":
            w = ui / math.sqrt(last[1])
        elif kind == "conv_bias":  # a conv's default: its weight's dim 1 times the kernel
            w = ui / math.sqrt(last[1] * math.prod(last[2:]))
        elif kind == "zero":
            w = torch.zeros(shape, device=device)
        else:
            raise ValueError(f"unknown parameter kind {kind!r}")
        out[name] = w.contiguous()
        last = shape
    return out


# ---------------------------------------------------------------- network


def _conv(P, name, x, conv, stride=1):
    w = P[f"{name}.weight"]
    return conv(x, w, bias=P.get(f"{name}.bias"), stride=stride, padding=w.shape[-1] // 2)


def pyramid(P: Dict, images: torch.Tensor, conv=F.conv2d) -> List[torch.Tensor]:
    """[P2, P3, P4, P5, P6] of images [B, 3, H, W] in [0, 1] (normalized,
    padded to a multiple of 32)."""
    B, _, H, W = images.shape
    mean = torch.tensor(MEAN, device=images.device)[:, None, None]
    std = torch.tensor(STD, device=images.device)[:, None, None]
    x = (images - mean) / std
    x = F.pad(x, (0, -(-W // 32) * 32 - W, 0, -(-H // 32) * 32 - H))

    def cbr(name, bn, x, stride=1, relu=True):
        y = _batch_norm(P, f"backbone.{bn}", _conv(P, f"backbone.{name}", x, conv, stride), False)
        return torch.relu(y) if relu else y

    x = F.max_pool2d(cbr("conv1", "bn1", x, 2), 3, 2, padding=1)
    feats = []
    for s, b, _, _, stride, proj in _bottlenecks():
        n = f"stages.{s}.{b}"
        y = cbr(f"{n}.conv1", f"{n}.bn1", x)
        y = cbr(f"{n}.conv2", f"{n}.bn2", y, stride)
        y = cbr(f"{n}.conv3", f"{n}.bn3", y, relu=False)
        short = cbr(f"{n}.downsample.0", f"{n}.downsample.1", x, stride, relu=False) if proj else x
        x = torch.relu(y + short)
        if b == (3, 4, 6, 3)[s] - 1:
            feats.append(x)
    inner = _conv(P, "backbone.lat5", feats[3], conv)
    out = [_conv(P, "backbone.smooth5", inner, conv)]
    for lvl in (4, 3, 2):
        lat = _conv(P, f"backbone.lat{lvl}", feats[lvl - 2], conv)
        inner = lat + F.interpolate(inner, size=lat.shape[-2:], mode="nearest")
        out.insert(0, _conv(P, f"backbone.smooth{lvl}", inner, conv))
    return out + [F.max_pool2d(out[-1], 1, 2, 0)]


def rpn_head(P: Dict, feats: List[torch.Tensor], conv=F.conv2d):
    """[B, A] objectness and [B, A, 4] deltas (level, row, column, anchor)."""
    logits, deltas = [], []
    for f in feats:
        t = torch.relu(_conv(P, "rpn.conv", f, conv))
        o, d = _conv(P, "rpn.cls_logits", t, conv), _conv(P, "rpn.bbox_pred", t, conv)
        B, A, h, w = o.shape
        logits.append(o.permute(0, 2, 3, 1).reshape(B, -1))
        deltas.append(d.view(B, A, 4, h, w).permute(0, 3, 4, 1, 2).reshape(B, -1, 4))
    return torch.cat(logits, 1), torch.cat(deltas, 1)


def anchors(feats, image_hw, cfg: Dict) -> torch.Tensor:
    """[A, 4] grid anchors (torchvision's `AnchorGenerator`): rounded base
    anchors of one size a level, strides the padded image over the level."""
    Hp, Wp = (-(-image_hw[0] // 32) * 32, -(-image_hw[1] // 32) * 32)
    out = []
    for f, size in zip(feats, cfg["anchor_sizes"]):
        ar = torch.tensor(cfg["aspect_ratios"], dtype=torch.float32)
        h_r = torch.sqrt(ar)
        w_r = 1 / h_r
        ws, hs = w_r * size, h_r * size
        base = (torch.stack([-ws, -hs, ws, hs], 1) / 2).round().to(f.device)
        h, w = f.shape[-2:]
        sy, sx = Hp // h, Wp // w
        yy, xx = torch.meshgrid(torch.arange(h, device=f.device) * sy,
                                torch.arange(w, device=f.device) * sx, indexing="ij")
        shifts = torch.stack([xx, yy, xx, yy], -1).reshape(-1, 1, 4).float()
        out.append((shifts + base[None]).reshape(-1, 4))
    return torch.cat(out)


def decode(deltas, boxes, weights):
    wx, wy, ww, wh = weights
    w, h = boxes[..., 2] - boxes[..., 0], boxes[..., 3] - boxes[..., 1]
    cx, cy = boxes[..., 0] + 0.5 * w, boxes[..., 1] + 0.5 * h
    dw = torch.clamp(deltas[..., 2] / ww, max=CLIP)
    dh = torch.clamp(deltas[..., 3] / wh, max=CLIP)
    px, py = deltas[..., 0] / wx * w + cx, deltas[..., 1] / wy * h + cy
    pw, ph = torch.exp(dw) * w, torch.exp(dh) * h
    return torch.stack([px - 0.5 * pw, py - 0.5 * ph, px + 0.5 * pw, py + 0.5 * ph], -1)


def clip(boxes, hw):
    H, W = hw
    return torch.stack([boxes[..., 0].clamp(0, W), boxes[..., 1].clamp(0, H),
                        boxes[..., 2].clamp(0, W), boxes[..., 3].clamp(0, H)], -1)


def nms(boxes, scores, groups, iou_threshold: float, max_out: int) -> List[int]:
    """Greedy NMS of one image's candidates within groups: the kept
    candidates' indices in the order kept, at most `max_out`."""
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    lt = torch.maximum(boxes[:, None, :2], boxes[None, :, :2])
    rb = torch.minimum(boxes[:, None, 2:], boxes[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    iou = inter / (area[:, None] + area[None, :] - inter)
    suppress = ((iou > iou_threshold) & (groups[:, None] == groups[None, :])).cpu().numpy()
    order = torch.sort(scores, descending=True, stable=True).indices.cpu().numpy()
    alive, keep = np.ones(len(order), bool), []
    for i in order:
        if len(keep) == max_out:
            break
        if alive[i]:
            keep.append(int(i))
            alive &= ~suppress[i]
    return keep


def select_proposals(logits, deltas, anchor_boxes, counts, hw, cfg: Dict) -> List[torch.Tensor]:
    """torchvision's `filter_proposals` of each image: [n] anchor indices
    of the kept proposals, in the order kept."""
    out = []
    for b in range(logits.shape[0]):
        idx, lvl, at = [], [], 0
        for level, n in enumerate(counts):
            k = min(cfg["rpn_pre_nms_top_n"], n)
            top = logits[b, at:at + n].topk(k).indices + at
            idx.append(top)
            lvl.append(torch.full_like(top, level))
            at += n
        idx, lvl = torch.cat(idx), torch.cat(lvl)
        boxes = clip(decode(deltas[b, idx], anchor_boxes[idx], (1.0, 1.0, 1.0, 1.0)), hw)
        prob = torch.sigmoid(logits[b, idx])
        wh = boxes[:, 2:] - boxes[:, :2]
        ok = (wh >= cfg["rpn_min_size"]).all(-1) & (prob >= cfg["rpn_score_thresh"])
        sel = ok.nonzero()[:, 0]
        keep = nms(boxes[sel], prob[sel], lvl[sel], cfg["rpn_nms_thresh"],
                   cfg["rpn_post_nms_top_n"])
        out.append(idx[sel[keep]])
    return out


def level_of(boxes, k_min: int = 2, k_max: int = 5):
    s = torch.sqrt((boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]))
    lvl = torch.floor(4 + torch.log2(s / 224.0) + torch.tensor(1e-6, dtype=s.dtype))
    return torch.clamp(lvl, k_min, k_max).long() - k_min


def roi_align(feats: List[torch.Tensor], hw, boxes, image: int, size: int, sampling: int,
              block: int = 64, shift: int = 0) -> torch.Tensor:
    """[n, C, size, size]: torchvision's `MultiScaleRoIAlign` of image
    `image`'s boxes [n, 4] over P2-P5 (aligned=False), each bin the mean of
    sampling^2 samples, a sample's four bilinear taps gathered from its
    level; `block` RoIs at a time."""
    scales = [2.0 ** round(math.log2(f.shape[-2] / hw[0])) for f in feats[:4]]
    lv = (level_of(boxes) + shift).clamp(max=3)
    C = feats[0].shape[1]
    out = torch.zeros(len(boxes), C, size, size, device=boxes.device)
    S = sampling
    for l in range(4):
        f = feats[l][image]
        H, W = f.shape[-2:]
        for chunk in (lv == l).nonzero()[:, 0].split(block):
            b = boxes[chunk] * scales[l]
            roi_w = (b[:, 2] - b[:, 0]).clamp(min=1.0)
            roi_h = (b[:, 3] - b[:, 1]).clamp(min=1.0)
            grid = torch.arange(size * S, device=b.device)
            sub = (grid % S).float() + 0.5
            ys = b[:, 1:2] + (grid // S).float() * (roi_h / size)[:, None] \
                + sub * (roi_h / size)[:, None] / S
            xs = b[:, 0:1] + (grid // S).float() * (roi_w / size)[:, None] \
                + sub * (roi_w / size)[:, None] / S

            def taps(v, n):  # torchvision's clamping of one axis
                inside = (v >= -1.0) & (v <= n)
                v = v.clamp(min=0)
                lo = v.floor().long().clamp(max=n - 1)
                v = torch.where(lo >= n - 1, lo.float(), v)
                hi = (lo + 1).clamp(max=n - 1)
                frac = v - lo.float()
                return inside, lo, hi, frac

            iy, y0, y1, ly = taps(ys, H)
            ix, x0, x1, lx = taps(xs, W)
            hy, hx = 1 - ly, 1 - lx
            Y0, Y1 = y0[:, :, None], y1[:, :, None]
            X0, X1 = x0[:, None, :], x1[:, None, :]
            val = (hy[:, :, None] * hx[:, None, :]) * f[:, Y0, X0] \
                + (hy[:, :, None] * lx[:, None, :]) * f[:, Y0, X1] \
                + (ly[:, :, None] * hx[:, None, :]) * f[:, Y1, X0] \
                + (ly[:, :, None] * lx[:, None, :]) * f[:, Y1, X1]
            val = val * (iy[:, :, None] & ix[:, None, :])  # [C, n, size*S, size*S]
            val = val.view(C, len(chunk), size, S, size, S).mean(dim=(3, 5))
            out[chunk] = val.permute(1, 0, 2, 3)
    return out


def box_head(P: Dict, feats, hw, proposals, image: int, shift: int = 0):
    """Class logits [n, K] and box deltas [n, K, 4] of image `image`'s
    proposals [n, 4]."""
    x = roi_align(feats, hw, proposals, image, 7, 2, shift=shift).flatten(1)
    x = torch.relu(F.linear(x, P["box_head.fc6.weight"], P["box_head.fc6.bias"]))
    x = torch.relu(F.linear(x, P["box_head.fc7.weight"], P["box_head.fc7.bias"]))
    logits = F.linear(x, P["box_predictor.cls_score.weight"], P["box_predictor.cls_score.bias"])
    deltas = F.linear(x, P["box_predictor.bbox_pred.weight"], P["box_predictor.bbox_pred.bias"])
    return logits, deltas.view(len(proposals), -1, 4)


def select_detections(proposals, class_logits, box_deltas, hw, cfg: Dict):
    """torchvision's `postprocess_detections` of one image (the pair budget
    the program's): (pair index r * (K - 1) + class - 1, boxes, scores,
    labels) of the kept detections in score order."""
    K = class_logits.shape[-1]
    boxes = clip(decode(box_deltas, proposals[:, None], (10.0, 10.0, 5.0, 5.0)), hw)
    scores = F.softmax(class_logits, -1)
    boxes, scores = boxes[:, 1:].reshape(-1, 4), scores[:, 1:].reshape(-1)
    labels = torch.arange(K - 1, device=scores.device).repeat(len(proposals))
    ok = (scores > cfg["box_score_thresh"]) & ((boxes[:, 2] - boxes[:, 0]) >= cfg["box_min_size"]) \
        & ((boxes[:, 3] - boxes[:, 1]) >= cfg["box_min_size"])
    ranked = torch.where(ok, scores, torch.full_like(scores, -1.0))
    pairs = torch.sort(ranked, descending=True, stable=True).indices[:cfg["box_pair_budget"]]
    pairs = pairs[ok[pairs]]
    keep = nms(boxes[pairs], scores[pairs], labels[pairs], cfg["box_nms_thresh"],
               cfg["detections_per_img"])
    p = pairs[keep]
    return p, boxes[p], scores[p], labels[p]


def mask_logits(P: Dict, feats, hw, boxes, labels, image: int, conv=F.conv2d, shift: int = 0):
    """[n, 28, 28]: the mask logits of class label + 1 of image `image`'s
    detections."""
    x = roi_align(feats, hw, boxes, image, 14, 2, shift=shift)
    i = 0
    while f"mask_head.{i}.weight" in P:
        x = torch.relu(_conv(P, f"mask_head.{i}", x, conv))
        i += 1
    x = torch.relu(F.conv_transpose2d(x, P["mask_predictor.conv5_mask.weight"],
                                      P["mask_predictor.conv5_mask.bias"], stride=2))
    x = _conv(P, "mask_predictor.mask_fcn_logits", x, conv)
    return x[torch.arange(len(boxes), device=x.device), labels + 1]


def paste(probs, boxes, hw, padding: int = 1) -> torch.Tensor:
    """torchvision's `paste_masks_in_image`: [n, H, W] of probs [n, M, M]."""
    H, W = hw
    M = probs.shape[-1]
    scale = float(M + 2 * padding) / M
    padded = F.pad(probs, (padding,) * 4)
    w_half = (boxes[:, 2] - boxes[:, 0]) * 0.5 * scale
    h_half = (boxes[:, 3] - boxes[:, 1]) * 0.5 * scale
    x_c = (boxes[:, 2] + boxes[:, 0]) * 0.5
    y_c = (boxes[:, 3] + boxes[:, 1]) * 0.5
    b = torch.stack([x_c - w_half, y_c - h_half, x_c + w_half, y_c + h_half], 1).long().tolist()
    out = torch.zeros(len(boxes), H, W, device=probs.device)
    for i, (x0, y0, x1, y1) in enumerate(b):
        w, h = max(x1 - x0 + 1, 1), max(y1 - y0 + 1, 1)
        m = F.interpolate(padded[i][None, None], size=(h, w), mode="bilinear",
                          align_corners=False)[0, 0]
        xa, xb, ya, yb = max(x0, 0), min(x1 + 1, W), max(y0, 0), min(y1 + 1, H)
        if xb > xa and yb > ya:
            out[i, ya:yb, xa:xb] = m[ya - y0:yb - y0, xa - x0:xb - x0]
    return out
