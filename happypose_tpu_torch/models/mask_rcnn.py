"""Mask R-CNN with a ResNet50-FPN (He et al., ICCV 2017): CosyPose's
published detector (`DetectorMaskRCNN`, which wraps torchvision's
`MaskRCNN`), with every shape fixed so that a CUDA graph can hold the
whole forward.

The forward of one batch of frames [B, 3, H, W] in [0, 1]:
- the transform: ImageNet mean and std, zero padding to a multiple of 32
  (torchvision's `GeneralizedRCNNTransform`; the frame is taken at its
  size: its resize to (min_size, max_size) is the identity at 480x640);
- the trunk and the P2-P6 pyramid (`models.detector.ResNet50FPNMaxPool`);
- the RPN (stage `detector.rpn`): one 3x3 conv and two 1x1 heads shared by
  the levels, anchors of one size a level and three aspect ratios,
  the per-level top `rpn_pre_nms_top_n` by objectness, decoding (box coder
  weights 1, 1, 1, 1; log-size deltas clamped at log(1000 / 16)),
  clipping, a level-aware NMS (`ops.nms`) down to `rpn_post_nms_top_n`
  proposals;
- the box stage (stage `detector.box`): RoIAlign 7x7 at each proposal's
  level (`ops.multiscale_roi_align`), the TwoMLPHead and the box predictor,
  decoding with weights 10, 10, 5, 5, a softmax, and a class-aware NMS of
  the (class, proposal) pairs down to `detections_per_img`;
- the mask stage (stage `detector.mask`): RoIAlign 14x14 of the
  detections, four 3x3 convs, a 2x2 transposed conv of stride 2, a 1x1 to
  the classes, the sigmoid of the detection's class, and each 28x28 mask
  pasted into the frame (torchvision's `paste_masks_in_image`, one pixel
  of padding) and thresholded.

Where torchvision's shapes depend on the data, slots and validity flags
stand in: `rpn_post_nms_top_n` proposal slots, `detections_per_img`
detection slots, each with a flag; the box NMS takes the
`box_pair_budget` (class, proposal) pairs of the highest scores (the same
detections as torchvision's whenever that many pairs keep
`detections_per_img` detections, or hold every pair). Labels come back as
object ids: the class index minus one (class 0 is the background).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from happypose_tpu_torch.models.detector import ResNet50FPNMaxPool
from happypose_tpu_torch.ops.multiscale_roi_align import level_of, level_scale, multiscale_roi_align
from happypose_tpu_torch.ops.nms import nms
from happypose_tpu_torch.utils.cuda_graphs import device_constant
from happypose_tpu_torch.utils.profiling import stage

BBOX_XFORM_CLIP = math.log(1000.0 / 16)
KIND = "mask_rcnn"


@dataclass(frozen=True)
class MaskRCNNConfig:
    """torchvision's `MaskRCNN` settings, CosyPose's arguments by default
    (YCB-V: 21 objects + the background)."""

    n_classes: int = 22  # with the background, class 0
    fpn_channels: int = 256
    anchor_sizes: Tuple[int, ...] = (32, 64, 128, 256, 512)  # one a level, P2-P6
    aspect_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    rpn_pre_nms_top_n: int = 1000  # a level
    rpn_post_nms_top_n: int = 1000
    rpn_nms_thresh: float = 0.7
    rpn_min_size: float = 1e-3
    rpn_score_thresh: float = 0.0
    box_roi_size: int = 7
    mask_roi_size: int = 14
    sampling_ratio: int = 2
    representation_size: int = 1024
    box_score_thresh: float = 0.05
    box_nms_thresh: float = 0.5
    box_min_size: float = 1e-2
    detections_per_img: int = 100
    box_pair_budget: int = 4096
    mask_layers: Tuple[int, ...] = (256, 256, 256, 256)
    mask_threshold: float = 0.5
    size_divisible: int = 32
    image_mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    image_std: Tuple[float, float, float] = (0.229, 0.224, 0.225)


def config_to_dict(cfg: MaskRCNNConfig) -> Dict[str, object]:
    """The settings as a run directory's `config.json` holds them, with
    `"kind": "mask_rcnn"` (`utils.load_model.load_detector`)."""
    return {"kind": KIND, **{k: list(v) if isinstance(v, tuple) else v
                             for k, v in dataclasses.asdict(cfg).items()}}


def config_from_dict(d: Dict[str, object]) -> MaskRCNNConfig:
    """`config_to_dict`'s inverse; keys it does not know (the kind, the
    image size) are left out."""
    fields = {f.name for f in dataclasses.fields(MaskRCNNConfig)}
    return MaskRCNNConfig(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in d.items() if k in fields})


class MaskRCNNOutputs(NamedTuple):
    """A forward's outputs, [B, ...] each. The detections' fields are
    `detector_postprocess`'s."""

    rpn_logits: torch.Tensor  # [B, A] objectness of every anchor (level, row, column, anchor)
    rpn_deltas: torch.Tensor  # [B, A, 4]
    proposals: torch.Tensor  # [B, R, 4] in score order
    proposal_anchor: torch.Tensor  # [B, R] the anchor each proposal decodes
    proposal_valid: torch.Tensor  # [B, R]
    class_logits: torch.Tensor  # [B, R, K]
    box_deltas: torch.Tensor  # [B, R, K, 4]
    boxes: torch.Tensor  # [B, D, 4] the detections, in score order
    scores: torch.Tensor  # [B, D]
    labels: torch.Tensor  # [B, D] object ids (class - 1)
    valid: torch.Tensor  # [B, D]
    det_pair: torch.Tensor  # [B, D] the (proposal, class) pair: r * (K - 1) + class - 1
    mask_logits: torch.Tensor  # [B, D, 2M, 2M] the detection's class
    masks: torch.Tensor  # [B, D, H, W] bool, pasted and thresholded


def base_anchors(sizes: Sequence[int], ratios: Sequence[float]) -> List[Tuple[float, ...]]:
    """torchvision's `AnchorGenerator.generate_anchors` for each size:
    [ratios, 4] (x1, y1, x2, y2) around the origin, rounded."""
    out = []
    for size in sizes:
        scales = torch.as_tensor([size], dtype=torch.float32)
        ar = torch.as_tensor(ratios, dtype=torch.float32)
        h_ratios = torch.sqrt(ar)
        w_ratios = 1 / h_ratios
        ws = (w_ratios[:, None] * scales[None, :]).view(-1)
        hs = (h_ratios[:, None] * scales[None, :]).view(-1)
        base = (torch.stack([-ws, -hs, ws, hs], dim=1) / 2).round()
        out.append(tuple(tuple(float(v) for v in row) for row in base))
    return out


def decode(deltas: torch.Tensor, boxes: torch.Tensor, weights: Tuple[float, ...]) -> torch.Tensor:
    """torchvision's `BoxCoder.decode_single`: deltas [..., 4] relative to
    boxes [..., 4] (broadcast) -> boxes [..., 4]."""
    wx, wy, ww, wh = weights
    widths = boxes[..., 2] - boxes[..., 0]
    heights = boxes[..., 3] - boxes[..., 1]
    ctr_x = boxes[..., 0] + 0.5 * widths
    ctr_y = boxes[..., 1] + 0.5 * heights
    dx, dy = deltas[..., 0] / wx, deltas[..., 1] / wy
    dw = torch.clamp(deltas[..., 2] / ww, max=BBOX_XFORM_CLIP)
    dh = torch.clamp(deltas[..., 3] / wh, max=BBOX_XFORM_CLIP)
    pred_ctr_x = dx * widths + ctr_x
    pred_ctr_y = dy * heights + ctr_y
    pred_w = torch.exp(dw) * widths
    pred_h = torch.exp(dh) * heights
    c_to_c_w, c_to_c_h = 0.5 * pred_w, 0.5 * pred_h
    return torch.stack([pred_ctr_x - c_to_c_w, pred_ctr_y - c_to_c_h,
                        pred_ctr_x + c_to_c_w, pred_ctr_y + c_to_c_h], dim=-1)


def clip_boxes(boxes: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """torchvision's `clip_boxes_to_image`: x in [0, W], y in [0, H]."""
    H, W = size
    x = boxes[..., 0::2].clamp(min=0, max=W)
    y = boxes[..., 1::2].clamp(min=0, max=H)
    return torch.stack([x[..., 0], y[..., 0], x[..., 1], y[..., 1]], dim=-1)


def large_enough(boxes: torch.Tensor, min_size: float) -> torch.Tensor:
    """torchvision's `remove_small_boxes` as a flag."""
    return (boxes[..., 2:] - boxes[..., :2] >= min_size).all(-1)


def paste_weights(lo: torch.Tensor, hi: torch.Tensor, extent: torch.Tensor, n: int,
                  size: int) -> torch.Tensor:
    """[..., n, size]: the bilinear weights (PyTorch's `interpolate`,
    align_corners=False) that resize `size` mask cells to `extent` pixels
    placed at `lo` (integer), for the frame's pixels 0..n-1 in [max(lo, 0),
    hi) (the rows or columns of `paste_mask_in_image`)."""
    pix = torch.arange(n, device=lo.device)
    local = pix - lo[..., None]
    inside = (pix >= torch.clamp(lo, min=0)[..., None]) & (pix < hi[..., None])
    scale = size / extent.to(torch.float32)
    src = scale[..., None] * (local.to(torch.float32) + 0.5) - 0.5
    src = torch.clamp(src, min=0.0)
    i0 = src.to(torch.int64)
    i1 = torch.where(i0 < size - 1, i0 + 1, i0)
    lam = src - i0.to(torch.float32)
    cells = torch.arange(size, device=lo.device)
    w = (1.0 - lam)[..., None] * (cells == i0[..., None]) \
        + lam[..., None] * (cells == i1[..., None])
    return torch.where(inside[..., None], w, torch.zeros_like(w))


def paste_masks(probs: torch.Tensor, boxes: torch.Tensor, size: Tuple[int, int],
                padding: int = 1) -> torch.Tensor:
    """torchvision's `paste_masks_in_image` at fixed shapes: probs [N, M, M]
    at boxes [N, 4] -> [N, H, W] (each mask padded by `padding` zero cells,
    its box widened by the same ratio and cut to integers, resized
    bilinearly into its box and laid in the frame), as two matrix products
    a mask."""
    H, W = size
    M = probs.shape[-1]
    padded = F.pad(probs, (padding,) * 4)
    scale = float(M + 2 * padding) / M
    w_half = (boxes[:, 2] - boxes[:, 0]) * 0.5
    h_half = (boxes[:, 3] - boxes[:, 1]) * 0.5
    x_c = (boxes[:, 2] + boxes[:, 0]) * 0.5
    y_c = (boxes[:, 3] + boxes[:, 1]) * 0.5
    w_half = w_half * scale
    h_half = h_half * scale
    b = torch.stack([x_c - w_half, y_c - h_half, x_c + w_half, y_c + h_half], -1).to(torch.int64)
    w = torch.clamp(b[:, 2] - b[:, 0] + 1, min=1)
    h = torch.clamp(b[:, 3] - b[:, 1] + 1, min=1)
    Mp = M + 2 * padding
    wy = paste_weights(b[:, 1], torch.clamp(b[:, 3] + 1, max=H), h, H, Mp)  # [N, H, Mp]
    wx = paste_weights(b[:, 0], torch.clamp(b[:, 2] + 1, max=W), w, W, Mp)  # [N, W, Mp]
    return torch.bmm(torch.bmm(wy, padded), wx.transpose(1, 2))


class RPNHead(nn.Module):
    def __init__(self, channels: int, n_anchors: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)
        self.cls_logits = nn.Conv2d(channels, n_anchors, 1)
        self.bbox_pred = nn.Conv2d(channels, 4 * n_anchors, 1)

    def forward(self, feats: List[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B, A] logits and [B, A, 4] deltas over the levels' anchors in
        torchvision's order (level, row, column, anchor)."""
        logits, deltas = [], []
        for f in feats:
            t = torch.relu(self.conv(f))
            o, d = self.cls_logits(t), self.bbox_pred(t)
            B, A, h, w = o.shape
            logits.append(o.permute(0, 2, 3, 1).reshape(B, -1))
            deltas.append(d.view(B, A, 4, h, w).permute(0, 3, 4, 1, 2).reshape(B, -1, 4))
        return torch.cat(logits, 1), torch.cat(deltas, 1)


class TwoMLPHead(nn.Module):
    def __init__(self, in_channels: int, representation_size: int):
        super().__init__()
        self.fc6 = nn.Linear(in_channels, representation_size)
        self.fc7 = nn.Linear(representation_size, representation_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.fc7(torch.relu(self.fc6(x.flatten(1)))))


class BoxPredictor(nn.Module):
    def __init__(self, in_channels: int, n_classes: int):
        super().__init__()
        self.cls_score = nn.Linear(in_channels, n_classes)
        self.bbox_pred = nn.Linear(in_channels, 4 * n_classes)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.cls_score(x), self.bbox_pred(x)


class MaskPredictor(nn.Module):
    def __init__(self, in_channels: int, channels: int, n_classes: int):
        super().__init__()
        self.conv5_mask = nn.ConvTranspose2d(in_channels, channels, 2, 2)
        self.mask_fcn_logits = nn.Conv2d(channels, n_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mask_fcn_logits(torch.relu(self.conv5_mask(x)))


class MaskRCNN(nn.Module):
    def __init__(self, cfg: MaskRCNNConfig = MaskRCNNConfig()):
        super().__init__()
        self.cfg = cfg
        c = cfg.fpn_channels
        self.backbone = ResNet50FPNMaxPool(c)
        self.rpn = RPNHead(c, len(cfg.aspect_ratios))
        self.box_head = TwoMLPHead(c * cfg.box_roi_size ** 2, cfg.representation_size)
        self.box_predictor = BoxPredictor(cfg.representation_size, cfg.n_classes)
        layers, cin = [], c
        for width in cfg.mask_layers:
            layers.append(nn.Conv2d(cin, width, 3, padding=1))
            cin = width
        self.mask_head = nn.ModuleList(layers)
        self.mask_predictor = MaskPredictor(cin, cin, cfg.n_classes)
        self._base_anchors = base_anchors(cfg.anchor_sizes, cfg.aspect_ratios)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "MaskRCNN":
        """Fresh seeded weights with torchvision's initialisation: the trunk's
        and the mask branch's convolutions Kaiming-normal (fan out, ReLU),
        frozen-identity batch norms, the pyramid's convolutions Kaiming-
        uniform (a = 1), the RPN's normal at 0.01, zero conv biases, the
        linear layers PyTorch's default (uniform at 1 / sqrt(fan in))."""
        def normal(t, std):
            t.copy_(torch.randn(t.shape, generator=generator) * std)

        def uniform(t, bound):
            t.copy_((torch.rand(t.shape, generator=generator) * 2 - 1) * bound)

        fpn = {f"{k}{lvl}" for k in ("lat", "smooth") for lvl in (2, 3, 4, 5)}
        for name, m in self.named_modules():
            if isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
            elif isinstance(m, nn.Linear):
                bound = 1.0 / math.sqrt(m.in_features)
                uniform(m.weight, bound)
                uniform(m.bias, bound)
            elif isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                if name.startswith("rpn."):
                    normal(m.weight, 0.01)
                elif name.split(".")[-1] in fpn:
                    uniform(m.weight, math.sqrt(3.0 / m.weight[0].numel()))
                else:  # PyTorch's fan out: the weight's first dim (a transposed conv's input)
                    fan_out = m.weight.shape[0] * m.weight[0, 0].numel()
                    normal(m.weight, math.sqrt(2.0 / fan_out))
                if name.startswith("mask_predictor."):  # the layer's own default bias
                    uniform(m.bias, 1.0 / math.sqrt(m.weight.shape[1] * m.weight[0, 0].numel()))
                elif m.bias is not None:
                    m.bias.zero_()
        return self

    def anchors(self, feats: List[torch.Tensor], padded: Tuple[int, int]) -> torch.Tensor:
        """[A, 4]: torchvision's grid anchors of every level, strides the
        padded image's size over the level's (integer division)."""
        out = []
        for f, base in zip(feats, self._base_anchors):
            h, w = f.shape[-2:]
            sy, sx = padded[0] // h, padded[1] // w
            ys = torch.arange(h, dtype=torch.float32, device=f.device) * sy
            xs = torch.arange(w, dtype=torch.float32, device=f.device) * sx
            shift_y, shift_x = torch.meshgrid(ys, xs, indexing="ij")
            shifts = torch.stack([shift_x, shift_y, shift_x, shift_y], -1).reshape(-1, 1, 4)
            out.append((shifts + device_constant(base, torch.float32, f.device)).reshape(-1, 4))
        return torch.cat(out)

    def _proposals(self, feats, logits, deltas, padded, size):
        """The RPN's selection: per level the top anchors by objectness,
        decoded, clipped, flagged (size, score), a level-aware NMS."""
        cfg = self.cfg
        anchors = self.anchors(feats, padded)
        counts = [f.shape[-2] * f.shape[-1] * len(cfg.aspect_ratios) for f in feats]
        idx, lvl, at = [], [], 0
        for level, n in enumerate(counts):
            k = min(cfg.rpn_pre_nms_top_n, n)
            top = logits[:, at:at + n].topk(k, dim=1).indices + at
            idx.append(top)
            lvl.append(torch.full_like(top, level))
            at += n
        idx, lvl = torch.cat(idx, 1), torch.cat(lvl, 1)
        obj = torch.sigmoid(torch.gather(logits, 1, idx))
        d = torch.gather(deltas, 1, idx[..., None].expand(-1, -1, 4))
        boxes = clip_boxes(decode(d, anchors[idx], (1.0, 1.0, 1.0, 1.0)), size)
        ok = large_enough(boxes, cfg.rpn_min_size) & (obj >= cfg.rpn_score_thresh)
        keep, kv = nms(boxes, obj, lvl, ok, cfg.rpn_nms_thresh, cfg.rpn_post_nms_top_n)
        proposals = torch.gather(boxes, 1, keep[..., None].expand(-1, -1, 4))
        return proposals, torch.gather(idx, 1, keep), kv

    def _roi_features(self, feats, boxes, size, output_size):
        scales = [level_scale(f.shape[-2], size[0]) for f in feats[:4]]
        k_min = -int(round(math.log2(scales[0])))
        levels = level_of(boxes, k_min, k_min + 3)
        return multiscale_roi_align(feats[:4], scales, boxes, levels, output_size,
                                    self.cfg.sampling_ratio)

    def _detections(self, proposals, pvalid, class_logits, box_deltas, size):
        """torchvision's `postprocess_detections` on fixed slots: decoded,
        clipped boxes and softmax scores of every (proposal, class) pair but
        the background, flagged (proposal, score, size); the budget's pairs
        by score; a class-aware NMS."""
        cfg = self.cfg
        B, R, K = class_logits.shape
        boxes = clip_boxes(decode(box_deltas, proposals[:, :, None], (10.0, 10.0, 5.0, 5.0)), size)
        scores = F.softmax(class_logits, -1)
        boxes, scores = boxes[:, :, 1:].reshape(B, -1, 4), scores[:, :, 1:].reshape(B, -1)
        labels = torch.arange(K - 1, device=scores.device).repeat(R).expand(B, -1)
        ok = pvalid[..., None].expand(B, R, K - 1).reshape(B, -1) \
            & (scores > cfg.box_score_thresh) & large_enough(boxes, cfg.box_min_size)
        n = min(cfg.box_pair_budget, R * (K - 1))
        ranked = torch.where(ok, scores, torch.full_like(scores, -1.0))
        pair = torch.sort(ranked, dim=1, descending=True, stable=True).indices[:, :n]
        p_boxes = torch.gather(boxes, 1, pair[..., None].expand(-1, -1, 4))
        p_scores, p_labels = torch.gather(ranked, 1, pair), torch.gather(labels, 1, pair)
        keep, kv = nms(p_boxes, p_scores, p_labels, torch.gather(ok, 1, pair),
                       cfg.box_nms_thresh, cfg.detections_per_img)
        det_pair = torch.gather(pair, 1, keep)
        return (torch.gather(boxes, 1, det_pair[..., None].expand(-1, -1, 4)),
                torch.gather(scores, 1, det_pair), torch.gather(labels, 1, det_pair), kv,
                det_pair)

    def forward(self, images: torch.Tensor) -> MaskRCNNOutputs:
        cfg = self.cfg
        B, _, H, W = images.shape
        mean = device_constant(cfg.image_mean, torch.float32, images.device)
        std = device_constant(cfg.image_std, torch.float32, images.device)
        x = (images - mean[:, None, None]) / std[:, None, None]
        d = cfg.size_divisible
        padded = (-(-H // d) * d, -(-W // d) * d)
        x = F.pad(x, (0, padded[1] - W, 0, padded[0] - H))
        feats = self.backbone(x)
        with stage("detector.rpn"):
            logits, deltas = self.rpn(feats)
            proposals, anchor, pvalid = self._proposals(feats, logits, deltas, padded, (H, W))
        with stage("detector.box"):
            R = proposals.shape[1]
            roi = self._roi_features(feats, proposals, (H, W), cfg.box_roi_size)
            class_logits, box_reg = self.box_predictor(self.box_head(roi))
            class_logits = class_logits.view(B, R, -1)
            box_reg = box_reg.view(B, R, -1, 4)
            boxes, scores, labels, valid, det_pair = self._detections(
                proposals, pvalid, class_logits, box_reg, (H, W))
        with stage("detector.mask"):
            D = boxes.shape[1]
            m = self._roi_features(feats, boxes, (H, W), cfg.mask_roi_size)
            for conv in self.mask_head:
                m = torch.relu(conv(m))
            m = self.mask_predictor(m)  # [B * D, K, 2M, 2M]
            cls = (labels.reshape(-1) + 1)[:, None, None, None].expand(-1, 1, *m.shape[-2:])
            mask_logits = torch.gather(m, 1, cls)[:, 0]
            probs = paste_masks(torch.sigmoid(mask_logits), boxes.reshape(-1, 4), (H, W))
            masks = (probs > cfg.mask_threshold).view(B, D, H, W)
        return MaskRCNNOutputs(
            rpn_logits=logits, rpn_deltas=deltas, proposals=proposals, proposal_anchor=anchor,
            proposal_valid=pvalid, class_logits=class_logits, box_deltas=box_reg, boxes=boxes,
            scores=scores, labels=labels, valid=valid, det_pair=det_pair,
            mask_logits=mask_logits.view(B, D, *mask_logits.shape[-2:]), masks=masks)

    def nms_settings(self, iou_threshold: Optional[float] = None) -> Tuple[float, int]:
        """The box stage's NMS threshold and budget, which the forward runs
        at (`box_nms_thresh`, `detections_per_img`); another `iou_threshold`
        raises."""
        cfg = self.cfg
        if iou_threshold is not None and iou_threshold != cfg.box_nms_thresh:
            raise ValueError(f"Mask R-CNN runs its NMS at box_nms_thresh "
                             f"{cfg.box_nms_thresh} (its config), not {iou_threshold}")
        return cfg.box_nms_thresh, cfg.detections_per_img
