"""FCOS + mask training loss of the detector (PyTorch port of
`happypose_tpu/training/detector_loss.py`).

Parity: the reference trains torchvision's Mask R-CNN with its internal
loss dict (cosypose/training/train_detector.py:119-386). The single-stage
detector here uses the FCOS target assignment (a location is positive for
the smallest box containing it whose regression range fits its level),
sigmoid focal classification, GIoU box regression, centerness BCE and a
YOLACT-style prototype-mask BCE on a few positive locations an image; every
shape is fixed and every reduction masked, batched over images where the
JAX package maps one image at a time.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from happypose_tpu_torch.models.detector import DetectorOutputs, decode_boxes
from happypose_tpu_torch.utils.cuda_graphs import device_constant

# FCOS per-level regression ranges (pixels)
LEVEL_RANGES = ((0, 64), (64, 128), (128, 256), (256, 512), (512, 1e8))


class DetectionTargets(NamedTuple):
    boxes: torch.Tensor  # [B, G, 4] ground-truth boxes (xyxy)
    labels: torch.Tensor  # [B, G] int
    masks: torch.Tensor  # [B, G, Hm, Wm] bool at prototype resolution
    valid: torch.Tensor  # [B, G] bool

    def to(self, device) -> "DetectionTargets":
        return DetectionTargets(*(x.to(device) for x in self))


def _ltrb(locations: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Distances (l, t, r, b) [..., 4] of locations [..., 2] to boxes [..., 4]."""
    u, v = locations[..., 0], locations[..., 1]
    return torch.stack([u - boxes[..., 0], v - boxes[..., 1],
                        boxes[..., 2] - u, boxes[..., 3] - v], dim=-1)


def assign_targets(
    locations: torch.Tensor,  # [L, 2]
    level_ids: torch.Tensor,  # [L]
    gt_boxes: torch.Tensor,  # [B, G, 4]
    gt_valid: torch.Tensor,  # [B, G]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """FCOS assignment: (gt_idx [B, L], -1 where negative; pos [B, L]). Among
    equal areas the first box wins, as `jnp.argmin`."""
    ltrb = _ltrb(locations[None, :, None, :], gt_boxes[:, None, :, :])  # [B, L, G, 4]
    inside = ltrb.amin(-1) > 0
    max_d = ltrb.amax(-1)
    ranges = device_constant(LEVEL_RANGES, torch.float32, locations.device)[level_ids]
    in_range = (max_d >= ranges[None, :, None, 0]) & (max_d <= ranges[None, :, None, 1])
    area = (gt_boxes[..., 2] - gt_boxes[..., 0]) * (gt_boxes[..., 3] - gt_boxes[..., 1])
    cand = inside & in_range & gt_valid[:, None, :]
    area_m = torch.where(cand, area[:, None, :], torch.full_like(max_d, float("inf")))
    gt_idx = area_m.argmin(-1)
    pos = torch.isfinite(area_m.amin(-1))
    return torch.where(pos, gt_idx, torch.full_like(gt_idx, -1)), pos


def focal_loss(logits: torch.Tensor, targets: torch.Tensor, alpha=0.25, gamma=2.0) -> torch.Tensor:
    """Elementwise sigmoid focal loss."""
    p = torch.sigmoid(logits)
    ce = -(targets * F.logsigmoid(logits) + (1 - targets) * F.logsigmoid(-logits))
    pt = targets * p + (1 - targets) * (1 - p)
    w = targets * alpha + (1 - targets) * (1 - alpha)
    return w * ((1 - pt) ** gamma) * ce


def giou(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Generalized IoU of boxes [..., 4] (xyxy)."""
    x1 = torch.maximum(b1[..., 0], b2[..., 0])
    y1 = torch.maximum(b1[..., 1], b2[..., 1])
    x2 = torch.minimum(b1[..., 2], b2[..., 2])
    y2 = torch.minimum(b1[..., 3], b2[..., 3])
    inter = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)

    def area(b):
        return torch.clamp(b[..., 2] - b[..., 0], min=0) * torch.clamp(b[..., 3] - b[..., 1], min=0)

    union = area(b1) + area(b2) - inter
    iou = inter / torch.clamp(union, min=1e-9)
    ex1 = torch.minimum(b1[..., 0], b2[..., 0])
    ey1 = torch.minimum(b1[..., 1], b2[..., 1])
    ex2 = torch.maximum(b1[..., 2], b2[..., 2])
    ey2 = torch.maximum(b1[..., 3], b2[..., 3])
    enc = torch.clamp(ex2 - ex1, min=0) * torch.clamp(ey2 - ey1, min=0)
    return iou - (enc - union) / torch.clamp(enc, min=1e-9)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, G, ...] at idx [B, N] -> [B, N, ...]."""
    return torch.gather(x, 1, idx.reshape(*idx.shape, *(1,) * (x.ndim - 2)).expand(
        *idx.shape, *x.shape[2:]))


def detector_loss(
    out: DetectorOutputs,
    targets: DetectionTargets,
    n_classes: int,
    n_mask_samples: int = 4,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total loss and its parts (each the mean over images)."""
    gt_idx, pos = assign_targets(out.locations, out.level_ids, targets.boxes, targets.valid)
    n_pos = torch.clamp(pos.sum(-1), min=1)  # [B]
    # a negative location reads the last box, as JAX's index -1 does; every
    # use of it below is masked by `pos`
    idx = gt_idx % targets.boxes.shape[1]

    # classification: focal over every location; the background class
    # n_classes is the all-zero row
    tgt_cls = torch.where(pos, _take(targets.labels, idx), torch.full_like(idx, n_classes))
    # one_hot(., n_classes + 1)[..., :n_classes], without one_hot's host check of the ids
    onehot = (tgt_cls[..., None] == torch.arange(n_classes, device=tgt_cls.device)).to(
        out.cls_logits.dtype)
    cls_l = focal_loss(out.cls_logits, onehot).sum((1, 2)) / n_pos

    # box GIoU on positives
    gt_b = _take(targets.boxes, idx)  # [B, L, 4]
    g = giou(decode_boxes(out.locations, out.box_reg), gt_b)
    box_l = torch.where(pos, 1.0 - g, torch.zeros_like(g)).sum(-1) / n_pos

    # centerness BCE on positives
    l, t, r, b = _ltrb(out.locations[None], gt_b).unbind(-1)
    ctr_tgt = torch.sqrt(torch.clamp(
        (torch.minimum(l, r) / torch.clamp(torch.maximum(l, r), min=1e-9))
        * (torch.minimum(t, b) / torch.clamp(torch.maximum(t, b), min=1e-9)), 0.0, 1.0))
    ctr = out.centerness
    ctr_bce = -(ctr_tgt * F.logsigmoid(ctr) + (1 - ctr_tgt) * F.logsigmoid(-ctr))
    ctr_l = torch.where(pos, ctr_bce, torch.zeros_like(ctr_bce)).sum(-1) / n_pos

    # masks: the n_mask_samples positives of highest centerness target
    # (`lax.top_k`: ties lowest index first, a stable descending sort)
    score = torch.where(pos, ctr_tgt, torch.full_like(ctr_tgt, -1.0))
    samp = torch.sort(score, dim=-1, descending=True, stable=True).indices[:, :n_mask_samples]
    samp_valid = torch.gather(pos, 1, samp)
    m_pred = torch.sigmoid(torch.einsum("bhwp,bnp->bnhw", out.prototypes,
                                        _take(out.mask_coeffs, samp)))
    m_gt = _take(targets.masks, torch.gather(idx, 1, samp)).to(m_pred.dtype)
    m_bce = -(m_gt * torch.log(torch.clamp(m_pred, min=1e-7))
              + (1 - m_gt) * torch.log(torch.clamp(1 - m_pred, min=1e-7))).mean((2, 3))
    mask_l = torch.where(samp_valid, m_bce, torch.zeros_like(m_bce)).sum(-1) / torch.clamp(
        samp_valid.sum(-1), min=1)

    parts = {"loss_cls": cls_l.mean(), "loss_box": box_l.mean(), "loss_ctr": ctr_l.mean(),
             "loss_mask": mask_l.mean()}
    return sum(parts.values()), parts
