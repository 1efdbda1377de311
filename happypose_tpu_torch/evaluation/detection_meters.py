"""Detection metric engine: AP / mAP at an IoU threshold.

Parity target: happypose/pose_estimators/cosypose/cosypose/
evaluation/meters/detection_meters.py (`DetectionMeter`): greedy
score-ordered matching of predicted boxes to valid GT boxes at
IoU >= threshold, per-label average precision computed over the
score-ranked predictions with recall normalized by the GT count
(:222-247: sklearn AP scaled by tp/n_gt), mAP = mean over labels, plus
match-count diagnostics. Host-side numpy — box counts per image are tiny;
the heavy work (the detector forward) already ran on device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


def box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of xyxy boxes, [Na, Nb]."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(br - tl, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.prod(np.clip(a[:, 2:] - a[:, :2], 0, None), axis=-1)
    area_b = np.prod(np.clip(b[:, 2:] - b[:, :2], 0, None), axis=-1)
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / np.maximum(union, 1e-12)


def average_precision(
    is_tp: np.ndarray, scores: np.ndarray, n_gt: int
) -> float:
    """AP over score-ranked predictions with recall base n_gt
    (the reference's `compute_ap`, detection_meters.py:222-234)."""
    if n_gt <= 0 or len(is_tp) == 0:
        return 0.0
    order = np.argsort(-np.asarray(scores, np.float64), kind="stable")
    tp = np.asarray(is_tp, np.float64)[order]
    cum_tp = np.cumsum(tp)
    prec = cum_tp / (np.arange(len(tp)) + 1)
    rec = cum_tp / n_gt
    # sum precision at each recall increment (step-wise AP)
    d_rec = np.diff(np.concatenate([[0.0], rec]))
    return float((d_rec * prec).sum())


@dataclass
class DetectionMeter:
    """Accumulates box detections vs GT; reports AP/mAP@IoU.

    `add` takes one image's predictions and GT as arrays (labels are int
    ids, any registry). GT rows with visib_fract < visib_gt_min are
    invalid: they do not count toward recall, and predictions matched to
    them are dropped from scoring (not counted as false positives)."""

    iou_threshold: float = 0.5
    visib_gt_min: float = -1.0
    # per label: list of (is_tp, score) rows, and valid-GT count
    _preds: Dict[int, List] = field(default_factory=dict)
    _n_gt: Dict[int, int] = field(default_factory=dict)
    n_gt_total: int = 0
    n_pred_total: int = 0
    n_matched: int = 0

    def add(
        self,
        pred_boxes: np.ndarray,  # [Np, 4] xyxy
        pred_labels: np.ndarray,  # [Np] int
        pred_scores: np.ndarray,  # [Np]
        gt_boxes: np.ndarray,  # [Ng, 4]
        gt_labels: np.ndarray,  # [Ng] int
        gt_visib_fract: Optional[np.ndarray] = None,  # [Ng]
    ) -> None:
        pred_labels = np.asarray(pred_labels, int)
        gt_labels = np.asarray(gt_labels, int)
        n_g = len(gt_boxes)
        if gt_visib_fract is None:
            gt_valid = np.ones(n_g, bool)
        else:
            gt_valid = np.asarray(gt_visib_fract) >= self.visib_gt_min
        self.n_gt_total += int(gt_valid.sum())
        self.n_pred_total += len(pred_boxes)
        for lab in np.unique(gt_labels):
            self._n_gt[int(lab)] = self._n_gt.get(int(lab), 0) + int(
                gt_valid[gt_labels == lab].sum()
            )

        iou = box_iou(pred_boxes, gt_boxes)
        gt_used = np.zeros(n_g, bool)
        order = np.argsort(-np.asarray(pred_scores), kind="stable")
        for pi in order:
            lab = int(pred_labels[pi])
            cand = np.where(
                (gt_labels == lab) & ~gt_used
                & (iou[pi] >= self.iou_threshold)
            )[0]
            if len(cand):
                gi = cand[np.argmax(iou[pi, cand])]
                gt_used[gi] = True
                if gt_valid[gi]:
                    self.n_matched += 1
                    self._preds.setdefault(lab, []).append(
                        (1.0, float(pred_scores[pi]))
                    )
                # matched-to-invalid: consumed, not scored
            else:
                self._preds.setdefault(lab, []).append(
                    (0.0, float(pred_scores[pi]))
                )

    def summary(self) -> Dict[str, float]:
        aps = {}
        all_rows: List = []
        for lab, n_gt in self._n_gt.items():
            rows = self._preds.get(lab, [])
            all_rows.extend(rows)
            if n_gt > 0 and rows:
                tp = np.asarray([r[0] for r in rows])
                sc = np.asarray([r[1] for r in rows])
                if tp.sum() > 0:
                    aps[lab] = average_precision(tp, sc, n_gt)
        if all_rows and self.n_gt_total > 0:
            tp = np.asarray([r[0] for r in all_rows])
            sc = np.asarray([r[1] for r in all_rows])
            ap_all = average_precision(tp, sc, self.n_gt_total)
        else:
            ap_all = 0.0
        return {
            "n_gt": self.n_gt_total,
            "n_pred": self.n_pred_total,
            "n_matched": self.n_matched,
            "matched_gt_ratio": self.n_matched / max(self.n_gt_total, 1),
            "AP": ap_all,
            "mAP": float(np.mean(list(aps.values()))) if aps else 0.0,
            "AP_per_label": aps,
        }
