"""Pose-error metric engine (PyTorch port of
`happypose_tpu/evaluation/meters.py`).

`PoseErrorMeter` matches predictions to ground truth greedily (best-scored
prediction first, lowest centre distance), computes ADD, ADD-S (symmetry-
aware, from the padded symmetry tensors), translation and rotation errors
of the matched pairs in one batch on the device the mesh database lives on,
and aggregates AUC and threshold recalls on the host with numpy (counts are
a few detections per image).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from happypose_tpu_torch.lib3d.rotations import geodesic_distance
from happypose_tpu_torch.lib3d.transforms import transform_pts
from happypose_tpu_torch.meshes.database import BatchedMeshes


def compute_auc_posecnn(errors: np.ndarray) -> float:
    """PoseCNN-style AUC of the error-vs-recall curve up to 0.1 m (the
    YCB_Video_toolbox procedure)."""
    errors = np.asarray(errors, dtype=np.float64).copy()
    if errors.size == 0:
        return float("nan")
    d = np.sort(errors)
    d[d > 0.1] = np.inf
    accuracy = np.cumsum(np.ones(d.shape[0])) / d.shape[0]
    ids = np.isfinite(d)
    if ids.sum() == 0:
        return float("nan")
    rec = d[ids]
    prec = accuracy[ids]
    mrec = np.concatenate(([0], rec, [0.1]))
    mpre = np.maximum.accumulate(np.concatenate(([0], prec, [prec[-1]])))
    idx = np.where(mrec[1:] != mrec[:-1])[0] + 1
    return float(((mrec[idx] - mrec[idx - 1]) * mpre[idx]).sum() * 10)


@torch.inference_mode()
def pose_errors_batch(
    TCO_pred: torch.Tensor,  # [N, 4, 4]
    TCO_gt: torch.Tensor,  # [N, 4, 4]
    points: torch.Tensor,  # [N, P, 3]
    points_mask: torch.Tensor,  # [N, P]
    symmetries: torch.Tensor,  # [N, S, 4, 4]
    sym_mask: torch.Tensor,  # [N, S]
) -> Dict[str, torch.Tensor]:
    """Per-pair error statistics, each [N]: "ADD" (min over the symmetries
    of the mean point distance), "ADD-S" (mean distance of each predicted
    point to its nearest gt point), "trans_err" and "rot_err_deg"."""
    m = points_mask[..., None].to(TCO_pred.dtype)
    denom = torch.clamp(points_mask.sum(dim=-1), min=1)

    TCO_gt_sym = torch.einsum("nij,nsjk->nsik", TCO_gt, symmetries)
    gt_pts = transform_pts(TCO_gt_sym, points)  # [N, S, P, 3]
    pred_pts = transform_pts(TCO_pred, points)  # [N, P, 3]
    d = torch.linalg.vector_norm((gt_pts - pred_pts[:, None]) * m[:, None], dim=-1)
    add_per_sym = d.sum(dim=-1) / denom[:, None]  # [N, S]
    add = add_per_sym.masked_fill(~sym_mask, torch.inf).amin(dim=-1)

    gt0 = transform_pts(TCO_gt, points)
    d2 = ((gt0[:, :, None, :] - pred_pts[:, None, :, :]) ** 2).sum(dim=-1)  # [N, Pgt, Ppred]
    d2 = d2.masked_fill(~(points_mask[:, :, None] & points_mask[:, None, :]), torch.inf)
    nn = torch.sqrt(d2.amin(dim=1))  # nearest gt per predicted point
    adds = torch.where(points_mask, nn, torch.zeros_like(nn)).sum(dim=-1) / denom

    trans_err = torch.linalg.vector_norm(TCO_pred[:, :3, 3] - TCO_gt[:, :3, 3], dim=-1)
    rot_err_deg = geodesic_distance(TCO_pred[:, :3, :3], TCO_gt[:, :3, :3]) * (180.0 / torch.pi)
    return {"ADD": add, "ADD-S": adds, "trans_err": trans_err, "rot_err_deg": rot_err_deg}


def match_poses(
    pred_keys: np.ndarray,  # [Np, K] int group keys (e.g. scene, view, label)
    gt_keys: np.ndarray,  # [Ng, K]
    pred_scores: np.ndarray,  # [Np]
    errors: np.ndarray,  # [Np, Ng] pairwise errors (inf where not matchable)
) -> List[tuple]:
    """Greedy 1-1 matching, best-scored prediction first, lowest-error GT of
    its group. Returns a list of (pred_idx, gt_idx)."""
    matches = []
    gt_used = np.zeros(len(gt_keys), bool)
    for pi in np.argsort(-pred_scores):
        cand = np.where((gt_keys == pred_keys[pi]).all(axis=1) & ~gt_used)[0]
        if len(cand) == 0:
            continue
        best = cand[np.argmin(errors[pi, cand])]
        if not np.isfinite(errors[pi, best]):
            continue
        gt_used[best] = True
        matches.append((int(pi), int(best)))
    return matches


@dataclass
class PoseErrorMeter:
    """Accumulates matched pose errors and reports summary statistics:
    `add(...)` per image batch with predictions and GT (matchable by group
    and object id); `summary()` reports AUC of ADD(-S), < 0.1 d recalls and
    mean errors. The errors are computed on the device of `meshes`."""

    meshes: BatchedMeshes
    spheres_overlap_check: bool = True
    errors: Dict[str, List[np.ndarray]] = field(default_factory=dict)
    n_gt_total: int = 0
    is_symmetric: Optional[np.ndarray] = None  # [n_obj] use ADD-S for these

    def add(
        self,
        TCO_pred: np.ndarray,  # [Np, 4, 4]
        pred_obj_ids: np.ndarray,
        pred_scores: np.ndarray,
        pred_group: np.ndarray,  # [Np] image/scene group id
        TCO_gt: np.ndarray,  # [Ng, 4, 4]
        gt_obj_ids: np.ndarray,
        gt_group: np.ndarray,
    ) -> None:
        """Match predictions to GT and accumulate the errors of the matches."""
        self.n_gt_total += len(TCO_gt)
        if len(TCO_pred) == 0 or len(TCO_gt) == 0:
            return
        # pairwise centre distance as matching error (spheres-overlap prune)
        dist = np.linalg.norm(TCO_pred[:, None, :3, 3] - TCO_gt[None, :, :3, 3], axis=-1)
        diam = self.meshes.diameters.cpu().numpy()
        gt_obj_ids, pred_obj_ids = np.asarray(gt_obj_ids), np.asarray(pred_obj_ids)
        if self.spheres_overlap_check:
            rad = diam[gt_obj_ids] / 2 + diam[pred_obj_ids][:, None] / 2
            dist = np.where(dist <= rad, dist, np.inf)
        pred_keys = np.stack([pred_group, pred_obj_ids], axis=1)
        gt_keys = np.stack([gt_group, gt_obj_ids], axis=1)
        matches = match_poses(pred_keys, gt_keys, pred_scores, dist)
        if not matches:
            return
        pi = np.asarray([m[0] for m in matches])
        gi = np.asarray([m[1] for m in matches])
        dev = self.meshes.points.device
        inst = self.meshes.select(torch.as_tensor(gt_obj_ids[gi], dtype=torch.long, device=dev))
        errs = pose_errors_batch(
            torch.as_tensor(TCO_pred[pi], dtype=torch.float32, device=dev),
            torch.as_tensor(TCO_gt[gi], dtype=torch.float32, device=dev),
            inst.points, inst.points_mask, inst.symmetries, inst.symmetries_mask,
        )
        errs = {k: v.cpu().numpy() for k, v in errs.items()}
        errs["obj_id"] = gt_obj_ids[gi]
        errs["diameter"] = diam[gt_obj_ids[gi]]
        for k, v in errs.items():
            self.errors.setdefault(k, []).append(np.asarray(v))

    def summary(self) -> Dict[str, float]:
        if not self.errors:
            return {"n_matched": 0, "n_gt": self.n_gt_total}
        E = {k: np.concatenate(v) for k, v in self.errors.items()}
        n = len(E["ADD"])
        obj_ids = E["obj_id"].astype(int)
        if self.is_symmetric is not None:
            use_adds = np.asarray(self.is_symmetric)[obj_ids]
        else:
            use_adds = np.zeros(n, bool)
        add_of_s = np.where(use_adds, E["ADD-S"], E["ADD"])

        # unmatched GTs count as infinite error in recall-style metrics
        miss = self.n_gt_total - n
        padded = np.concatenate([add_of_s, np.full(miss, np.inf)])
        n_gt = max(self.n_gt_total, 1)
        return {
            "n_matched": n,
            "n_gt": self.n_gt_total,
            "AUC/ADD(-S)": compute_auc_posecnn(padded),
            "AUC/ADD-S": compute_auc_posecnn(
                np.concatenate([E["ADD-S"], np.full(miss, np.inf)])
            ),
            "ADD(-S)<0.1d": float(
                (padded < np.concatenate([E["diameter"] * 0.1, np.full(miss, -1.0)])).mean()
            ),
            "mean_ADD": float(E["ADD"].mean()),
            "mean_ADD-S": float(E["ADD-S"].mean()),
            "mean_trans_err": float(E["trans_err"].mean()),
            "mean_rot_err_deg": float(E["rot_err_deg"].mean()),
            # ModelNet-style novel-object metrics
            "5deg_5cm": float(
                ((E["rot_err_deg"] < 5.0) & (E["trans_err"] < 0.05)).sum() / n_gt
            ),
            "ADD<0.1d": float((E["ADD"] < 0.1 * E["diameter"]).sum() / n_gt),
        }
