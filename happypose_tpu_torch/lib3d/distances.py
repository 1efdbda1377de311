"""Pose distances and losses: ADD, ADD-S, symmetry-aware minima (PyTorch
port of `happypose_tpu/lib3d/distances.py`). `argmin` returns the first
minimum, as `jnp.argmin` does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from happypose_tpu_torch.lib3d.transforms import transform_pts


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, S, ...], idx [B] -> x[b, idx[b]] [B, ...]."""
    return x[torch.arange(x.shape[0], device=x.device), idx]


def dists_add(
    TXO_pred: torch.Tensor, TXO_gt: torch.Tensor, points: torch.Tensor
) -> torch.Tensor:
    """Per-point residuals gt - pred, [B, P, 3]."""
    return transform_pts(TXO_gt, points) - transform_pts(TXO_pred, points)


def _nearest_gt(TXO_pred, TXO_gt, points):
    """(d [B, Pgt, Ppred, 3] = gt_i - pred_j, assign [B, Ppred]: for each
    predicted point the index of its nearest gt point)."""
    pred = transform_pts(TXO_pred, points)
    gt = transform_pts(TXO_gt, points)
    d = gt[:, :, None, :] - pred[:, None, :, :]
    return d, (d * d).sum(dim=-1).argmin(dim=1)


def dists_add_symmetric(
    TXO_pred: torch.Tensor, TXO_gt: torch.Tensor, points: torch.Tensor
) -> torch.Tensor:
    """ADD-S residuals [B, P, 3]: for every predicted point j, gt_i - pred_j
    of the gt point i nearest to it."""
    d, assign = _nearest_gt(TXO_pred, TXO_gt, points)
    return torch.gather(d, 1, assign[:, None, :, None].expand(-1, 1, -1, 3))[:, 0]


def _masked_point_mean(per: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of per [..., P, 3] over the masked-in points and the 3 coords."""
    m = mask[..., None].to(per.dtype)
    return (per * m).sum(dim=(-1, -2)) / torch.clamp(m.sum(dim=(-1, -2)) * 3, min=1.0) * 3.0


def compute_ADD_L1_loss(
    TCO_gt: torch.Tensor, TCO_pred: torch.Tensor, points: torch.Tensor,
    points_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean |gt - pred| over points and coords, [B]."""
    diff = dists_add(TCO_pred, TCO_gt, points).abs()
    if points_mask is not None:
        return _masked_point_mean(diff, points_mask)
    return diff.mean(dim=(-1, -2))


def compute_ADDS_loss(
    TCO_gt: torch.Tensor, TCO_pred: torch.Tensor, points: torch.Tensor
) -> torch.Tensor:
    """Symmetric squared loss with nearest-point assignment, [B]."""
    d, assign = _nearest_gt(TCO_pred, TCO_gt, points)
    matched = torch.gather(d * d, 1, assign[:, None, :, None].expand(-1, 1, -1, 3))[:, 0]
    return matched.mean(dim=(-1, -2))


def loss_CO_symmetric(
    TCO_possible_gt: torch.Tensor,  # [B, S, 4, 4]
    TCO_pred: torch.Tensor,  # [B, 4, 4]
    points: torch.Tensor,  # [B, P, 3]
    l2: bool = False,
    points_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Min over symmetry-expanded GT poses of the mean pointwise loss.
    Returns (loss [B], the selected GT pose [B, 4, 4])."""
    gt_pts = transform_pts(TCO_possible_gt, points)  # [B, S, P, 3]
    pred_pts = transform_pts(TCO_pred, points)
    diff = pred_pts[:, None] - gt_pts
    per = diff ** 2 if l2 else diff.abs()
    if points_mask is not None:
        losses = _masked_point_mean(per, points_mask[:, None])
    else:
        losses = per.flatten(2).mean(dim=-1)  # [B, S]
    min_id = losses.argmin(dim=1)
    return _take(losses, min_id), _take(TCO_possible_gt, min_id)


def symmetric_distance_batched(
    T1: torch.Tensor,  # [B, 4, 4]
    T2: torch.Tensor,  # [B, 4, 4]
    points: torch.Tensor,  # [B, P, 3]
    symmetries: torch.Tensor,  # [B, S, 4, 4]
    points_mask: Optional[torch.Tensor] = None,
    sym_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """min_s mean_p || T1 S_s p - T2 p || [B] and the aligned pose
    T1 @ S_best [B, 4, 4]; padded symmetries are masked out by `sym_mask`."""
    T1_sym = torch.einsum("bij,bsjk->bsik", T1, symmetries)
    pts1 = transform_pts(T1_sym, points)  # [B, S, P, 3]
    pts2 = transform_pts(T2, points)
    d = torch.linalg.vector_norm(pts1 - pts2[:, None], dim=-1)  # [B, S, P]
    if points_mask is not None:
        m = points_mask[:, None, :].to(d.dtype)
        dist_per_sym = (d * m).sum(dim=-1) / torch.clamp(m.sum(dim=-1), min=1.0)
    else:
        dist_per_sym = d.mean(dim=-1)
    if sym_mask is not None:
        dist_per_sym = dist_per_sym.masked_fill(~sym_mask, torch.inf)
    best = dist_per_sym.argmin(dim=1)
    return _take(dist_per_sym, best), _take(T1_sym, best)
