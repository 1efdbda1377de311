"""Pose initialization from 2D detection boxes (PyTorch port of
`happypose_tpu/lib3d/pose_init.py`)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from happypose_tpu_torch.lib3d.transforms import make_T, transform_pts
from happypose_tpu_torch.utils.cuda_graphs import device_constant

# BOP20 z-up canonical orientation used for the CosyPose coarse init: object
# z-up, camera looking along -x of the object frame.
_ZUP = ((0.0, 1.0, 0.0, 0.0),
        (0.0, 0.0, -1.0, 0.0),
        (-1.0, 0.0, 0.0, 1.0),
        (0.0, 0.0, 0.0, 1.0))


def TCO_init_from_boxes(
    z_range: Tuple[float, float], boxes: torch.Tensor, K: torch.Tensor
) -> torch.Tensor:
    """Identity rotation, z = mean(z_range), xy from the box-centre ray."""
    z = torch.full_like(boxes[:, :1], (z_range[0] + z_range[1]) / 2.0)
    uv_c = (boxes[:, 0:2] + boxes[:, 2:4]) / 2
    fxfy = torch.stack([K[:, 0, 0], K[:, 1, 1]], dim=-1)
    xy = (uv_c - K[:, 0:2, 2]) * z / fxfy
    eye = torch.eye(3, dtype=boxes.dtype, device=boxes.device)
    return make_T(eye, torch.cat([xy, z], dim=-1))


def _autodepth(
    TCO: torch.Tensor,
    boxes_2d: torch.Tensor,
    model_points_3d: torch.Tensor,
    K: torch.Tensor,
    points_mask: Optional[torch.Tensor],
) -> torch.Tensor:
    """Depth from matching the camera-frame point extent to the 2D box extent."""
    C_pts = transform_pts(TCO, model_points_3d)[..., :2]  # [B, P, 2]
    if points_mask is None:
        hi, lo = C_pts.amax(dim=1), C_pts.amin(dim=1)
    else:
        m = points_mask[..., None]
        hi = torch.where(m, C_pts, -torch.inf).amax(dim=1)
        lo = torch.where(m, C_pts, torch.inf).amin(dim=1)
    delta = hi - lo  # [B, 2] (x, y) extents
    bb_dx = (boxes_2d[:, 2] - boxes_2d[:, 0]) + 1
    bb_dy = (boxes_2d[:, 3] - boxes_2d[:, 1]) + 1
    z_from_dx = K[:, 0, 0] * delta[:, 0] / bb_dx
    z_from_dy = K[:, 1, 1] * delta[:, 1] / bb_dy
    return (z_from_dx + z_from_dy) / 2


def TCO_init_from_boxes_autodepth_with_R(
    boxes_2d: torch.Tensor,
    model_points_3d: torch.Tensor,
    K: torch.Tensor,
    R: torch.Tensor,
    points_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """SO(3)-grid hypothesis init (MegaPose coarse): given R [B, 3, 3], the
    depth is chosen so the projected point extent matches the box [B, 4];
    xy come from the box-centre ray."""
    bsz = boxes_2d.shape[0]
    R = R.expand(bsz, 3, 3)
    fxfy = torch.stack([K[:, 0, 0], K[:, 1, 1]], dim=-1)
    cxcy = K[:, 0:2, 2]
    bb_c = (boxes_2d[:, 0:2] + boxes_2d[:, 2:4]) / 2
    z_guess = 1.0
    xy0 = (bb_c - cxcy) * z_guess / fxfy
    t0 = torch.cat([xy0, torch.full_like(xy0[:, :1], z_guess)], dim=-1)
    z = _autodepth(make_T(R, t0), boxes_2d, model_points_3d, K, points_mask)
    xy = (bb_c - cxcy) * z[:, None] / fxfy
    return make_T(R, torch.cat([xy, z[:, None]], dim=-1))


def TCO_init_from_boxes_zup_autodepth(
    boxes_2d: torch.Tensor,
    model_points_3d: torch.Tensor,
    K: torch.Tensor,
    points_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """BOP20 init: the canonical z-up orientation + autodepth."""
    R = device_constant(tuple(row[:3] for row in _ZUP[:3]), boxes_2d.dtype, boxes_2d.device)
    return TCO_init_from_boxes_autodepth_with_R(
        boxes_2d, model_points_3d, K, R, points_mask
    )
