"""Pinhole camera geometry (PyTorch port of `happypose_tpu/lib3d/camera.py`)."""

from __future__ import annotations

from typing import Tuple

import torch


def project_points(
    points_3d: torch.Tensor, K: torch.Tensor, TCO: torch.Tensor
) -> torch.Tensor:
    """Project object-frame points [B, P, 3] through TCO [B, 4, 4] and K
    [B, 3, 3] -> uv [B, P, 2]. Depth is not clamped: bundle adjustment
    differentiates through the division by z."""
    cam_pts = (
        torch.einsum("bij,bpj->bpi", TCO[:, :3, :3], points_3d)
        + TCO[:, None, :3, 3]
    )
    suv = torch.einsum("bij,bpj->bpi", K, cam_pts)
    return suv[..., :2] / suv[..., 2:3]


def project_points_robust(
    points_3d: torch.Tensor, K: torch.Tensor, TCO: torch.Tensor, z_min: float = 0.1
) -> torch.Tensor:
    """Project object-frame points [B, P, 3] through TCO [B, 4, 4] and K
    [B, 3, 3] -> uv [B, P, 2], with depth clamped at `z_min`."""
    cam_pts = (
        torch.einsum("bij,bpj->bpi", TCO[:, :3, :3], points_3d)
        + TCO[:, None, :3, 3]
    )
    suv = torch.einsum("bij,bpj->bpi", K, cam_pts)
    return suv[..., :2] / torch.clamp(suv[..., 2:3], min=z_min)


def boxes_from_uv(uv: torch.Tensor) -> torch.Tensor:
    """Tight (xmin, ymin, xmax, ymax) boxes [B, 4] over uv [B, P, 2]."""
    return torch.cat([uv.amin(dim=1), uv.amax(dim=1)], dim=-1)


def masked_boxes_from_uv(uv: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(xmin, ymin, xmax, ymax) over the valid points of uv [B, P, 2];
    mask [B, P] bool."""
    m = mask[..., None]
    mins = torch.where(m, uv, torch.inf).amin(dim=1)
    maxs = torch.where(m, uv, -torch.inf).amax(dim=1)
    return torch.cat([mins, maxs], dim=-1)


def get_K_crop_resize(
    K: torch.Tensor,
    boxes: torch.Tensor,
    orig_size: Tuple[int, int],
    crop_resize: Tuple[int, int],
) -> torch.Tensor:
    """Intrinsics of the virtual camera after cropping `boxes` [B, 4] and
    resizing to `crop_resize` (h, w). Same pixel-centre convention as the
    JAX package: the principal point moves by (box size - 1)/2 during the
    crop, then scales about the resized image centre. `orig_size` (h, w)
    of the source image is not used, as in the JAX package, whose
    signature this keeps."""
    del orig_size
    final_width = float(max(crop_resize))
    final_height = float(min(crop_resize))
    crop_w = boxes[:, 2] - boxes[:, 0]
    crop_h = boxes[:, 3] - boxes[:, 1]
    crop_cj = (boxes[:, 0] + boxes[:, 2]) / 2
    crop_ci = (boxes[:, 1] + boxes[:, 3]) / 2

    cx = K[:, 0, 2] + (crop_w - 1) / 2 - crop_cj
    cy = K[:, 1, 2] + (crop_h - 1) / 2 - crop_ci

    scale_x = final_width / crop_w
    scale_y = final_height / crop_h
    fx = scale_x * K[:, 0, 0]
    fy = scale_y * K[:, 1, 1]
    cx = (final_width - 1) / 2 + scale_x * (cx - (crop_w - 1) / 2)
    cy = (final_height - 1) / 2 + scale_y * (cy - (crop_h - 1) / 2)

    zeros = torch.zeros_like(fx)
    ones = torch.ones_like(fx)
    return torch.stack(
        [fx, zeros, cx, zeros, fy, cy, zeros, zeros, ones], dim=-1
    ).reshape(-1, 3, 3)


def cropresize_backtransform_points2d(
    input_wh: torch.Tensor,
    boxes_2d_crop: torch.Tensor,
    output_wh: torch.Tensor,
    points_2d_in_output: torch.Tensor,
) -> torch.Tensor:
    """Map points [B, P, 2] of a resized crop back to source-image pixels:
    crop boxes [B, 4], crop sizes `input_wh` [B, 2], resized sizes
    `output_wh` [B, 2]."""
    points_norm = points_2d_in_output / output_wh[:, None, :]
    return boxes_2d_crop[:, None, 0:2] + points_norm * input_wh[:, None, :]
