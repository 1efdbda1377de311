"""DeepIM-style crop boxes and crops (PyTorch port of
`happypose_tpu/lib3d/cropping.py`). Crops go through `ops/roi_align.py`
(torchvision's `roi_align` semantics)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from happypose_tpu_torch.lib3d.camera import (
    boxes_from_uv,
    masked_boxes_from_uv,
    project_points,
    project_points_robust,
)
from happypose_tpu_torch.ops.roi_align import crop_images


def deepim_boxes(
    rend_center_uv: torch.Tensor,
    obs_boxes: torch.Tensor,
    rend_boxes: torch.Tensor,
    lamb: float = 1.4,
    im_size: Tuple[int, int] = (240, 320),
) -> torch.Tensor:
    """Crop boxes [B, 4] (x1, y1, x2, y2) centred on the projected anchor
    `rend_center_uv` [B, 1, 2], covering the observed and rendered boxes
    [B, 4], expanded by `lamb` and forced to the aspect ratio of `im_size`
    (h, w). Unclamped: a box may exceed the image."""
    xc = rend_center_uv[:, 0, 0]
    yc = rend_center_uv[:, 0, 1]
    w = float(max(im_size))
    h = float(min(im_size))
    r = w / h
    xdist = torch.stack(
        [
            (obs_boxes[:, 0] - xc).abs(),
            (rend_boxes[:, 0] - xc).abs(),
            (obs_boxes[:, 2] - xc).abs(),
            (rend_boxes[:, 2] - xc).abs(),
        ],
        dim=1,
    ).amax(dim=1)
    ydist = torch.stack(
        [
            (obs_boxes[:, 1] - yc).abs(),
            (rend_boxes[:, 1] - yc).abs(),
            (obs_boxes[:, 3] - yc).abs(),
            (rend_boxes[:, 3] - yc).abs(),
        ],
        dim=1,
    ).amax(dim=1)
    width = torch.maximum(xdist, ydist * r) * 2 * lamb
    height = torch.maximum(xdist / r, ydist) * 2 * lamb
    return torch.stack(
        [xc - width / 2, yc - height / 2, xc + width / 2, yc + height / 2], dim=1
    )


def _rend_boxes(uv: torch.Tensor, points_mask: Optional[torch.Tensor]) -> torch.Tensor:
    return boxes_from_uv(uv) if points_mask is None else masked_boxes_from_uv(uv, points_mask)


def deepim_crops(
    images: torch.Tensor,
    obs_boxes: torch.Tensor,
    K: torch.Tensor,
    TCO_pred: torch.Tensor,
    O_vertices: torch.Tensor,
    output_size: Optional[Tuple[int, int]] = None,
    lamb: float = 1.4,
    points_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CosyPose crop of images [B, C, H, W]: the anchor is the
    projected object origin. Returns (boxes [B, 4], crops)."""
    B, _, h, w = images.shape
    output_size = output_size or (h, w)
    rend_boxes = _rend_boxes(project_points(O_vertices, K, TCO_pred), points_mask)
    center = project_points(images.new_zeros((B, 1, 3)), K, TCO_pred)
    boxes = deepim_boxes(center, obs_boxes, rend_boxes, lamb=lamb, im_size=(h, w))
    return boxes, crop_images(images, boxes, output_size=output_size, sampling_ratio=4)


def deepim_crops_robust(
    images: torch.Tensor,
    obs_boxes: torch.Tensor,
    K: torch.Tensor,
    TCO_pred: torch.Tensor,
    tCR_in: torch.Tensor,
    O_vertices: torch.Tensor,
    output_size: Optional[Tuple[int, int]] = None,
    lamb: float = 1.4,
    return_crops: bool = True,
    points_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The MegaPose crop: the anchor is the reference point `tCR_in` [B, 3],
    projections clamp z. Returns (boxes [B, 4], crops or None)."""
    B, _, h, w = images.shape
    output_size = output_size or (h, w)
    rend_boxes = _rend_boxes(project_points_robust(O_vertices, K, TCO_pred), points_mask)
    TCR = TCO_pred.clone()
    TCR[:, :3, 3] = tCR_in
    center = project_points_robust(images.new_zeros((B, 1, 3)), K, TCR)
    boxes = deepim_boxes(center, obs_boxes, rend_boxes, lamb=lamb, im_size=(h, w))
    crops = (crop_images(images, boxes, output_size=output_size, sampling_ratio=4)
             if return_crops else None)
    return boxes, crops
