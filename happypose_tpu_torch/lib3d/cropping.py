"""DeepIM-style crop boxes (PyTorch port of `happypose_tpu/lib3d/cropping.py`)."""

from __future__ import annotations

from typing import Tuple

import torch


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
