"""Image transforms (PyTorch port of `crop_resize_to_aspect` from
`happypose_tpu/datasets/augmentations.py`; the training augmentations are
not ported)."""

from __future__ import annotations

from typing import Tuple

import torch

from happypose_tpu_torch.lib3d.camera import get_K_crop_resize
from happypose_tpu_torch.ops.crop_resize import roi_align_matmul


def crop_resize_to_aspect(
    images: torch.Tensor,  # [B, C, H, W]
    K: torch.Tensor,  # [B, 3, 3]
    target_hw: Tuple[int, int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Centre-crop to the target aspect ratio, then resize to `target_hw`;
    returns the images and their updated intrinsics."""
    B, _, H, W = images.shape
    th, tw = target_hw
    target_ratio = tw / th
    if W / H > target_ratio:
        crop_w, crop_h = H * target_ratio, H
    else:
        crop_w, crop_h = W, W / target_ratio
    x1 = (W - crop_w) / 2
    y1 = (H - crop_h) / 2
    boxes = torch.tensor(
        [x1, y1, x1 + crop_w, y1 + crop_h], dtype=torch.float32, device=images.device
    ).expand(B, 4)
    out = roi_align_matmul(images, boxes, target_hw, sampling_ratio=2)
    return out, get_K_crop_resize(K, boxes, target_hw)
