"""Crop+resize as two interpolation-matrix products (PyTorch port of
`happypose_tpu/ops/crop_resize.py`).

ROI crops are axis-aligned scale+translate resamplings, so bilinear
sampling with torchvision's aligned=False semantics (border zeroing and
clamping, the sampling_ratio average) is one interpolation matrix per axis:

    out[b] = Ry[b] @ img[b] @ Rx[b]^T

with Ry [out_h, H] / Rx [out_w, W] holding <= sampling_ratio+1 nonzeros
per row. Plain matrix products, left to `torch.matmul`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _axis_matrix(
    starts: torch.Tensor,  # [B] crop start (x1 or y1)
    sizes: torch.Tensor,  # [B] crop extent
    in_dim: int,
    out_dim: int,
    s: int,
) -> torch.Tensor:
    """[B, out_dim, in_dim] interpolation-and-average matrix for one axis."""
    B = starts.shape[0]
    dtype, device = starts.dtype, starts.device
    bin_sz = sizes / out_dim
    # sample positions: start + (o*s + i + 0.5) * bin/s for o in out, i in s
    samp = (
        torch.arange(out_dim * s, dtype=dtype, device=device)[None, :] + 0.5
    ) * (bin_sz[:, None] / s) + starts[:, None]  # [B, out*s]
    valid = (samp > -1.0) & (samp < in_dim)
    y = torch.clamp(samp, 0.0, in_dim - 1)
    idx = torch.arange(in_dim, dtype=dtype, device=device)
    # hat weights: exactly the 2-tap bilinear after clamping
    w = torch.clamp(1.0 - (y[:, :, None] - idx).abs(), min=0.0)
    w = w * valid[:, :, None]
    return w.reshape(B, out_dim, s, in_dim).mean(dim=2)


def roi_align_matmul(
    images: torch.Tensor,  # [B, C, H, W]
    boxes: torch.Tensor,  # [B, 4] (x1, y1, x2, y2)
    output_size: Tuple[int, int],
    sampling_ratio: int = 4,
    matmul_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """One ROI per image -> [B, C, out_h, out_w] in the images' dtype.
    `matmul_dtype` (bfloat16 for a bfloat16 CNN) runs both products in that
    dtype; the interpolation matrices are built in the images' dtype."""
    _, _, H, W = images.shape
    out_h, out_w = output_size
    dtype = images.dtype
    Ry = _axis_matrix(boxes[:, 1], boxes[:, 3] - boxes[:, 1], H, out_h, sampling_ratio)
    Rx = _axis_matrix(boxes[:, 0], boxes[:, 2] - boxes[:, 0], W, out_w, sampling_ratio)
    if matmul_dtype is not None:
        Ry, Rx, images = Ry.to(matmul_dtype), Rx.to(matmul_dtype), images.to(matmul_dtype)
    tmp = torch.einsum("bih,bchw->bciw", Ry, images)
    return torch.einsum("bciw,bjw->bcij", tmp, Rx).to(dtype)


def crop_images_matmul(
    images: torch.Tensor,
    boxes: torch.Tensor,
    output_size: Tuple[int, int],
    sampling_ratio: int = 4,
    matmul_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """RGB(+depth) crop; with a depth channel, crop pixels whose sampling
    touched missing depth (0) get depth 0 (that test stays in the images'
    dtype, whatever `matmul_dtype`)."""
    crops = roi_align_matmul(images, boxes, output_size, sampling_ratio, matmul_dtype)
    if images.shape[1] == 4:
        depth_valid = (images[:, 3:4] > 0).to(images.dtype)
        valid_crop = roi_align_matmul(depth_valid, boxes, output_size, sampling_ratio)
        crops = torch.cat(
            [crops[:, :3], crops[:, 3:4] * (valid_crop >= 0.99).to(images.dtype)], dim=1
        )
    return crops
