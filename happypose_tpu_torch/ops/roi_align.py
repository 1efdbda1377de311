"""ROI-align (bilinear crop + resize) in its gather form (PyTorch port of
`happypose_tpu/ops/roi_align.py`).

torchvision.ops.roi_align semantics with ``aligned=False`` and a fixed
``sampling_ratio``, one ROI per image. The pipelines crop with the matrix
form, `ops/crop_resize.py`; this form samples pixel by pixel and is the
oracle the tests hold that one to.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _bilinear_gather(image: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Sample images [B, C, H, W] at float coords ys / xs [B, N] -> [B, C, N]
    with torchvision's border rule: points outside (-1, H) x (-1, W) give 0;
    inside points are clamped to the valid range before interpolation."""
    B, C, H, W = image.shape
    valid = (ys > -1.0) & (ys < H) & (xs > -1.0) & (xs < W)
    y = torch.clamp(ys, 0.0, H - 1)
    x = torch.clamp(xs, 0.0, W - 1)
    y0 = torch.floor(y).long()
    x0 = torch.floor(x).long()
    y1 = torch.clamp(y0 + 1, max=H - 1)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    ly = y - y0
    lx = x - x0
    hy = 1.0 - ly
    hx = 1.0 - lx
    flat = image.reshape(B, C, H * W)

    def g(yy, xx):  # [B, N] -> [B, C, N]
        return torch.gather(flat, 2, (yy * W + xx)[:, None, :].expand(-1, C, -1))

    val = (
        g(y0, x0) * (hy * hx)[:, None]
        + g(y0, x1) * (hy * lx)[:, None]
        + g(y1, x0) * (ly * hx)[:, None]
        + g(y1, x1) * (ly * lx)[:, None]
    )
    return torch.where(valid[:, None, :], val, torch.zeros_like(val))


def roi_align(
    images: torch.Tensor,  # [B, C, H, W]
    boxes: torch.Tensor,  # [B, 4] (x1, y1, x2, y2) in pixels; ROI i crops image i
    output_size: Tuple[int, int],
    sampling_ratio: int = 4,
) -> torch.Tensor:
    """Crop + resize with bilinear sampling -> [B, C, out_h, out_w]: each
    output pixel is the mean of `sampling_ratio`^2 samples of its bin."""
    B = images.shape[0]
    out_h, out_w = output_size
    s = sampling_ratio
    x1, y1, x2, y2 = (boxes[:, i, None] for i in range(4))
    bin_w = (x2 - x1) / out_w
    bin_h = (y2 - y1) / out_h
    steps_y = torch.arange(out_h * s, dtype=images.dtype, device=images.device) + 0.5
    steps_x = torch.arange(out_w * s, dtype=images.dtype, device=images.device) + 0.5
    gy = y1 + steps_y * (bin_h / s)  # [B, out_h*s]
    gx = x1 + steps_x * (bin_w / s)  # [B, out_w*s]
    ys = gy.repeat_interleave(out_w * s, dim=1)
    xs = gx.repeat(1, out_h * s)
    vals = _bilinear_gather(images, ys, xs)  # [B, C, (out_h*s)*(out_w*s)]
    return vals.reshape(B, -1, out_h, s, out_w, s).mean(dim=(3, 5))


def crop_images(
    images: torch.Tensor,
    boxes: torch.Tensor,
    output_size: Tuple[int, int],
    sampling_ratio: int = 4,
) -> torch.Tensor:
    """RGB(+depth) crop. With a 4th channel (depth), crop pixels whose
    sampling mixed valid and missing (== 0) depth get depth 0."""
    crops = roi_align(images, boxes, output_size, sampling_ratio)
    if images.shape[1] == 4:
        depth_valid = (images[:, 3:4] > 0).to(images.dtype)
        valid_crop = roi_align(depth_valid, boxes, output_size, sampling_ratio)
        crops = torch.cat(
            [crops[:, :3], crops[:, 3:4] * (valid_crop >= 0.99).to(images.dtype)], dim=1
        )
    return crops
