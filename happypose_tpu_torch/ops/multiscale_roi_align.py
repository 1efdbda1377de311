"""RoIAlign over a feature pyramid, each RoI read from its own level: the
wrapper of the hand-written CUDA kernel `roi_align_kernel`
(`csrc/mask_rcnn_ops.cu`), its plain PyTorch version, and torchvision's
level mapper (`MultiScaleRoIAlign`'s `LevelMapper`).

torchvision's `roi_align` with `aligned=False` and a fixed sampling ratio:
a RoI (x1, y1, x2, y2) in image pixels is scaled to its level, its size
taken at least 1, cut into P x P bins, and each output is the mean of
S x S bilinear samples at the bin's sub-cell centres; a sample outside
(-1, H] x (-1, W] reads 0, one inside is clamped to the level. The gather
form of `ops/roi_align.py` crops one RoI an image at one scale; here
[B, R] RoIs read pyramids of B images.

`multiscale_roi_align` sends CUDA tensors to the kernel and CPU tensors
to `roi_align_reference`, which repeats the kernel's float32 arithmetic
operation for operation. No fallback: a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence

import torch

# Kernel launches since the last reset; the CPU path never counts.
launches = 0
CANONICAL_SCALE = 224.0
CANONICAL_LEVEL = 4.0
LEVEL_EPS = 1e-6


def level_of(boxes: torch.Tensor, k_min: int, k_max: int) -> torch.Tensor:
    """torchvision's `LevelMapper` (FPN paper, eq. 1): the pyramid level of
    each box, floor(4 + log2(sqrt(area) / 224) + 1e-6) clamped to
    [k_min, k_max], minus k_min (an index into the levels given)."""
    s = torch.sqrt((boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1]))
    lvl = torch.floor(CANONICAL_LEVEL + torch.log2(s / CANONICAL_SCALE)
                      + torch.tensor(LEVEL_EPS, dtype=s.dtype))
    return (torch.clamp(lvl, min=k_min, max=k_max).to(torch.int64) - k_min)


def level_scale(feature_hw: int, image_hw: int) -> float:
    """torchvision's `_infer_scale`: the level's scale, a power of two."""
    return 2.0 ** round(math.log2(feature_hw / image_hw))


def _bilinear(rows: torch.Tensor, HW, b: torch.Tensor, y: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
    """torchvision's `bilinear_interpolate` of a level's rows [B * H * W, C]
    (channels last) at y, x [n, K] of images b [n] -> [n, K, C]."""
    H, W = HW
    outside = (y < -1.0) | (y > H) | (x < -1.0) | (x > W)
    y = torch.where(y <= 0, torch.zeros_like(y), y)
    x = torch.where(x <= 0, torch.zeros_like(x), x)
    y_low, x_low = y.to(torch.int64), x.to(torch.int64)
    top, right = y_low >= H - 1, x_low >= W - 1
    y_low = torch.where(top, torch.full_like(y_low, H - 1), y_low)
    x_low = torch.where(right, torch.full_like(x_low, W - 1), x_low)
    y = torch.where(top, y_low.to(y.dtype), y)
    x = torch.where(right, x_low.to(x.dtype), x)
    y_high = torch.where(top, y_low, y_low + 1)
    x_high = torch.where(right, x_low, x_low + 1)
    ly, lx = y - y_low.to(y.dtype), x - x_low.to(x.dtype)
    hy, hx = 1.0 - ly, 1.0 - lx
    base = b[:, None] * (H * W)

    def tap(yy, xx):
        return rows[base + yy * W + xx]

    w1, w2, w3, w4 = ((u * v)[..., None] for u, v in ((hy, hx), (hy, lx), (ly, hx), (ly, lx)))
    val = w1 * tap(y_low, x_low) + w2 * tap(y_low, x_high) + w3 * tap(y_high, x_low) \
        + w4 * tap(y_high, x_high)
    return torch.where(outside[..., None], torch.zeros_like(val), val)


def _sample_coords(start: torch.Tensor, bin_size: torch.Tensor, P: int, S: int) -> torch.Tensor:
    """[n, P, S]: start + p * bin + ((s + 0.5) * bin) / S, in the kernel's
    order, of starts and bins [n]."""
    p = torch.arange(P, dtype=start.dtype, device=start.device)[:, None]
    s = torch.arange(S, dtype=start.dtype, device=start.device)[None, :]
    start, bin_size = start[:, None, None], bin_size[:, None, None]
    return (start + p * bin_size) + ((s + 0.5) * bin_size) / S


def roi_align_reference(features: Sequence[torch.Tensor], scales: Sequence[float],
                        rois: torch.Tensor, levels: torch.Tensor, output_size: int,
                        sampling_ratio: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: [B * R, C, P, P]."""
    B, R = rois.shape[:2]
    P, S = output_size, sampling_ratio
    C = features[0].shape[1]
    flat, lv = rois.reshape(-1, 4), levels.reshape(-1)
    img = torch.arange(B, device=rois.device).repeat_interleave(R)
    out = torch.zeros(B * R, C, P, P, dtype=features[0].dtype, device=rois.device)
    for lvl, (f, scale) in enumerate(zip(features, scales)):
        sel = (lv == lvl).nonzero()[:, 0]
        if not len(sel):
            continue
        H, W = f.shape[-2:]
        rows = f.permute(0, 2, 3, 1).reshape(-1, C)
        x1, y1, x2, y2 = (flat[sel, k] * float(scale) for k in range(4))
        roi_w = torch.clamp(x2 - x1, min=1.0)
        roi_h = torch.clamp(y2 - y1, min=1.0)
        n = len(sel)
        ys = _sample_coords(y1, roi_h / P, P, S)  # [n, P, S]
        xs = _sample_coords(x1, roi_w / P, P, S)
        yy = ys[:, :, :, None, None].expand(n, P, S, P, S).reshape(n, -1)
        xx = xs[:, None, None].expand(n, P, S, P, S).reshape(n, -1)
        v = _bilinear(rows, (H, W), img[sel], yy, xx).reshape(n, P, S, P, S, C)
        acc = torch.zeros(n, P, P, C, dtype=f.dtype, device=f.device)
        for iy in range(S):
            for ix in range(S):
                acc = acc + v[:, :, iy, :, ix]
        out[sel] = (acc / float(S * S)).permute(0, 3, 1, 2)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.roi_align_launch.argtypes = [vp] * 4 + [ctypes.POINTER(ctypes.c_int),
                                                ctypes.POINTER(ctypes.c_float)] \
        + [vp] * 3 + [ci] * 6 + [vp]
    lib.roi_align_launch.restype = ci
    lib.mask_rcnn_error_string.argtypes = [ci]
    lib.mask_rcnn_error_string.restype = ctypes.c_char_p
    return lib


def _kernel_library() -> ctypes.CDLL:
    from happypose_tpu_torch.csrc import load_library

    return _bind(load_library("mask_rcnn_ops"))


def multiscale_roi_align(features: Sequence[torch.Tensor], scales: Sequence[float],
                         rois: torch.Tensor, levels: torch.Tensor, output_size: int,
                         sampling_ratio: int = 2) -> torch.Tensor:
    """RoIAlign of rois [B, R, 4] (image pixels, taken in float32), RoI
    (b, r) read from `features[levels[b, r]]` ([B, C, H_l, W_l], float32,
    at most 4 levels) scaled by `scales[l]`: [B * R, C, P, P],
    P = `output_size`."""
    global launches
    if not 1 <= len(features) <= 4 or len(scales) != len(features):
        raise ValueError("one to four levels, each with its scale")
    B, R = rois.shape[:2]
    C = features[0].shape[1]
    for f in features:
        if f.dim() != 4 or f.shape[:2] != (B, C) or f.dtype != torch.float32:
            raise ValueError(f"features must be [{B}, {C}, H, W] float32, got "
                             f"{tuple(f.shape)} {f.dtype}")
    if rois.shape != (B, R, 4) or levels.shape != (B, R):
        raise ValueError(f"rois [B, R, 4] and levels [B, R], got {tuple(rois.shape)}, "
                         f"{tuple(levels.shape)}")
    rois = rois.float()
    if rois.device.type == "cpu":
        return roi_align_reference(features, scales, rois, levels, output_size, sampling_ratio)
    if rois.device.type != "cuda":
        raise ValueError(f"multiscale_roi_align runs on CUDA or CPU tensors, not {rois.device}")
    if B * R * C * output_size ** 2 >= 2**31:
        raise ValueError("at most 2^31 - 1 output values a call: the kernel indexes with an int")
    feats = [f.contiguous() for f in features]
    rois_c = rois.contiguous()
    lv = levels.to(torch.int32).contiguous()
    out = torch.empty(B * R, C, output_size, output_size, dtype=torch.float32,
                      device=rois.device)
    ptrs = [f.data_ptr() for f in feats] + [0] * (4 - len(feats))
    hw = [v for f in feats for v in f.shape[-2:]] + [1] * (8 - 2 * len(feats))
    sc = [float(s) for s in scales] + [1.0] * (4 - len(scales))
    lib = _kernel_library()
    err = lib.roi_align_launch(*ptrs, (ctypes.c_int * 8)(*hw), (ctypes.c_float * 4)(*sc),
                               rois_c.data_ptr(), lv.data_ptr(), out.data_ptr(), B * R, R, C,
                               output_size, sampling_ratio, rois.device.index,
                               torch.cuda.current_stream(rois.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"roi_align kernel launch failed: "
                           f"{lib.mask_rcnn_error_string(err).decode()} ({err})")
    launches += 1
    return out
