"""Camera geometry, crops and pose updates of render-and-compare, in plain
PyTorch (MegaPose, Labbé et al. CoRL 2022; DeepIM's crop). A rewrite kept
with the benchmark: nothing here imports the program.

Conventions: pixel (i, j) has its centre at (u, v) = (j, i); a camera-frame
point projects to u = fx x / z + cx, v = fy y / z + cy; a pose T [4, 4]
maps object to camera coordinates.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

GRID_DIR = Path(__file__).resolve().parent  # data_<n>.qua: x y z w per line
Z_NEAR_PROJECT = 0.1  # depth clamp of the crop's projections


def so3_grid(n: int, device) -> torch.Tensor:
    """The SO(3) grid of `n` rotations [n, 3, 3] from the `.qua` file kept
    here (quaternions x y z w, normalized in float64)."""
    q = np.loadtxt(GRID_DIR / f"data_{n}.qua", dtype=np.float64)
    q = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    x, y, z, w = (q[:, i] for i in range(4))
    R = np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], axis=-1).reshape(-1, 3, 3).astype(np.float32)
    return torch.from_numpy(R).to(device)


def rotation_from_quat(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrices [..., 3, 3] of quaternions (x, y, z, w) [..., 4],
    normalized first."""
    x, y, z, w = (q / q.norm(dim=-1, keepdim=True)).unbind(-1)
    return torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
                        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
                       -1).reshape(*q.shape[:-1], 3, 3)


def make_T(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    bottom = torch.zeros(*R.shape[:-2], 1, 4, dtype=R.dtype, device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([torch.cat([R, t[..., None]], dim=-1), bottom], dim=-2)


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-8)


def rotation_from_6d(x: torch.Tensor) -> torch.Tensor:
    """Zhou et al.'s continuous rotation: Gram-Schmidt on two 3-vectors,
    the columns of the result."""
    a = _unit(x[..., 0:3])
    c = _unit(torch.linalg.cross(a, x[..., 3:6]))
    b = torch.linalg.cross(c, a)
    return torch.stack((a, b, c), dim=-1)


def orthonormalize(T: torch.Tensor) -> torch.Tensor:
    """The pose with its rotation rebuilt from its first two columns."""
    six = torch.cat([T[..., :3, 0], T[..., :3, 1]], dim=-1)
    return make_T(rotation_from_6d(six), T[..., :3, 3])


def project(points: torch.Tensor, K: torch.Tensor, T: torch.Tensor,
            z_min: float = Z_NEAR_PROJECT) -> torch.Tensor:
    """uv [B, P, 2] of object points [B, P, 3], the depth clamped at z_min."""
    cam = torch.einsum("bij,bpj->bpi", T[:, :3, :3], points) + T[:, None, :3, 3]
    suv = torch.einsum("bij,bpj->bpi", K, cam)
    return suv[..., :2] / torch.clamp(suv[..., 2:3], min=z_min)


def point_boxes(uv: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(xmin, ymin, xmax, ymax) [B, 4] over the valid points."""
    m = mask[..., None]
    return torch.cat([torch.where(m, uv, torch.inf).amin(1),
                      torch.where(m, uv, -torch.inf).amax(1)], dim=-1)


def crop_boxes(center: torch.Tensor, boxes: torch.Tensor, lamb: float,
               size) -> torch.Tensor:
    """DeepIM's crop: centred on `center` [B, 2], covering `boxes` [B, 4],
    grown by `lamb`, at the aspect ratio of `size` (h, w)."""
    w, h = float(max(size)), float(min(size))
    r = w / h
    xc, yc = center[:, 0], center[:, 1]
    xd = torch.stack([(boxes[:, 0] - xc).abs(), (boxes[:, 0] - xc).abs(),
                      (boxes[:, 2] - xc).abs(), (boxes[:, 2] - xc).abs()], 1).amax(1)
    yd = torch.stack([(boxes[:, 1] - yc).abs(), (boxes[:, 1] - yc).abs(),
                      (boxes[:, 3] - yc).abs(), (boxes[:, 3] - yc).abs()], 1).amax(1)
    width = torch.maximum(xd, yd * r) * 2 * lamb
    height = torch.maximum(xd / r, yd) * 2 * lamb
    return torch.stack([xc - width / 2, yc - height / 2, xc + width / 2, yc + height / 2], 1)


def crop_intrinsics(K: torch.Tensor, boxes: torch.Tensor, size) -> torch.Tensor:
    """The camera of a crop `boxes` [B, 4] resized to `size` (h, w): the
    principal point moves by (box size - 1) / 2, then scales about the
    resized image's centre."""
    fw, fh = float(max(size)), float(min(size))
    cw, ch = boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1]
    cx = K[:, 0, 2] + (cw - 1) / 2 - (boxes[:, 0] + boxes[:, 2]) / 2
    cy = K[:, 1, 2] + (ch - 1) / 2 - (boxes[:, 1] + boxes[:, 3]) / 2
    sx, sy = fw / cw, fh / ch
    out = torch.zeros_like(K)
    out[:, 0, 0] = sx * K[:, 0, 0]
    out[:, 1, 1] = sy * K[:, 1, 1]
    out[:, 0, 2] = (fw - 1) / 2 + sx * (cx - (cw - 1) / 2)
    out[:, 1, 2] = (fh - 1) / 2 + sy * (cy - (ch - 1) / 2)
    out[:, 2, 2] = 1.0
    return out


def _interpolation(starts, sizes, n_in: int, n_out: int, s: int) -> torch.Tensor:
    """[B, n_out, n_in]: torchvision's roi_align (aligned=False) along one
    axis: `s` bilinear samples a bin, averaged; samples beyond (-1, n_in)
    count as zero, the others clamp to the border."""
    B = starts.shape[0]
    pos = (torch.arange(n_out * s, dtype=starts.dtype, device=starts.device)[None] + 0.5) \
        * (sizes / n_out)[:, None] / s + starts[:, None]
    inside = (pos > -1.0) & (pos < n_in)
    pos = torch.clamp(pos, 0.0, n_in - 1)
    grid = torch.arange(n_in, dtype=starts.dtype, device=starts.device)
    w = torch.clamp(1.0 - (pos[:, :, None] - grid).abs(), min=0.0) * inside[:, :, None]
    return w.reshape(B, n_out, s, n_in).mean(dim=2)


def crop(images: torch.Tensor, boxes: torch.Tensor, size, s: int = 4) -> torch.Tensor:
    """roi_align of one box an image: [B, C, H, W] -> [B, C, h, w]."""
    H, W = images.shape[-2:]
    Ry = _interpolation(boxes[:, 1], boxes[:, 3] - boxes[:, 1], H, size[0], s)
    Rx = _interpolation(boxes[:, 0], boxes[:, 2] - boxes[:, 0], W, size[1], s)
    rows = torch.einsum("bih,bchw->bciw", Ry, images)
    return torch.einsum("bciw,bjw->bcij", rows, Rx)


def update_pose(T: torch.Tensor, K_crop: torch.Tensor, v: torch.Tensor,
                dR: torch.Tensor, tCR: torch.Tensor) -> torch.Tensor:
    """MegaPose's update about the reference point tCR: (vx, vy) move its
    image position in crop pixels over the focal lengths, vz scales its
    depth, dR rotates about it in the camera frame."""
    z0 = tCR[:, 2:3]
    z1 = v[:, 2:3] * z0
    f = torch.stack([K_crop[:, 0, 0], K_crop[:, 1, 1]], dim=-1)
    tCR1 = torch.cat([(v[:, 0:2] / f + tCR[:, 0:2] / z0) * z1, z1], dim=-1)
    t1 = (dR @ (T[:, :3, 3] - tCR)[..., None])[..., 0] + tCR1
    return make_T(dR @ T[:, :3, :3], t1)


def autodepth_init(boxes: torch.Tensor, points: torch.Tensor, mask: torch.Tensor,
                   K: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """MegaPose's hypothesis init: rotation R, on the ray of the box centre,
    at the depth whose projected point extent matches the box's (the mean
    of the x and y estimates, from a start at z = 1)."""
    f = torch.stack([K[:, 0, 0], K[:, 1, 1]], dim=-1)
    c = K[:, 0:2, 2]
    bc = (boxes[:, 0:2] + boxes[:, 2:4]) / 2
    t0 = torch.cat([(bc - c) / f, torch.ones_like(bc[:, :1])], dim=-1)
    cam = torch.einsum("bij,bpj->bpi", R, points) + t0[:, None]
    xy = cam[..., :2]
    m = mask[..., None]
    extent = torch.where(m, xy, -torch.inf).amax(1) - torch.where(m, xy, torch.inf).amin(1)
    bw = boxes[:, 2] - boxes[:, 0] + 1
    bh = boxes[:, 3] - boxes[:, 1] + 1
    z = (K[:, 0, 0] * extent[:, 0] / bw + K[:, 1, 1] * extent[:, 1] / bh) / 2
    return make_T(R, torch.cat([(bc - c) * z[:, None] / f, z[:, None]], dim=-1))
