"""Additional-viewpoint cameras for render-and-compare (PyTorch port of
`happypose_tpu/lib3d/multiview_geom.py`).

Conventions (OpenCV-style camera): x right, y down, z forward. The extra
cameras sit at offsets (scaled by |tCR|) expressed in the frame of a camera
at the origin looking at the reference point, and each looks at the
reference point with camera-0's up vector.
"""

from __future__ import annotations

import math

import torch

from happypose_tpu_torch.lib3d.transforms import invert_transforms, make_T
from happypose_tpu_torch.utils.cuda_graphs import device_constant


def _sphere_26_offsets():
    """26-point grid around the reference point (panda y in {0,1,2} scaled by
    radius; skips the position coincident with the reference point)."""
    out = []
    for y in (0, 1, 2):
        for x in (0, -1, 1):
            for z in (0, 1, -1):
                if (x, y, z) == (0, 1, 0):
                    continue
                out.append((x, -z, y))  # panda (x, y fwd, z up) -> cv
    return out


# Offsets in the look-at frame, CV convention (x right, y down, z forward).
_OFFSETS = {
    "TCO": [],
    "front_1view": [(0.0, 0.0, 0.0)],
    "front_3views": [(0.0, 0.0, 0.0), (1.0, 0.0, 0.0), (-1.0, 0.0, 0.0)],
    "front_5views": [
        (0.0, 0.0, 0.0), (1.0, 0.0, 0.0), (-1.0, 0.0, 0.0),
        (0.0, -1.0, 0.0), (0.0, 1.0, 0.0),
    ],
    "sphere_26views": _sphere_26_offsets(),
}


def look_at_R(eye: torch.Tensor, target: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """Rotation [..., 3, 3] of a camera at `eye` looking at `target`; its
    columns are the camera axes in the parent frame (z toward the target,
    y roughly opposite `up`)."""
    f = target - eye
    f = f / torch.clamp(torch.linalg.vector_norm(f, dim=-1, keepdim=True), min=1e-9)
    x = torch.linalg.cross(f, up)
    xn = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    # degenerate (looking along up): fall back to a fixed right axis
    fallback = device_constant((1.0, 0.0, 0.0), f.dtype, f.device)
    x = torch.where(xn > 1e-6, x / torch.clamp(xn, min=1e-9), fallback.expand_as(f))
    y = torch.linalg.cross(f, x)
    return torch.stack([x, y, f], dim=-1)


def make_TCO_multiview(
    TCO: torch.Tensor,
    tCR: torch.Tensor,
    multiview_type: str = "front_3views",
    remove_TCO_rendering: bool = False,
    views_inplane_rotations: bool = False,
) -> torch.Tensor:
    """Object poses in every rendered view's camera frame.

    TCO: [B, 4, 4]; tCR: [B, 3] reference point in camera-0 frame. The
    extra views of `multiview_type` are prefixed by the TCO view itself
    unless `remove_TCO_rendering`; `views_inplane_rotations` adds the
    {90, 180, 270} degree in-plane rotations of every view (x4 views).
    Returns TCV_O [B, n_views, 4, 4].
    """
    B = TCO.shape[0]
    dtype, device = TCO.dtype, TCO.device
    up = device_constant((0.0, -1.0, 0.0), dtype, device).expand(B, 3)

    views = []
    if not remove_TCO_rendering or multiview_type == "TCO":
        views.append(torch.eye(4, dtype=dtype, device=device).expand(B, 4, 4))

    offsets = _OFFSETS[multiview_type]
    if offsets:
        radius = torch.linalg.vector_norm(tCR, dim=-1, keepdim=True)  # [B, 1]
        R_c2r = look_at_R(torch.zeros_like(tCR), tCR, up)  # [B, 3, 3]
        for off in offsets:
            off_t = device_constant(tuple(off), dtype, device)
            p_v = torch.einsum("bij,j->bi", R_c2r, off_t) * radius
            views.append(make_T(look_at_R(p_v, tCR, up), p_v))

    TC0_CV = torch.stack(views, dim=1)  # [B, V, 4, 4]
    TCV_O = torch.einsum("bvij,bjk->bvik", invert_transforms(TC0_CV), TCO)

    if views_inplane_rotations:
        rots = [torch.eye(3, dtype=dtype, device=device)]
        for ang in (math.pi / 2, math.pi, 3 * math.pi / 2):
            ca, sa = math.cos(ang), math.sin(ang)
            rots.append(device_constant(
                ((ca, -sa, 0.0), (sa, ca, 0.0), (0.0, 0.0, 1.0)), dtype, device))
        expanded = [
            make_T(
                torch.einsum("ij,bvjk->bvik", Rz, TCV_O[..., :3, :3]),
                TCV_O[..., :3, 3],
            )
            for Rz in rots
        ]
        # order: per view, the 4 in-plane rotations contiguous
        TCV_O = torch.stack(expanded, dim=2).reshape(B, -1, 4, 4)

    return TCV_O
