"""Rotation representations (PyTorch port of `happypose_tpu/lib3d/rotations.py`).

Quaternion convention: ``xyzw`` (scalar last). Batched over leading dims.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _normalize(v: torch.Tensor, eps: float = _EPS) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=eps)


def rotmat_from_ortho6d(poses: torch.Tensor) -> torch.Tensor:
    """Continuous 6D rotation representation [..., 6] -> [..., 3, 3].

    Columns of the result are (x, y, z) built by Gram-Schmidt on the two
    3-vectors of `poses` (Zhou et al., CVPR'19).
    """
    x = _normalize(poses[..., 0:3])
    z = _normalize(torch.linalg.cross(x, poses[..., 3:6]))
    y = torch.linalg.cross(z, x)
    return torch.stack((x, y, z), dim=-1)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (xyzw) [..., 4] -> rotation matrix [..., 3, 3]."""
    q = _normalize(q)
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    r = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return r.reshape(*q.shape[:-1], 3, 3)
