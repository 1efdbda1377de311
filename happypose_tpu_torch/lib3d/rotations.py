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


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> unit quaternion (xyzw), w >= 0.

    Builds the four candidates (from the largest of w, x, y, z) and selects
    the numerically best one per element, the first on ties.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    # four squared-magnitude candidates (4 * q_i^2)
    qw2 = 1.0 + m00 + m11 + m22
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22
    best = torch.stack([qw2, qx2, qy2, qz2], dim=-1).argmax(dim=-1)

    def half_root(q2):
        c = 0.5 * torch.sqrt(torch.clamp(q2, min=_EPS))
        return c, 0.25 / c

    w, s = half_root(qw2)
    from_w = torch.stack([(m21 - m12) * s, (m02 - m20) * s, (m10 - m01) * s, w], -1)
    x, s = half_root(qx2)
    from_x = torch.stack([x, (m01 + m10) * s, (m02 + m20) * s, (m21 - m12) * s], -1)
    y, s = half_root(qy2)
    from_y = torch.stack([(m01 + m10) * s, y, (m12 + m21) * s, (m02 - m20) * s], -1)
    z, s = half_root(qz2)
    from_z = torch.stack([(m02 + m20) * s, (m12 + m21) * s, z, (m10 - m01) * s], -1)

    q_all = torch.stack([from_w, from_x, from_y, from_z], dim=-2)  # [..., 4, 4]
    q = torch.gather(q_all, -2, best[..., None, None].expand(*best.shape, 1, 4))[..., 0, :]
    q = torch.where(q[..., 3:4] < 0, -q, q)
    return _normalize(q)


def axis_angle_to_rotmat(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] -> rotation matrix [..., 3, 3] (Rodrigues; the
    first-order form I + [aa]_x where theta^2 < 1e-12)."""
    theta2 = (aa * aa).sum(dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta2, min=0.0))
    small = theta2[..., 0] < 1e-12

    k = aa / torch.clamp(theta, min=_EPS)
    kx, ky, kz = k.unbind(-1)
    zero = torch.zeros_like(kx)
    Kmat = torch.stack(
        [zero, -kz, ky, kz, zero, -kx, -ky, kx, zero], dim=-1
    ).reshape(*aa.shape[:-1], 3, 3)
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device)
    st = torch.sin(theta)[..., None]
    ct = torch.cos(theta)[..., None]
    R_full = eye + st * Kmat + (1.0 - ct) * (Kmat @ Kmat)

    ax, ay, az = aa.unbind(-1)
    one = torch.ones_like(ax)
    R_taylor = torch.stack(
        [one, -az, ay, az, one, -ax, -ay, ax, one], dim=-1
    ).reshape(*aa.shape[:-1], 3, 3)
    return torch.where(small[..., None, None], R_taylor, R_full)


def euler_to_rotmat(euler_xyz: torch.Tensor) -> torch.Tensor:
    """Static-axis XYZ euler angles (radians) [..., 3] -> [..., 3, 3], the
    'sxyz' convention: R = Rz(c) @ Ry(b) @ Rx(a)."""
    a, b, c = euler_xyz.unbind(-1)
    ca, sa = torch.cos(a), torch.sin(a)
    cb, sb = torch.cos(b), torch.sin(b)
    cc, sc = torch.cos(c), torch.sin(c)
    R = torch.stack(
        [
            cb * cc, sa * sb * cc - ca * sc, ca * sb * cc + sa * sc,
            cb * sc, sa * sb * sc + ca * cc, ca * sb * sc - sa * cc,
            -sb, sa * cb, ca * cb,
        ],
        dim=-1,
    )
    return R.reshape(*euler_xyz.shape[:-1], 3, 3)


def geodesic_distance(R1: torch.Tensor, R2: torch.Tensor) -> torch.Tensor:
    """Angular distance (radians) between rotation matrices [..., 3, 3]."""
    Rrel = R1.transpose(-1, -2) @ R2
    tr = Rrel[..., 0, 0] + Rrel[..., 1, 1] + Rrel[..., 2, 2]
    return torch.acos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0))


def log_SO3(R: torch.Tensor) -> torch.Tensor:
    """Matrix log of a rotation [..., 3, 3] -> axis-angle [..., 3]."""
    eye = torch.eye(3, dtype=R.dtype, device=R.device).expand(R.shape)
    theta = geodesic_distance(eye, R)
    w = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    scale = torch.where(
        theta < 1e-6,
        torch.full_like(theta, 0.5),
        theta / torch.clamp(2.0 * torch.sin(theta), min=_EPS),
    )
    return w * scale[..., None]


def log_SE3_norm(T1: torch.Tensor, T2: torch.Tensor) -> torch.Tensor:
    """|| log6(T1^-1 T2) ||: the pose-difference magnitude [...]."""
    R1, t1 = T1[..., :3, :3], T1[..., :3, 3]
    R2, t2 = T2[..., :3, :3], T2[..., :3, 3]
    R1t = R1.transpose(-1, -2)
    trel = (R1t @ (t2 - t1)[..., None])[..., 0]
    w = log_SO3(R1t @ R2)
    return torch.sqrt((w * w).sum(dim=-1) + (trel * trel).sum(dim=-1))
