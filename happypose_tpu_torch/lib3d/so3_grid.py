"""Deterministic SO(3) covering grids, host numpy (port of
`happypose_tpu/lib3d/so3_grid.py`).

The shipped `.qua` grids are read by path from the JAX package's data
directory (`happypose_tpu/data/data_{72,512,576,4608}.qua`); that package is
never imported. Other sizes come from the super-Fibonacci spiral (Alexa,
CVPR'22). The "512" file holds 576 rotations, as in the reference.
"""

from __future__ import annotations

from functools import lru_cache
from pathlib import Path

import numpy as np

_DATA_DIR = Path(__file__).resolve().parents[2] / "happypose_tpu" / "data"
_QUA_SIZES = (72, 512, 576, 4608)

_PHI = np.sqrt(2.0)
_PSI = 1.533751168755204288118041  # solution of psi^4 = psi + 4


@lru_cache(maxsize=None)
def super_fibonacci_quats(n: int) -> np.ndarray:
    """n unit quaternions (xyzw) covering SO(3) evenly."""
    s = np.arange(n, dtype=np.float64) + 0.5
    t = s / n
    d = 2 * np.pi * s
    r = np.sqrt(t)
    R = np.sqrt(1.0 - t)
    alpha = d / _PHI
    beta = d / _PSI
    w = r * np.sin(alpha)
    x = r * np.cos(alpha)
    y = R * np.sin(beta)
    z = R * np.cos(beta)
    return np.stack([x, y, z, w], axis=-1).astype(np.float32)


def quats_to_rotmats(q: np.ndarray) -> np.ndarray:
    """xyzw quaternions [N, 4] -> rotation matrices [N, 3, 3]."""
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    R = np.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        axis=-1,
    ).reshape(*q.shape[:-1], 3, 3)
    return R.astype(np.float32)


@lru_cache(maxsize=None)
def load_qua_grid(resolution: int) -> np.ndarray:
    """xyzw quaternions [N, 4] from a shipped `.qua` file (x y z w per line)."""
    path = _DATA_DIR / f"data_{resolution}.qua"
    q = np.loadtxt(path, dtype=np.float64)
    if q.ndim != 2 or q.shape[1] != 4:
        raise ValueError(f"bad .qua file: {path}")
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


@lru_cache(maxsize=None)
def load_SO3_quats(resolution: int = 576, source: str = "auto") -> np.ndarray:
    """xyzw quaternion grid [N, 4]. `source`: "auto" (the shipped `.qua`
    grid when one exists for `resolution`, else generated), "qua" (the file
    must exist) or "super_fibonacci" (any size)."""
    if source == "auto":
        source = "qua" if resolution in _QUA_SIZES else "super_fibonacci"
    if source == "qua":
        return load_qua_grid(resolution)
    if source == "super_fibonacci":
        return super_fibonacci_quats(resolution)
    raise ValueError(f"unknown SO(3) grid source: {source}")


def load_SO3_grid(resolution: int = 576, source: str = "auto") -> np.ndarray:
    """Rotation-matrix grid [N, 3, 3]; see `load_SO3_quats`."""
    return quats_to_rotmats(load_SO3_quats(resolution, source))


def covering_radius(grid_q: np.ndarray, n_probes: int = 4096, seed: int = 0) -> float:
    """Monte-Carlo covering radius (radians): the largest geodesic distance
    from `n_probes` random rotations to their nearest grid rotation."""
    rs = np.random.RandomState(seed)
    p = rs.randn(n_probes, 4)
    p /= np.linalg.norm(p, axis=-1, keepdims=True)
    g = grid_q / np.linalg.norm(grid_q, axis=-1, keepdims=True)
    # geodesic distance = 2 arccos |<q1, q2>|
    best = np.clip(np.abs(p @ g.T).max(axis=1), -1.0, 1.0)
    return float(np.max(2.0 * np.arccos(best)))
