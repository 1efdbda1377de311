"""Object symmetry enumeration on the host (numpy), the port's own copy of
`happypose_tpu/lib3d/symmetries.py`. BOP convention: the product of the
discrete symmetries with sampled rotations about the continuous axes; the
identity always comes first. `MeshDataBase(symmetries=...)` pads the result
into device tensors.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class DiscreteSymmetry:
    """pose: (4, 4) homogeneous matrix (BOP models_info convention)."""

    pose: np.ndarray


@dataclass
class ContinuousSymmetry:
    """Continuous rotational symmetry about `axis` through `offset`."""

    offset: np.ndarray = field(default_factory=lambda: np.zeros(3))
    axis: np.ndarray = field(default_factory=lambda: np.array([0, 0, 1.0]))


def _euler_to_R(euler_xyz: np.ndarray) -> np.ndarray:
    a, b, c = euler_xyz
    ca, sa, cb, sb, cc, sc = np.cos(a), np.sin(a), np.cos(b), np.sin(b), np.cos(c), np.sin(c)
    return np.array(
        [
            [cb * cc, sa * sb * cc - ca * sc, ca * sb * cc + sa * sc],
            [cb * sc, sa * sb * sc + ca * cc, ca * sb * sc - sa * cc],
            [-sb, sa * cb, ca * cb],
        ]
    )


def make_symmetries_poses(
    symmetries_discrete: Optional[List[DiscreteSymmetry]] = None,
    symmetries_continuous: Optional[List[ContinuousSymmetry]] = None,
    n_symmetries_continuous: int = 8,
    units: str = "mm",
    scale: Optional[float] = None,
) -> np.ndarray:
    """Enumerate symmetry poses: (continuous x discrete) products, identity
    first. Returns (num_symmetries, 4, 4) float64."""
    symmetries_discrete = symmetries_discrete or []
    symmetries_continuous = symmetries_continuous or []
    if scale is None:
        scale = {"m": 1.0, "mm": 0.001}[units]

    all_discrete = [np.eye(4)]
    for sym_d in symmetries_discrete:
        M = np.array(sym_d.pose, dtype=np.float64).copy()
        M[:3, -1] *= scale
        all_discrete.append(M)

    all_continuous = []
    for sym_c in symmetries_continuous:
        axis = np.asarray(sym_c.axis, dtype=np.float64)
        if not np.allclose(sym_c.offset, 0):
            raise ValueError("continuous symmetries with an offset are not supported")
        if axis.sum() != 1:
            raise ValueError(f"a continuous symmetry axis must be a unit axis, got {axis}")
        for n in range(n_symmetries_continuous):
            euler = axis * 2 * np.pi * n / n_symmetries_continuous
            M = np.eye(4)
            M[:3, :3] = _euler_to_R(euler)
            all_continuous.append(M)

    out = []
    for Md in all_discrete:
        if all_continuous:
            out.extend(Mc @ Md for Mc in all_continuous)
        else:
            out.append(Md)
    return np.stack(out, axis=0)
