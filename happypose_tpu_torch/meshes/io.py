"""The `Mesh` type and procedural meshes, numpy only (port of the matching
parts of `happypose_tpu/meshes/io.py`; the PLY/OBJ loaders are not ported
yet)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class Mesh:
    """A triangle mesh with optional vertex colors (float RGB in [0, 1]),
    per-vertex UVs, and a texture image.

    Texture convention: `vertex_uv` in [0, 1] with v=0 at the image BOTTOM
    (OBJ/OpenGL); `texture` is [TH, TW, 3] float32 in [0, 1] with row 0 at
    the image TOP — samplers flip v.
    """

    vertices: np.ndarray  # [V, 3] float32
    faces: np.ndarray  # [F, 3] int32
    vertex_colors: Optional[np.ndarray] = None  # [V, 3] float32 in [0,1]
    vertex_normals_: Optional[np.ndarray] = field(default=None, repr=False)
    vertex_uv: Optional[np.ndarray] = None  # [V, 2] float32
    texture: Optional[np.ndarray] = None  # [TH, TW, 3] float32 in [0,1]

    @property
    def diameter(self) -> float:
        """Max pairwise vertex distance (exact up to 2048 vertices, else over
        the 26-direction extremal points)."""
        v = self.vertices
        if len(v) > 2048:
            dirs = np.array(
                [(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1)
                 for k in (-1, 0, 1) if (i, j, k) != (0, 0, 0)],
                dtype=np.float32,
            )
            v = v[np.unique(np.argmax(v @ dirs.T, axis=0))]
        d2 = ((v[:, None, :] - v[None, :, :]) ** 2).sum(-1)
        return float(np.sqrt(d2.max()))

    @property
    def vertex_normals(self) -> np.ndarray:
        """Area-weighted vertex normals [V, 3]."""
        if self.vertex_normals_ is None:
            v, f = self.vertices, self.faces
            fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
            vn = np.zeros_like(v)
            for k in range(3):
                np.add.at(vn, f[:, k], fn)
            norm = np.linalg.norm(vn, axis=-1, keepdims=True)
            self.vertex_normals_ = (vn / np.maximum(norm, 1e-12)).astype(np.float32)
        return self.vertex_normals_

    @property
    def aabb(self) -> np.ndarray:
        """8 corner points of the axis-aligned bounding box, [8, 3]."""
        lo = self.vertices.min(0)
        hi = self.vertices.max(0)
        return np.array(
            [[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
             for z in (lo[2], hi[2])],
            dtype=np.float32,
        )

    def sample_texture_at_uv(self, uv: np.ndarray) -> np.ndarray:
        """Bilinear texture lookup at [N, 2] uv coords -> [N, 3] RGB."""
        th, tw = self.texture.shape[:2]

        def wrap(x):  # GL_REPEAT semantics; exact 1.0 stays
            return np.where(x == 1.0, 1.0, x - np.floor(x))

        u = wrap(uv[:, 0]) * (tw - 1)
        v = (1.0 - wrap(uv[:, 1])) * (th - 1)  # v-flip
        x0 = np.floor(u).astype(np.int64)
        y0 = np.floor(v).astype(np.int64)
        x1 = np.minimum(x0 + 1, tw - 1)
        y1 = np.minimum(y0 + 1, th - 1)
        fx = (u - x0)[:, None]
        fy = (v - y0)[:, None]
        t = self.texture
        return (
            t[y0, x0] * (1 - fx) * (1 - fy)
            + t[y0, x1] * fx * (1 - fy)
            + t[y1, x0] * (1 - fx) * fy
            + t[y1, x1] * fx * fy
        ).astype(np.float32)


def make_box_mesh(half_extents=(0.05, 0.05, 0.05)) -> Mesh:
    """Axis-aligned box; test/debug asset."""
    hx, hy, hz = half_extents
    v = np.array(
        [[sx * hx, sy * hy, sz * hz]
         for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
        np.float32,
    )
    # 12 triangles, outward-facing (CCW seen from outside)
    f = np.array(
        [
            [0, 1, 3], [0, 3, 2],  # -x
            [4, 6, 7], [4, 7, 5],  # +x
            [0, 4, 5], [0, 5, 1],  # -y
            [2, 3, 7], [2, 7, 6],  # +y
            [0, 2, 6], [0, 6, 4],  # -z
            [1, 5, 7], [1, 7, 3],  # +z
        ],
        np.int32,
    )
    colors = np.tile(np.array([[0.7, 0.2, 0.2]], np.float32), (8, 1))
    return Mesh(vertices=v, faces=f, vertex_colors=colors)


def make_uv_sphere(
    radius=0.05, n_lat=16, n_lon=24, color=(0.2, 0.6, 0.3), with_uv=False
) -> Mesh:
    """UV sphere; test/debug asset. `with_uv` adds spherical-coordinate
    texture coordinates (u = longitude, v = 1 - latitude)."""
    i = np.arange(n_lat + 1)[:, None]
    j = np.arange(n_lon)[None, :]
    theta = np.pi * i / n_lat
    phi = 2 * np.pi * j / n_lon
    v = np.stack(
        np.broadcast_arrays(
            radius * np.sin(theta) * np.cos(phi),
            radius * np.sin(theta) * np.sin(phi),
            radius * np.cos(theta),
        ),
        axis=-1,
    ).reshape(-1, 3).astype(np.float32)
    uv = np.stack(
        np.broadcast_arrays(j / n_lon, 1.0 - i / n_lat), axis=-1
    ).reshape(-1, 2)
    i, j = i[:-1], j
    a = i * n_lon + j
    b = i * n_lon + (j + 1) % n_lon
    c = (i + 1) * n_lon + j
    d = (i + 1) * n_lon + (j + 1) % n_lon
    faces = np.stack(
        [np.stack([a, c, b], -1), np.stack([b, c, d], -1)], axis=2
    ).reshape(-1, 3)
    return Mesh(
        vertices=v,
        faces=faces.astype(np.int32),
        vertex_colors=np.tile(np.asarray([color], np.float32), (len(v), 1)),
        vertex_uv=uv.astype(np.float32) if with_uv else None,
    )
