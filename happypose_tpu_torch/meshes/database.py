"""Padded mesh database — fixed-shape tensors (PyTorch port of
`happypose_tpu/meshes/database.py`).

Ragged meshes are padded to [n_obj, P, 3] / [n_obj, S, 4, 4] /
[n_obj, F, 3] tensors with validity masks, so per-label lookups are plain index selects on the device.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from happypose_tpu_torch.meshes.io import Mesh


_RESIZE_BITS = 22  # fixed-point bits of an 8-bit resampling coefficient


def _triangle_coeffs(in_size: int, out_size: int):
    """Taps of a triangle (bilinear) filter for resampling `in_size` samples
    to `out_size`: first input index [out], integer weights [out, taps]
    scaled by 2**22. The support widens by the scale when shrinking;
    sample centres sit at half pixels; each row of weights is normalized
    before it is rounded."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale
    taps = int(np.ceil(support)) * 2 + 1
    centre = (np.arange(out_size) + 0.5) * scale
    lo = np.maximum(np.trunc(centre - support + 0.5).astype(np.int64), 0)
    hi = np.minimum(np.trunc(centre + support + 0.5).astype(np.int64), in_size)
    x = lo[:, None] + np.arange(taps)[None, :]
    w = 1.0 - np.abs((x - centre[:, None] + 0.5) / filterscale)
    w = np.where((x < hi[:, None]) & (w > 0.0), w, 0.0)
    total = w.sum(1, keepdims=True)
    w = np.where(total != 0.0, w / np.where(total != 0.0, total, 1.0), w)
    return lo, np.trunc(w * (1 << _RESIZE_BITS) + 0.5).astype(np.int64)


def _resample_axis0(img: np.ndarray, out_size: int) -> np.ndarray:
    """Resample a uint8 array along its first axis, rounding to 8 bits."""
    lo, w = _triangle_coeffs(img.shape[0], out_size)
    idx = np.minimum(lo[:, None] + np.arange(w.shape[1])[None, :], img.shape[0] - 1)
    acc = np.full((out_size,) + img.shape[1:], 1 << (_RESIZE_BITS - 1), np.int64)
    wide = img.astype(np.int64)
    for t in range(w.shape[1]):
        acc += wide[idx[:, t]] * w[:, t].reshape((-1,) + (1,) * (img.ndim - 1))
    return np.clip(acc >> _RESIZE_BITS, 0, 255).astype(np.uint8)


def _resize_texture(tex: np.ndarray, size: int) -> np.ndarray:
    """Resample a [TH, TW, 3] float texture to [size, size, 3] with a
    triangle filter on 8-bit values: columns first, then rows, each pass
    rounded to 8 bits (what an 8-bit bilinear image resize computes, and
    what the JAX package gets from its round trip through `uint8`)."""
    th, tw = tex.shape[:2]
    if (th, tw) == (size, size):
        return tex.astype(np.float32)
    img = np.clip(tex * 255.0, 0, 255).astype(np.uint8)
    if tw != size:
        img = _resample_axis0(img.transpose(1, 0, 2), size).transpose(1, 0, 2)
    if th != size:
        img = _resample_axis0(img, size)
    return img.astype(np.float32) / 255.0


def _to(obj, device):
    """Copy of a tensor dataclass with every field moved to `device`."""
    return dataclasses.replace(
        obj, **{f.name: getattr(obj, f.name).to(device)
                for f in dataclasses.fields(obj)}
    )


@dataclass
class BatchedMeshes:
    """Fixed-shape per-object point sets and symmetries, selectable by
    object id.

    points: [n_obj, P, 3]; points_mask: [n_obj, P] bool (False on padding);
    symmetries: [n_obj, S, 4, 4], identity-padded; symmetries_mask:
    [n_obj, S] bool; diameters: [n_obj].
    """

    points: torch.Tensor
    points_mask: torch.Tensor
    symmetries: torch.Tensor
    symmetries_mask: torch.Tensor
    diameters: torch.Tensor

    @property
    def n_sym_max(self) -> int:
        return self.symmetries.shape[1]

    def select(self, obj_ids: torch.Tensor) -> "BatchedMeshes":
        return BatchedMeshes(
            points=self.points[obj_ids],
            points_mask=self.points_mask[obj_ids],
            symmetries=self.symmetries[obj_ids],
            symmetries_mask=self.symmetries_mask[obj_ids],
            diameters=self.diameters[obj_ids],
        )

    def to(self, device) -> "BatchedMeshes":
        return _to(self, device)


@dataclass
class RenderAssets:
    """Padded triangle soup for the rasterizer.

    vertices [n_obj, V, 3]; faces [n_obj, F, 3] int64 (0-padded);
    faces_mask [n_obj, F] bool; vertex_colors / vertex_normals [n_obj, V, 3];
    vertex_uv [n_obj, V, 2]; textures [n_obj, T, T, 3] (1x1 when no object
    is textured); has_texture [n_obj] bool.
    """

    vertices: torch.Tensor
    faces: torch.Tensor
    faces_mask: torch.Tensor
    vertex_colors: torch.Tensor
    vertex_normals: torch.Tensor
    vertex_uv: torch.Tensor
    textures: torch.Tensor
    has_texture: torch.Tensor

    def select(self, obj_ids: torch.Tensor) -> "RenderAssets":
        # textures are not gathered per instance (that would materialize
        # [B, T, T, 3]); the renderer samples them with the object id
        return RenderAssets(
            vertices=self.vertices[obj_ids],
            faces=self.faces[obj_ids],
            faces_mask=self.faces_mask[obj_ids],
            vertex_colors=self.vertex_colors[obj_ids],
            vertex_normals=self.vertex_normals[obj_ids],
            vertex_uv=self.vertex_uv[obj_ids],
            textures=self.textures,
            has_texture=self.has_texture[obj_ids],
        )

    def to(self, device) -> "RenderAssets":
        return _to(self, device)


class MeshDataBase:
    """Host-side registry of meshes and their symmetries ((S, 4, 4) arrays,
    e.g. from `lib3d.symmetries.make_symmetries_poses`) keyed by string
    label, compiled into fixed-shape tensors. Padding is deterministic
    (points are cycled)."""

    def __init__(
        self,
        meshes: Dict[str, Mesh],
        symmetries: Optional[Dict[str, np.ndarray]] = None,
        scales: Optional[Dict[str, float]] = None,
    ):
        self.labels: List[str] = sorted(meshes.keys())
        self.label_to_id: Dict[str, int] = {l: i for i, l in enumerate(self.labels)}
        self.meshes = meshes
        self.symmetries = symmetries or {}
        self.scales = scales or {}

    def id_of(self, label: str) -> int:
        return self.label_to_id[label]

    def ids_of(self, labels: Sequence[str]) -> np.ndarray:
        return np.asarray([self.label_to_id[l] for l in labels], np.int64)

    def batched(
        self,
        n_points: int = 2000,
        n_sym: Optional[int] = None,
        aabb: bool = False,
        device="cuda",
    ) -> BatchedMeshes:
        """Padded point and symmetry database: `n_points` vertices per
        object, evenly subsampled, or cycled when the mesh has fewer (with
        `aabb`, the 8 corners of its bounding box instead); `n_sym`
        symmetry slots (default: the largest count over the objects, at
        least 1), the identity in the unused ones."""
        n_obj = len(self.labels)
        if aabb:
            n_points = 8
        if n_sym is None:
            n_sym = max([len(s) for s in self.symmetries.values()] + [1])
        points = np.zeros((n_obj, n_points, 3), np.float32)
        points_mask = np.zeros((n_obj, n_points), bool)
        syms = np.tile(np.eye(4, dtype=np.float32), (n_obj, n_sym, 1, 1))
        syms_mask = np.zeros((n_obj, n_sym), bool)
        syms_mask[:, 0] = True
        diameters = np.zeros((n_obj,), np.float32)
        for i, label in enumerate(self.labels):
            mesh = self.meshes[label]
            scale = self.scales.get(label, 1.0)
            v = mesh.vertices * scale
            if aabb:
                pts = mesh.aabb * scale
            elif len(v) >= n_points:
                idx = np.linspace(0, len(v) - 1, n_points).astype(np.int64)
                pts = v[idx]
            else:
                reps = int(np.ceil(n_points / max(len(v), 1)))
                pts = np.tile(v, (reps, 1))[:n_points]
            points[i, : len(pts)] = pts
            points_mask[i, : len(pts)] = True
            diameters[i] = mesh.diameter * scale
            S = self.symmetries.get(label)
            if S is not None and len(S) > 0:
                S = np.asarray(S, np.float32)[:n_sym]
                syms[i, : len(S)] = S
                syms_mask[i, : len(S)] = True
        return BatchedMeshes(
            points=torch.from_numpy(points),
            points_mask=torch.from_numpy(points_mask),
            symmetries=torch.from_numpy(syms),
            symmetries_mask=torch.from_numpy(syms_mask),
            diameters=torch.from_numpy(diameters),
        ).to(device)

    def render_assets(
        self,
        n_vertices: Optional[int] = None,
        n_faces: Optional[int] = None,
        texture_size: int = 256,
        bake_textures: bool = False,
        device="cuda",
    ) -> RenderAssets:
        """Padded triangle-soup tensors for the rasterizer.

        Padding faces are degenerate (all indices 0) and masked. Textured
        meshes get their images resampled to a common `texture_size` square
        and are sampled through perspective-correct UVs by the renderer;
        `bake_textures` instead folds each texture into per-vertex colours
        (`Mesh.with_baked_texture`: cheaper, detail limited by the vertices).
        """
        n_obj = len(self.labels)
        if n_vertices is None:
            n_vertices = max(len(self.meshes[l].vertices) for l in self.labels)
        if n_faces is None:
            n_faces = max(len(self.meshes[l].faces) for l in self.labels)
        meshes = {
            l: self.meshes[l].with_baked_texture() if bake_textures else self.meshes[l]
            for l in self.labels
        }
        any_texture = any(
            m.texture is not None and m.vertex_uv is not None
            for m in meshes.values()
        )
        T = texture_size if any_texture else 1

        V = np.zeros((n_obj, n_vertices, 3), np.float32)
        F = np.zeros((n_obj, n_faces, 3), np.int64)
        Fm = np.zeros((n_obj, n_faces), bool)
        C = np.full((n_obj, n_vertices, 3), 0.5, np.float32)
        N = np.zeros((n_obj, n_vertices, 3), np.float32)
        UV = np.zeros((n_obj, n_vertices, 2), np.float32)
        TEX = np.full((n_obj, T, T, 3), 0.5, np.float32)
        HT = np.zeros((n_obj,), bool)

        for i, label in enumerate(self.labels):
            mesh = meshes[label]
            scale = self.scales.get(label, 1.0)
            nv, nf = len(mesh.vertices), len(mesh.faces)
            if nv > n_vertices or nf > n_faces:
                raise ValueError(
                    f"mesh {label} exceeds padding budget ({nv}>{n_vertices} "
                    f"or {nf}>{n_faces})"
                )
            V[i, :nv] = mesh.vertices * scale
            F[i, :nf] = mesh.faces
            Fm[i, :nf] = True
            if mesh.vertex_colors is not None:
                C[i, :nv] = mesh.vertex_colors
            N[i, :nv] = mesh.vertex_normals
            if mesh.texture is not None and mesh.vertex_uv is not None:
                # raw UVs: tiled coordinates wrap at sample time (GL_REPEAT)
                UV[i, :nv] = mesh.vertex_uv
                TEX[i] = _resize_texture(mesh.texture, T)
                HT[i] = True
                C[i, :nv] = mesh.sample_texture_at_uv(mesh.vertex_uv)

        return RenderAssets(
            vertices=torch.from_numpy(V),
            faces=torch.from_numpy(F),
            faces_mask=torch.from_numpy(Fm),
            vertex_colors=torch.from_numpy(C),
            vertex_normals=torch.from_numpy(N),
            vertex_uv=torch.from_numpy(UV),
            textures=torch.from_numpy(TEX),
            has_texture=torch.from_numpy(HT),
        ).to(device)
