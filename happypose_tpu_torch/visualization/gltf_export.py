"""3D scene export as self-contained binary glTF (.glb).

Parity target: the reference's meshcat viewer
(happypose/toolbox/visualization/meshcat_visualizer.py:36-120
and meshcat_utils.py), which pushes predicted object meshes at their
estimated poses into a browser 3D viewer over a websocket. Without a
meshcat server the same scene — every
object mesh placed at its predicted camera-frame pose, plus optional camera
frusta — is written as a standard .glb file that any glTF viewer opens.

No external deps: the GLB container (JSON chunk + binary buffer) is emitted
directly.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import List, Optional, Sequence, Union

import numpy as np

_COMPONENT_F32 = 5126
_COMPONENT_U32 = 5125
_TARGET_ARRAY = 34962
_TARGET_ELEMENT = 34963


def _camera_frustum_mesh(scale: float = 0.05):
    """Wireframe-ish frustum as thin triangles (pyramid + image plane)."""
    s = scale
    apex = np.zeros(3, np.float32)
    corners = np.asarray(
        [[-s, -0.75 * s, s], [s, -0.75 * s, s],
         [s, 0.75 * s, s], [-s, 0.75 * s, s]], np.float32
    )
    verts = np.vstack([apex[None], corners])
    faces = np.asarray(
        [[0, 1, 2], [0, 2, 3], [0, 3, 4], [0, 4, 1], [1, 2, 3], [1, 3, 4]],
        np.int32,
    )
    colors = np.tile(
        np.asarray([[0.9, 0.7, 0.1]], np.float32), (len(verts), 1)
    )
    return verts, faces, colors


class GlbSceneWriter:
    """Accumulates mesh instances and writes one .glb."""

    def __init__(self) -> None:
        self._bin = bytearray()
        self._buffer_views: List[dict] = []
        self._accessors: List[dict] = []
        self._meshes: List[dict] = []
        self._nodes: List[dict] = []
        self._mesh_cache: dict = {}

    def _push(self, data: bytes, target: int) -> int:
        # 4-byte alignment
        while len(self._bin) % 4:
            self._bin.append(0)
        offset = len(self._bin)
        self._bin.extend(data)
        self._buffer_views.append(
            {"buffer": 0, "byteOffset": offset, "byteLength": len(data),
             "target": target}
        )
        return len(self._buffer_views) - 1

    def _add_mesh(
        self,
        key,
        vertices: np.ndarray,
        faces: np.ndarray,
        colors: Optional[np.ndarray],
    ) -> int:
        if key in self._mesh_cache:
            return self._mesh_cache[key]
        v = np.ascontiguousarray(vertices, np.float32)
        f = np.ascontiguousarray(faces, np.uint32).reshape(-1)
        pos_view = self._push(v.tobytes(), _TARGET_ARRAY)
        self._accessors.append(
            {"bufferView": pos_view, "componentType": _COMPONENT_F32,
             "count": len(v), "type": "VEC3",
             "min": v.min(axis=0).tolist(), "max": v.max(axis=0).tolist()}
        )
        pos_acc = len(self._accessors) - 1

        attributes = {"POSITION": pos_acc}
        if colors is not None:
            c = np.ascontiguousarray(
                np.clip(colors, 0.0, 1.0), np.float32
            )
            col_view = self._push(c.tobytes(), _TARGET_ARRAY)
            self._accessors.append(
                {"bufferView": col_view, "componentType": _COMPONENT_F32,
                 "count": len(c), "type": "VEC3"}
            )
            attributes["COLOR_0"] = len(self._accessors) - 1

        idx_view = self._push(f.tobytes(), _TARGET_ELEMENT)
        self._accessors.append(
            {"bufferView": idx_view, "componentType": _COMPONENT_U32,
             "count": len(f), "type": "SCALAR"}
        )
        idx_acc = len(self._accessors) - 1

        self._meshes.append(
            {"primitives": [
                {"attributes": attributes, "indices": idx_acc, "mode": 4}
            ]}
        )
        mesh_id = len(self._meshes) - 1
        self._mesh_cache[key] = mesh_id
        return mesh_id

    def add_instance(
        self,
        name: str,
        vertices: np.ndarray,  # [V, 3]
        faces: np.ndarray,  # [F, 3]
        pose: np.ndarray,  # [4, 4] world-from-object (or camera-frame)
        colors: Optional[np.ndarray] = None,  # [V, 3] in [0, 1]
        mesh_key=None,
    ) -> None:
        """Place one mesh instance; identical meshes (same mesh_key) share
        geometry buffers across instances."""
        key = mesh_key if mesh_key is not None else id(vertices)
        mesh_id = self._add_mesh(key, vertices, faces, colors)
        M = np.asarray(pose, np.float64)
        self._nodes.append(
            {"name": name, "mesh": mesh_id,
             # glTF node matrices are column-major
             "matrix": M.T.reshape(-1).tolist()}
        )

    def add_camera(
        self, name: str, TWC: np.ndarray, scale: float = 0.05
    ) -> None:
        """A frustum marker at a camera pose (meshcat draws these for
        multi-view scenes)."""
        v, f, c = _camera_frustum_mesh(scale)
        self.add_instance(name, v, f, TWC, c, mesh_key=("__frustum__", scale))

    def to_bytes(self) -> bytes:
        gltf = {
            "asset": {"version": "2.0", "generator": "happypose_tpu_torch"},
            "scene": 0,
            "scenes": [{"nodes": list(range(len(self._nodes)))}],
            "nodes": self._nodes or [{}],
            "meshes": self._meshes,
            "accessors": self._accessors,
            "bufferViews": self._buffer_views,
            "buffers": [{"byteLength": len(self._bin)}],
        }
        json_bytes = json.dumps(gltf).encode()
        json_bytes += b" " * (-len(json_bytes) % 4)
        bin_bytes = bytes(self._bin)
        bin_bytes += b"\x00" * (-len(bin_bytes) % 4)
        total = 12 + 8 + len(json_bytes) + 8 + len(bin_bytes)
        out = struct.pack("<4sII", b"glTF", 2, total)
        out += struct.pack("<I4s", len(json_bytes), b"JSON") + json_bytes
        out += struct.pack("<I4s", len(bin_bytes), b"BIN\x00") + bin_bytes
        return out

    def save(self, path: Union[str, Path]) -> None:
        Path(path).write_bytes(self.to_bytes())


def export_scene_glb(
    path: Union[str, Path],
    mesh_db,
    labels: Sequence[str],
    poses: np.ndarray,  # [N, 4, 4]
    camera_poses: Optional[np.ndarray] = None,  # [V, 4, 4] TWC
) -> None:
    """One-call scene export: objects from a `MeshDataBase` at predicted
    poses (+ camera frusta). The equivalent of meshcat_visualizer's
    `display_scene`."""
    w = GlbSceneWriter()
    for i, label in enumerate(labels):
        mesh = mesh_db.meshes[label]
        scale = mesh_db.scales.get(label, 1.0)
        colors = mesh.vertex_colors
        if colors is None:
            colors = np.tile(
                np.asarray([[0.5, 0.5, 0.8]], np.float32),
                (len(mesh.vertices), 1),
            )
        w.add_instance(
            f"{label}_{i}", mesh.vertices * scale, mesh.faces,
            np.asarray(poses[i]), colors, mesh_key=label,
        )
    if camera_poses is not None:
        for v, TWC in enumerate(np.asarray(camera_poses)):
            w.add_camera(f"camera_{v}", TWC)
    w.save(path)
