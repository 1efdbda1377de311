"""COLMAP sparse-model text IO: cameras, images and points3D (the port's
own copy of `happypose_tpu/utils/colmap_io.py`, numpy only).

The data model is COLMAP's: Camera(id, model, width, height, params),
Image(id, qvec wxyz, tvec, camera_id, name, xys, point3D_ids), Point3D(id,
xyz, rgb, error, image_ids, point2D_idxs); files are the text format, and
`write_model` writes the bytes the JAX package writes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Union

import numpy as np


@dataclass
class Camera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray  # model-dependent (e.g. PINHOLE: fx fy cx cy)


@dataclass
class Image:
    id: int
    qvec: np.ndarray  # (w, x, y, z) world-to-camera rotation
    tvec: np.ndarray  # world-to-camera translation
    camera_id: int
    name: str
    xys: np.ndarray = field(default_factory=lambda: np.zeros((0, 2)))
    point3D_ids: np.ndarray = field(default_factory=lambda: np.zeros(0, int))

    def TCW(self) -> np.ndarray:
        """world-to-camera homogeneous matrix."""
        w, x, y, z = self.qvec
        R = np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
            ]
        )
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = self.tvec
        return T


@dataclass
class Point3D:
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float = 0.0
    image_ids: np.ndarray = field(default_factory=lambda: np.zeros(0, int))
    point2D_idxs: np.ndarray = field(default_factory=lambda: np.zeros(0, int))


def read_model(path: Union[str, Path]):
    """Read a COLMAP text model dir -> (cameras, images, points3D) dicts."""
    path = Path(path)
    cameras: Dict[int, Camera] = {}
    for line in _data_lines(path / "cameras.txt"):
        parts = line.split()
        cameras[int(parts[0])] = Camera(
            id=int(parts[0]), model=parts[1], width=int(parts[2]),
            height=int(parts[3]),
            params=np.asarray([float(p) for p in parts[4:]]),
        )
    images: Dict[int, Image] = {}
    lines = _data_lines(path / "images.txt")
    for i in range(0, len(lines), 2):
        parts = lines[i].split()
        xys, pids = np.zeros((0, 2)), np.zeros(0, int)
        if i + 1 < len(lines) and lines[i + 1].strip():
            vals = lines[i + 1].split()
            trip = np.asarray(vals, dtype=float).reshape(-1, 3)
            xys = trip[:, :2]
            pids = trip[:, 2].astype(int)
        images[int(parts[0])] = Image(
            id=int(parts[0]),
            qvec=np.asarray([float(p) for p in parts[1:5]]),
            tvec=np.asarray([float(p) for p in parts[5:8]]),
            camera_id=int(parts[8]),
            name=parts[9],
            xys=xys,
            point3D_ids=pids,
        )
    points: Dict[int, Point3D] = {}
    p3d_path = path / "points3D.txt"
    if p3d_path.exists():
        for line in _data_lines(p3d_path):
            parts = line.split()
            track = np.asarray(parts[8:], dtype=float).reshape(-1, 2)
            points[int(parts[0])] = Point3D(
                id=int(parts[0]),
                xyz=np.asarray([float(p) for p in parts[1:4]]),
                rgb=np.asarray([int(p) for p in parts[4:7]]),
                error=float(parts[7]),
                image_ids=track[:, 0].astype(int),
                point2D_idxs=track[:, 1].astype(int),
            )
    return cameras, images, points


def write_model(
    cameras: Dict[int, Camera],
    images: Dict[int, Image],
    points3D: Dict[int, Point3D],
    path: Union[str, Path],
) -> None:
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    with open(path / "cameras.txt", "w") as f:
        f.write("# Camera list: CAMERA_ID MODEL WIDTH HEIGHT PARAMS[]\n")
        for c in cameras.values():
            params = " ".join(f"{p:.12g}" for p in c.params)
            f.write(f"{c.id} {c.model} {c.width} {c.height} {params}\n")
    with open(path / "images.txt", "w") as f:
        f.write("# Image list: IMAGE_ID QW QX QY QZ TX TY TZ CAMERA_ID NAME\n")
        for im in images.values():
            q = " ".join(f"{v:.12g}" for v in im.qvec)
            t = " ".join(f"{v:.12g}" for v in im.tvec)
            f.write(f"{im.id} {q} {t} {im.camera_id} {im.name}\n")
            track = " ".join(
                f"{xy[0]:.6g} {xy[1]:.6g} {pid}"
                for xy, pid in zip(im.xys, im.point3D_ids)
            )
            f.write(track + "\n")
    with open(path / "points3D.txt", "w") as f:
        f.write("# 3D point list: POINT3D_ID X Y Z R G B ERROR TRACK[]\n")
        for p in points3D.values():
            xyz = " ".join(f"{v:.12g}" for v in p.xyz)
            rgb = " ".join(str(int(v)) for v in p.rgb)
            track = " ".join(
                f"{int(i)} {int(j)}"
                for i, j in zip(p.image_ids, p.point2D_idxs)
            )
            f.write(f"{p.id} {xyz} {rgb} {p.error:.12g} {track}\n".rstrip() + "\n")


def _data_lines(path: Path) -> List[str]:
    out = []
    for line in Path(path).read_text().splitlines():
        if line.startswith("#"):
            continue
        out.append(line)
    # images.txt alternates data/obs lines; keep empty obs lines
    while out and not out[-1].strip():
        out.pop()
    return out
