"""What a run makes from its seed, handed alike to the program and to the
reference: the object database (numpy), the networks' weights (on the
device, from a `torch.Generator` there, in one draw a kind) and the
frames' images (on the device, then copied to the host once).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from benchmark.reference.raster import Meshes


def sphere_topology(n_lat: int, n_lon: int):
    """Faces [2 n_lon (n_lat - 1), 3] of a UV sphere with a pole vertex at
    each end and a duplicated seam column, the unit directions and the uv
    of its vertices."""
    theta = np.linspace(0.0, np.pi, n_lat + 1)[1:-1]
    phi = np.linspace(0.0, 2 * np.pi, n_lon + 1)
    th, ph = np.meshgrid(theta, phi, indexing="ij")  # [n_lat-1, n_lon+1]
    dirs = np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph), np.cos(th)], -1)
    dirs = np.concatenate([[[0.0, 0.0, 1.0]], dirs.reshape(-1, 3), [[0.0, 0.0, -1.0]]])
    uv = np.stack([ph / (2 * np.pi), 1.0 - th / np.pi], -1).reshape(-1, 2)
    uv = np.concatenate([[[0.5, 1.0]], uv, [[0.5, 0.0]]])
    cols = n_lon + 1

    def vid(i, j):
        return 1 + i * cols + j

    faces = [(0, vid(0, j + 1), vid(0, j)) for j in range(n_lon)]
    for i in range(n_lat - 2):
        for j in range(n_lon):
            a, b, c, d = vid(i, j), vid(i, j + 1), vid(i + 1, j), vid(i + 1, j + 1)
            faces += [(a, b, d), (a, d, c)]
    last = len(dirs) - 1
    faces += [(last, vid(n_lat - 2, j), vid(n_lat - 2, j + 1)) for j in range(n_lon)]
    return np.asarray(faces, np.int64), dirs.astype(np.float32), uv.astype(np.float32)


def _smooth_noise(rng: np.random.Generator, size: int, cells: int, channels: int):
    """[size, size, channels] in [0, 1]: a `cells`-square grid of uniform
    values, bilinearly upsampled, plus a little pixel noise."""
    g = rng.random((cells + 1, cells + 1, channels))
    x = np.linspace(0.0, cells, size)
    i = np.minimum(x.astype(np.int64), cells - 1)
    f = (x - i)[:, None, None]
    rows = g[i] * (1 - f) + g[i + 1] * f
    f = (x - i)[None, :, None]
    img = rows[:, i] * (1 - f) + rows[:, i + 1] * f
    return np.clip(img + 0.05 * rng.standard_normal(img.shape), 0.0, 1.0).astype(np.float32)


def make_objects(rng: np.random.Generator, spec: Dict) -> Dict[str, np.ndarray]:
    """`spec["count"]` closed, textured, star-shaped objects of one topology
    (`n_lat` x `n_lon` UV sphere): a radius of a few seeded low harmonics,
    stretched to a diameter in `diameter_m`; area-weighted normals; a
    seeded smooth texture of `texture_size`."""
    faces, dirs, uv = sphere_topology(spec["n_lat"], spec["n_lon"])
    n, T = spec["count"], spec["texture_size"]
    lo, hi = spec["diameter_m"]
    th = np.arccos(np.clip(dirs[:, 2], -1, 1))
    ph = np.arctan2(dirs[:, 1], dirs[:, 0])
    V, N, TEX = [], [], []
    for _ in range(n):
        amp = rng.uniform(-0.15, 0.15, size=4)
        fr = rng.integers(1, 4, size=4)
        r = 1.0 + amp[0] * np.cos(fr[0] * th) + amp[1] * np.sin(fr[1] * ph) * np.sin(th) \
            + amp[2] * np.cos(fr[2] * ph + fr[3] * th) * np.sin(th) + amp[3] * np.cos(2 * th)
        axes = rng.uniform(0.5, 1.0, size=3)
        v = dirs * r[:, None] * axes
        v *= rng.uniform(lo, hi) / (2 * np.abs(v).max())
        v = v.astype(np.float32)
        fn = np.cross(v[faces[:, 1]] - v[faces[:, 0]], v[faces[:, 2]] - v[faces[:, 0]])
        vn = np.zeros_like(v)
        for k in range(3):
            np.add.at(vn, faces[:, k], fn)
        vn /= np.maximum(np.linalg.norm(vn, axis=-1, keepdims=True), 1e-12)
        V.append(v)
        N.append(vn.astype(np.float32))
        TEX.append(_smooth_noise(rng, T, 8, 3))
    return {"vertices": np.stack(V), "faces": np.broadcast_to(faces, (n,) + faces.shape).copy(),
            "normals": np.stack(N), "uv": np.broadcast_to(uv, (n,) + uv.shape).copy(),
            "textures": np.stack(TEX)}


def reference_meshes(objects: Dict[str, np.ndarray], device) -> Meshes:
    return Meshes(*(torch.from_numpy(objects[k]).to(device)
                    for k in ("vertices", "faces", "normals", "uv", "textures")))


def model_points(objects: Dict[str, np.ndarray], n_points: int, device):
    """Points [n, P, 3] and mask an object for crops and inits: `n_points`
    vertices evenly picked, or the vertices cycled when there are fewer."""
    out = []
    for v in objects["vertices"]:
        if len(v) >= n_points:
            out.append(v[np.linspace(0, len(v) - 1, n_points).astype(np.int64)])
        else:
            out.append(np.tile(v, (int(math.ceil(n_points / len(v))), 1))[:n_points])
    pts = torch.from_numpy(np.stack(out)).to(device)
    return pts, torch.ones(pts.shape[:2], dtype=torch.bool, device=device)


def program_database(objects: Dict[str, np.ndarray]):
    """The objects as the program's `MeshDataBase` (labels sort as ids)."""
    from happypose_tpu_torch.meshes.database import MeshDataBase
    from happypose_tpu_torch.meshes.io import Mesh

    meshes = {
        f"obj_{i:03d}": Mesh(vertices=objects["vertices"][i],
                             faces=objects["faces"][i].astype(np.int32),
                             vertex_normals_=objects["normals"][i],
                             vertex_uv=objects["uv"][i], texture=objects["textures"][i])
        for i in range(len(objects["vertices"]))}
    return MeshDataBase(meshes=meshes)


def make_weights(table, generator: torch.Generator, device, head: Dict) -> Dict[str, torch.Tensor]:
    """Seeded weights of a parameter table: LeCun-normal convolutions and
    linear layers, batch norms near the identity with running statistics
    drawn around (0, 1), the pose head at `pose_head_scale` of LeCun around
    its identity update, a classifier's bias at `cls_prior`. Two draws on
    the device for the whole table."""
    n_normal = sum(math.prod(s) for _, s, k in table if k != "count")
    z = torch.randn(n_normal, generator=generator, device=device)
    u = torch.rand(n_normal, generator=generator, device=device)
    out, at = {}, 0
    for name, shape, kind in table:
        if kind == "count":
            out[name] = torch.zeros(shape, dtype=torch.int64, device=device)
            continue
        n = math.prod(shape)
        zi, ui = z[at:at + n].view(shape), u[at:at + n].view(shape)
        at += n
        fan_in = math.prod(shape[1:]) if len(shape) > 1 else 1
        if kind in ("conv", "linear"):
            w = zi / math.sqrt(fan_in)
        elif kind == "pose_head":
            w = zi * (head["pose_head_scale"] / math.sqrt(fan_in))
        elif kind == "pose_bias":
            w = torch.tensor(head["identity_update"], device=device)
        elif kind == "zero":
            w = torch.zeros(shape, device=device)
        elif kind == "cls_prior":
            w = torch.full(shape, head["cls_prior"], device=device)
        elif kind == "bn_weight":
            w = 1.0 + 0.1 * zi
        elif kind in ("bn_bias", "bn_mean"):
            w = 0.1 * zi
        elif kind == "bn_var":
            w = 0.5 + ui
        else:
            raise ValueError(f"unknown parameter kind {kind!r}")
        out[name] = w.contiguous()
    return out


def make_images(generator: torch.Generator, n: int, size, device) -> np.ndarray:
    """[n, H, W, 3] float32 host images: uniform colours at 1/8 of the size,
    upsampled bilinearly, with pixel noise; made on the device, copied to
    the host once."""
    H, W = size
    low = torch.rand(n, 3, max(1, H // 8), max(1, W // 8), generator=generator, device=device)
    img = torch.nn.functional.interpolate(low, size=(H, W), mode="bilinear", align_corners=False)
    img = img + 0.03 * torch.randn(img.shape, generator=generator, device=device)
    return img.clamp(0.0, 1.0).permute(0, 2, 3, 1).contiguous().cpu().numpy()


def device_generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed % (1 << 63))
