"""Mesh file IO and procedural meshes, numpy only (the port's own copy of
`happypose_tpu/meshes/io.py`): the `Mesh` type, PLY (ascii and binary, both
byte orders) and OBJ loaders, the PLY writer, vertex-clustering decimation,
procedural textures and debug meshes.

A native decoder (`happypose_tpu_torch/csrc/fastply.cpp`) reads binary PLYs
without texture coordinates; the Python parser here reads everything else.
Texture images are PNG files read and written by `utils/png.py`; a texture
that a model names and that cannot be read raises.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Optional, Union

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

    def scaled(self, scale: float) -> "Mesh":
        return Mesh(
            vertices=(self.vertices * scale).astype(np.float32),
            faces=self.faces,
            vertex_colors=self.vertex_colors,
            vertex_normals_=self.vertex_normals_,
            vertex_uv=self.vertex_uv,
            texture=self.texture,
        )

    def with_baked_texture(self) -> "Mesh":
        """Bake the texture into per-vertex colors (lossy; the renderer's UV
        path keeps full detail)."""
        if self.texture is None or self.vertex_uv is None:
            return self
        colors = self.sample_texture_at_uv(self.vertex_uv)
        return Mesh(
            vertices=self.vertices, faces=self.faces, vertex_colors=colors,
            vertex_normals_=self.vertex_normals_, vertex_uv=self.vertex_uv,
            texture=None,
        )

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


_PLY_DTYPES: Dict[str, str] = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


_UV_PROP_NAMES = (("texture_u", "texture_v"), ("s", "t"), ("u", "v"))


def _load_texture_image(path: Path) -> np.ndarray:
    """Load a texture image as [TH, TW, 3] float32 in [0, 1] (row 0 = top).

    A PNG goes through the port's own codec; any other format needs PIL at
    this spot. A file that cannot be read raises: a model never loses its
    texture silently."""
    if path.suffix.lower() == ".png":
        from happypose_tpu_torch.utils.png import read_png

        img = read_png(path)
        if img.dtype != np.uint8:
            raise ValueError(f"16-bit texture image: {path}")
        if img.ndim == 2:
            img = np.stack([img] * 3, axis=-1)
        return img[..., :3].astype(np.float32) / 255.0
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0


def load_ply(path: Union[str, Path], native: bool = True) -> Mesh:
    """Parse ascii or binary-little/big-endian PLY.

    Supports vertex colors, vertex normals (nx/ny/nz), texture coordinates
    (texture_u/texture_v, or s/t, or u/v — the BOP textured-model
    convention), and the `comment TextureFile <name>` texture reference
    (loaded from the same directory when present; unreadable raises).

    Tries the native C++ decoder first (`csrc/fastply.cpp`) when no texture
    coordinates are present, and this Python parser (`native=False`, or a
    file the decoder does not support, or no `g++`) otherwise. The native
    decoder returns no normals, so such a mesh recomputes them."""
    path = Path(path)
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"ply"):
        raise ValueError(f"not a PLY file: {path}")
    header_end = data.find(b"end_header")
    if header_end < 0:
        raise ValueError("PLY missing end_header")
    header = data[:header_end].decode("ascii", errors="replace").splitlines()
    body_start = data.find(b"\n", header_end) + 1

    fmt = None
    texture_file = None
    elements = []  # list of (name, count, [(prop_name, dtype)|('list', count_dt, item_dt, name)])
    cur = None
    for line in header:
        tok = line.strip().split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "comment" and len(tok) >= 3 and tok[1] == "TextureFile":
            texture_file = tok[2]
        elif tok[0] == "element":
            cur = {"name": tok[1], "count": int(tok[2]), "props": []}
            elements.append(cur)
        elif tok[0] == "property" and cur is not None:
            if tok[1] == "list":
                cur["props"].append(("list", _PLY_DTYPES[tok[2]], _PLY_DTYPES[tok[3]], tok[4]))
            else:
                cur["props"].append((tok[2], _PLY_DTYPES[tok[1]]))

    vertex_names = [
        p[0] for el in elements if el["name"] == "vertex" for p in el["props"]
    ]
    uv_names = next(
        (pair for pair in _UV_PROP_NAMES
         if all(n in vertex_names for n in pair)),
        None,
    )
    has_normals = all(n in vertex_names for n in ("nx", "ny", "nz"))

    # Native fast path whenever no texture coordinates are present —
    # shipped normals are cheap to recompute (Mesh.vertex_normals), so
    # nx/ny/nz alone must not force the slow Python parse (BOP models all
    # carry normals).
    if uv_names is None and native:
        from happypose_tpu_torch.csrc.fastply import load_ply_native

        decoded = load_ply_native(path)
        if decoded is not None:
            colors = None
            if decoded["colors"] is not None:
                colors = decoded["colors"].astype(np.float32) / 255.0
            return Mesh(
                vertices=decoded["vertices"],
                faces=decoded["faces"],
                vertex_colors=colors,
            )

    verts = faces = colors = uv = normals = None

    def extract_vertex_fields(get):
        """Shared vertex-property extraction; `get(name) -> column`."""
        nonlocal verts, colors, uv, normals
        verts = np.stack([get("x"), get("y"), get("z")], -1).astype(np.float32)
        if all(c in vertex_names for c in ("red", "green", "blue")):
            colors = np.stack(
                [get("red"), get("green"), get("blue")], -1
            ).astype(np.float32) / 255.0
        if uv_names is not None:
            uv = np.stack([get(uv_names[0]), get(uv_names[1])], -1).astype(
                np.float32
            )
        if has_normals:
            normals = np.stack(
                [get("nx"), get("ny"), get("nz")], -1
            ).astype(np.float32)

    if fmt == "ascii":
        text = data[body_start:].decode("ascii", errors="replace").split("\n")
        li = 0
        for el in elements:
            rows = []
            for _ in range(el["count"]):
                while not text[li].strip():
                    li += 1
                rows.append(text[li].strip().split())
                li += 1
            if el["name"] == "vertex":
                names = [p[0] for p in el["props"]]
                arr = np.array(rows, dtype=np.float64)
                extract_vertex_fields(lambda c: arr[:, names.index(c)])
            elif el["name"] == "face":
                faces = np.array([r[1:4] for r in rows], dtype=np.int32)
    else:
        endian = "<" if "little" in fmt else ">"
        off = body_start
        for el in elements:
            has_list = any(p[0] == "list" for p in el["props"])
            if not has_list:
                dt = np.dtype([(p[0], endian + p[1]) for p in el["props"]])
                arr = np.frombuffer(data, dtype=dt, count=el["count"], offset=off)
                off += dt.itemsize * el["count"]
                if el["name"] == "vertex":
                    extract_vertex_fields(lambda c: arr[c])
            else:
                # faces: parse row by row (counts may vary; triangulate fans)
                rows = []
                for _ in range(el["count"]):
                    row_vals = []
                    for p in el["props"]:
                        if p[0] == "list":
                            cnt_dt = np.dtype(endian + p[1])
                            n = int(np.frombuffer(data, cnt_dt, 1, off)[0])
                            off += cnt_dt.itemsize
                            item_dt = np.dtype(endian + p[2])
                            vals = np.frombuffer(data, item_dt, n, off)
                            off += item_dt.itemsize * n
                            row_vals.append(vals)
                        else:
                            dt = np.dtype(endian + p[1])
                            row_vals.append(np.frombuffer(data, dt, 1, off)[0])
                            off += dt.itemsize
                    rows.append(row_vals)
                if el["name"] == "face":
                    tri = []
                    for row in rows:
                        idxs = row[0]
                        for k in range(1, len(idxs) - 1):
                            tri.append((idxs[0], idxs[k], idxs[k + 1]))
                    faces = np.array(tri, dtype=np.int32)
    if verts is None:
        raise ValueError(f"PLY has no vertex element: {path}")
    if faces is None:
        faces = np.zeros((0, 3), np.int32)
    texture = None
    if texture_file is not None and uv is not None:
        tex_path = path.parent / texture_file
        if tex_path.is_file():
            texture = _load_texture_image(tex_path)
    return Mesh(
        vertices=verts, faces=faces, vertex_colors=colors,
        vertex_normals_=normals, vertex_uv=uv, texture=texture,
    )


def _parse_mtl_map_kd(mtl_path: Path) -> Optional[Path]:
    """First `map_Kd` texture path of an .mtl file (relative to it)."""
    try:
        with open(mtl_path) as f:
            for line in f:
                tok = line.split()
                if tok and tok[0] == "map_Kd":
                    return mtl_path.parent / tok[-1]
    except OSError:
        pass
    return None


def load_obj(path: Union[str, Path]) -> Mesh:
    """OBJ loader: v / vt / f (fan-triangulated) + mtllib map_Kd textures.

    OBJ indexes positions and UVs independently per face corner; vertices
    are split on unique (v, vt) pairs so the mesh carries one UV per vertex
    (what the rasterizer's padded tensors need). Parity: the reference
    loads GSO/ShapeNet OBJs through trimesh/panda3d
    (toolbox/renderer/panda3d_scene_renderer.py:206-219)."""
    path = Path(path)
    positions, uvs, corners = [], [], []  # corners: (vi, ti) per triangle corner
    mtl_texture: Optional[Path] = None
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            if tok[0] == "v":
                positions.append([float(x) for x in tok[1:4]])
            elif tok[0] == "vt":
                uvs.append([float(tok[1]), float(tok[2]) if len(tok) > 2 else 0.0])
            elif tok[0] == "mtllib" and mtl_texture is None:
                mtl_texture = _parse_mtl_map_kd(path.parent / tok[-1])
            elif tok[0] == "f":
                idx = []
                for t in tok[1:]:
                    parts = t.split("/")
                    vi = int(parts[0])
                    vi = vi - 1 if vi > 0 else len(positions) + vi
                    ti = -1
                    if len(parts) > 1 and parts[1]:
                        ti = int(parts[1])
                        ti = ti - 1 if ti > 0 else len(uvs) + ti
                    idx.append((vi, ti))
                for k in range(1, len(idx) - 1):
                    corners.append((idx[0], idx[k], idx[k + 1]))

    positions = np.asarray(positions, np.float32).reshape(-1, 3)
    if not corners:
        return Mesh(vertices=positions, faces=np.zeros((0, 3), np.int32))

    has_uv = bool(uvs) and any(
        ti >= 0 for tri in corners for (_, ti) in tri
    )
    if not has_uv:
        faces = np.asarray(
            [[vi for (vi, _) in tri] for tri in corners], np.int32
        )
        return Mesh(vertices=positions, faces=faces)

    # split vertices on unique (position, uv) pairs
    uvs_arr = np.asarray(uvs, np.float32).reshape(-1, 2)
    pair_to_new: Dict[tuple, int] = {}
    new_pos, new_uv, faces = [], [], []
    for tri in corners:
        face = []
        for (vi, ti) in tri:
            key = (vi, ti)
            j = pair_to_new.get(key)
            if j is None:
                j = len(new_pos)
                pair_to_new[key] = j
                new_pos.append(positions[vi])
                new_uv.append(uvs_arr[ti] if ti >= 0 else np.zeros(2, np.float32))
            face.append(j)
        faces.append(face)

    texture = None
    if mtl_texture is not None and mtl_texture.is_file():
        texture = _load_texture_image(mtl_texture)
    return Mesh(
        vertices=np.asarray(new_pos, np.float32),
        faces=np.asarray(faces, np.int32),
        vertex_uv=np.asarray(new_uv, np.float32),
        texture=texture,
    )


def save_ply(path: Union[str, Path], mesh: Mesh) -> None:
    """Write binary little-endian PLY (with colors if present).

    Textured meshes (vertex_uv + texture) are written in the BOP
    `TextureFile` convention that `load_ply` reads back: texture_u/
    texture_v vertex properties + a `comment TextureFile <name>` header,
    with the texture image saved as a PNG next to the PLY. This keeps
    full texture detail through a write/load round trip — baking to
    vertex colors (the old behavior for BOP model export) is lossy at
    exactly the surface-detail frequencies render-and-compare rotation
    learning depends on."""
    path = Path(path)
    v, f = mesh.vertices, mesh.faces
    has_c = mesh.vertex_colors is not None
    has_uv = mesh.vertex_uv is not None and mesh.texture is not None
    tex_name = None
    if has_uv:
        tex_name = path.stem + ".png"
        from happypose_tpu_torch.utils.png import write_png

        # Mesh.texture row 0 is the TOP of the image (load side flips)
        t8 = np.clip(mesh.texture * 255.0, 0, 255).astype(np.uint8)
        write_png(path.parent / tex_name, t8)
    with open(path, "wb") as fh:
        hdr = ["ply", "format binary_little_endian 1.0"]
        if has_uv:
            hdr += [f"comment TextureFile {tex_name}"]
        hdr += [f"element vertex {len(v)}",
                "property float x", "property float y", "property float z"]
        if has_c:
            hdr += ["property uchar red", "property uchar green", "property uchar blue"]
        if has_uv:
            hdr += ["property float texture_u", "property float texture_v"]
        hdr += [f"element face {len(f)}",
                "property list uchar int vertex_indices", "end_header", ""]
        fh.write("\n".join(hdr).encode())
        fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
        if has_c:
            fields += [("r", "u1"), ("g", "u1"), ("b", "u1")]
        if has_uv:
            fields += [("tu", "<f4"), ("tv", "<f4")]
        if len(fields) == 3:
            arr = v.astype("<f4")
        else:
            arr = np.empty(len(v), dtype=np.dtype(fields))
            arr["x"], arr["y"], arr["z"] = v[:, 0], v[:, 1], v[:, 2]
            if has_c:
                c8 = np.clip(
                    mesh.vertex_colors * 255.0, 0, 255
                ).astype(np.uint8)
                arr["r"], arr["g"], arr["b"] = c8[:, 0], c8[:, 1], c8[:, 2]
            if has_uv:
                arr["tu"] = mesh.vertex_uv[:, 0]
                arr["tv"] = mesh.vertex_uv[:, 1]
        fh.write(arr.tobytes())
        fdt = np.dtype([("n", "u1"), ("a", "<i4"), ("b", "<i4"), ("c", "<i4")])
        farr = np.empty(len(f), dtype=fdt)
        farr["n"] = 3
        farr["a"], farr["b"], farr["c"] = f[:, 0], f[:, 1], f[:, 2]
        fh.write(farr.tobytes())


def load_mesh(path: Union[str, Path]) -> Mesh:
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix == ".ply":
        return load_ply(path)
    if suffix == ".obj":
        return load_obj(path)
    raise ValueError(f"unsupported mesh format: {path}")


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


def make_procedural_texture(size: int = 256, seed: int = 0) -> np.ndarray:
    """Deterministic multi-octave value-noise texture [size, size, 3].

    Gives synthetic meshes the high-frequency surface detail that
    render-and-compare needs to observe rotation (uniform colors make
    rotation unobservable). A coarse checker overlay adds hard edges."""
    rs = np.random.RandomState(seed)
    tex = np.zeros((size, size, 3), np.float32)
    weight = 1.0
    total = 0.0
    for scale in (4, 8, 16, 32, 64):
        g = rs.rand(scale, scale, 3).astype(np.float32)
        yi = np.linspace(0, scale - 1, size)
        xi = np.linspace(0, scale - 1, size)
        y0 = np.floor(yi).astype(np.int64)
        x0 = np.floor(xi).astype(np.int64)
        y1 = np.minimum(y0 + 1, scale - 1)
        x1 = np.minimum(x0 + 1, scale - 1)
        fy = (yi - y0)[:, None, None]
        fx = (xi - x0)[None, :, None]
        up = (
            g[y0][:, x0] * (1 - fy) * (1 - fx)
            + g[y0][:, x1] * (1 - fy) * fx
            + g[y1][:, x0] * fy * (1 - fx)
            + g[y1][:, x1] * fy * fx
        )
        tex += weight * up
        total += weight
        weight *= 0.55
    tex /= total
    # contrast stretch + hard-edged checker overlay
    tex = np.clip((tex - 0.5) * 1.8 + 0.5, 0.0, 1.0)
    ii, jj = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    checker = (((ii // (size // 8)) + (jj // (size // 8))) % 2).astype(
        np.float32
    )[..., None]
    return np.clip(0.8 * tex + 0.2 * checker, 0.0, 1.0).astype(np.float32)


def _texture_noise(size: int, rs: np.random.RandomState) -> np.ndarray:
    return make_procedural_texture(size, seed=int(rs.randint(2**31)))


def _texture_checker(size: int, rs: np.random.RandomState) -> np.ndarray:
    n = int(rs.choice([4, 6, 8, 12, 16]))
    c0 = rs.uniform(0.05, 0.95, 3).astype(np.float32)
    c1 = rs.uniform(0.05, 0.95, 3).astype(np.float32)
    ii, jj = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    m = (((ii * n) // size + (jj * n) // size) % 2).astype(np.float32)
    return (m[..., None] * c1 + (1 - m[..., None]) * c0).astype(np.float32)


def _texture_stripes(size: int, rs: np.random.RandomState) -> np.ndarray:
    n = int(rs.choice([3, 5, 8, 13]))
    ang = rs.uniform(0, np.pi)
    c0 = rs.uniform(0.05, 0.95, 3).astype(np.float32)
    c1 = rs.uniform(0.05, 0.95, 3).astype(np.float32)
    ii, jj = np.meshgrid(
        np.linspace(0, 1, size), np.linspace(0, 1, size), indexing="ij"
    )
    t = ii * np.cos(ang) + jj * np.sin(ang)
    m = ((t * 2 * n).astype(np.int64) % 2).astype(np.float32)
    return (m[..., None] * c1 + (1 - m[..., None]) * c0).astype(np.float32)


def _texture_cells(size: int, rs: np.random.RandomState) -> np.ndarray:
    """Voronoi-style random color cells (hard edges at random angles)."""
    k = int(rs.choice([6, 10, 16, 24]))
    pts = rs.uniform(0, 1, (k, 2)).astype(np.float32)
    cols = rs.uniform(0.05, 0.95, (k, 3)).astype(np.float32)
    ii, jj = np.meshgrid(
        np.linspace(0, 1, size), np.linspace(0, 1, size), indexing="ij"
    )
    # toroidal distance so the texture tiles seamlessly over closed UVs
    dy = np.abs(ii[..., None] - pts[:, 0])
    dx = np.abs(jj[..., None] - pts[:, 1])
    dy = np.minimum(dy, 1 - dy)
    dx = np.minimum(dx, 1 - dx)
    idx = np.argmin(dy * dy + dx * dx, axis=-1)
    return cols[idx]


def _texture_speckle(size: int, rs: np.random.RandomState) -> np.ndarray:
    base = rs.uniform(0.1, 0.9, 3).astype(np.float32)
    tex = np.tile(base, (size, size, 1))
    n_dots = int(rs.randint(40, 160))
    r = max(1, size // 48)
    for _ in range(n_dots):
        cy, cx = rs.randint(0, size, 2)
        col = rs.uniform(0.0, 1.0, 3).astype(np.float32)
        y0, y1 = max(0, cy - r), min(size, cy + r + 1)
        x0, x1 = max(0, cx - r), min(size, cx + r + 1)
        tex[y0:y1, x0:x1] = col
    return tex


TEXTURE_FAMILIES = {
    "noise": _texture_noise,
    "checker": _texture_checker,
    "stripes": _texture_stripes,
    "cells": _texture_cells,
    "speckle": _texture_speckle,
}


def make_random_texture(
    rs: np.random.RandomState, size: int = 128, family: str = None
) -> np.ndarray:
    """One texture drawn from the procedural texture library.

    The reference's domain randomization samples from a ShapeNet texture
    dataset (bop_recording_scene.py:54,92-100 `make_texture_dataset`); we
    synthesize from 5 procedural families instead (no asset downloads) and
    randomize family/colors/frequency per draw."""
    if family is None:
        family = list(TEXTURE_FAMILIES)[int(rs.randint(len(TEXTURE_FAMILIES)))]
    tex = TEXTURE_FAMILIES[family](size, rs)
    # random per-channel gain + brightness for extra variety
    gain = rs.uniform(0.6, 1.0, (1, 1, 3)).astype(np.float32)
    off = rs.uniform(-0.1, 0.1)
    return np.clip(tex * gain + off, 0.0, 1.0).astype(np.float32)


def decimate_mesh(mesh: Mesh, target_faces: int) -> Mesh:
    """Vertex-clustering decimation to <= target_faces (approximately).

    Vertices snap to a uniform voxel grid and merge per cell (cluster
    representative = the cell's first vertex, so colors/UVs/normals carry
    over); degenerate faces drop out. The grid resolution is bisected
    until the face budget holds. The rasterizer's per-tile face lists grow
    with the face count, so a dense model is cut before it is rendered.
    """
    if len(mesh.faces) <= target_faces:
        return mesh
    v = mesh.vertices
    lo, hi = v.min(0), v.max(0)
    extent = float(np.max(hi - lo))
    n_cells_hi = 256

    def cluster(n_cells: int):
        cell = extent / n_cells
        keys = np.floor((v - lo) / max(cell, 1e-12)).astype(np.int64)
        key1d = (keys[:, 0] * (n_cells + 2) + keys[:, 1]) * (n_cells + 2) + keys[:, 2]
        uniq, remap = np.unique(key1d, return_inverse=True)
        # representative vertex per cluster: first occurrence
        first = np.full(len(uniq), -1, np.int64)
        seen_order = np.argsort(remap, kind="stable")
        first_idx = np.searchsorted(remap[seen_order], np.arange(len(uniq)))
        first = seen_order[first_idx]
        f = remap[mesh.faces]
        keep = (
            (f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2]) & (f[:, 0] != f[:, 2])
        )
        return first, f[keep]

    n_cells = n_cells_hi
    first, faces = cluster(n_cells)
    while len(faces) > target_faces and n_cells > 4:
        n_cells //= 2
        first, faces = cluster(n_cells)

    def take(a):
        return None if a is None else a[first]

    return Mesh(
        vertices=v[first],
        faces=faces.astype(np.int32),
        vertex_colors=take(mesh.vertex_colors),
        vertex_normals_=take(mesh.vertex_normals_),
        vertex_uv=take(mesh.vertex_uv),
        texture=mesh.texture,
    )


def position_colored(mesh: Mesh) -> Mesh:
    """Color vertices by normalized position (r,g,b <- x,y,z).

    Texture-free meshes make rotation unobservable to render-and-compare
    models (a uniform sphere looks identical under any rotation); this
    deterministic coloring breaks the symmetry for synthetic training."""
    v = mesh.vertices
    lo, hi = v.min(0), v.max(0)
    c = (v - lo) / np.maximum(hi - lo, 1e-9)
    return Mesh(vertices=v, faces=mesh.faces,
                vertex_colors=c.astype(np.float32))


def make_cylinder_mesh(
    radius=0.02, length=0.1, n_seg=16, color=(0.6, 0.6, 0.6)
) -> Mesh:
    """Capped cylinder along +z, base at origin (procedural viz asset,
    parity: renderer/geometry.py cylinder/capsule builders)."""
    ang = np.linspace(0, 2 * np.pi, n_seg, endpoint=False)
    ring = np.stack([np.cos(ang) * radius, np.sin(ang) * radius], -1)
    bot = np.concatenate([ring, np.zeros((n_seg, 1))], -1)
    top = np.concatenate([ring, np.full((n_seg, 1), length)], -1)
    centers = np.asarray([[0, 0, 0], [0, 0, length]], np.float32)
    v = np.concatenate([bot, top, centers]).astype(np.float32)
    cb, ct = 2 * n_seg, 2 * n_seg + 1
    faces = []
    for i in range(n_seg):
        j = (i + 1) % n_seg
        faces += [[i, j, n_seg + i], [j, n_seg + j, n_seg + i]]  # side
        faces += [[cb, j, i], [ct, n_seg + i, n_seg + j]]  # caps
    colors = np.tile(np.asarray([color], np.float32), (len(v), 1))
    return Mesh(vertices=v, faces=np.asarray(faces, np.int32),
                vertex_colors=colors)


def make_capsule_mesh(
    radius=0.02, length=0.1, n_seg=16, n_cap=4, color=(0.6, 0.3, 0.6)
) -> Mesh:
    """Capsule along +z (cylinder + hemispherical ends)."""
    rows = []
    # bottom hemisphere (pole to equator), cylinder, top hemisphere
    for t in np.linspace(-np.pi / 2, 0, n_cap + 1):
        rows.append((radius * np.cos(t), radius * np.sin(t)))
    for t in np.linspace(0, np.pi / 2, n_cap + 1):
        rows.append((radius * np.cos(t), length + radius * np.sin(t)))
    ang = np.linspace(0, 2 * np.pi, n_seg, endpoint=False)
    verts, faces = [], []
    for r, z in rows:
        verts.append(
            np.stack([np.cos(ang) * r, np.sin(ang) * r,
                      np.full(n_seg, z)], -1)
        )
    V = np.concatenate(verts).astype(np.float32)
    n_rows = len(rows)
    for k in range(n_rows - 1):
        for i in range(n_seg):
            j = (i + 1) % n_seg
            a, b = k * n_seg + i, k * n_seg + j
            c, d = (k + 1) * n_seg + i, (k + 1) * n_seg + j
            faces += [[a, b, c], [b, d, c]]
    colors = np.tile(np.asarray([color], np.float32), (len(V), 1))
    return Mesh(vertices=V, faces=np.asarray(faces, np.int32),
                vertex_colors=colors)


def make_axes_mesh(length=0.1, radius_frac=0.06) -> Mesh:
    """RGB xyz axis triad (the reference's viz axes node,
    renderer/geometry.py:make_axes)."""
    r = length * radius_frac
    parts = []
    rots = {
        # +z cylinder rotated onto each axis
        "x": np.asarray([[0, 0, 1], [0, 1, 0], [-1, 0, 0]], np.float32),
        "y": np.asarray([[1, 0, 0], [0, 0, 1], [0, -1, 0]], np.float32),
        "z": np.eye(3, dtype=np.float32),
    }
    colors = {"x": (0.9, 0.1, 0.1), "y": (0.1, 0.8, 0.1),
              "z": (0.15, 0.3, 0.9)}
    vs, fs, cs, off = [], [], [], 0
    for axis, R in rots.items():
        cyl = make_cylinder_mesh(r, length, color=colors[axis])
        vs.append(cyl.vertices @ R.T)
        fs.append(cyl.faces + off)
        cs.append(cyl.vertex_colors)
        off += len(cyl.vertices)
    return Mesh(vertices=np.concatenate(vs).astype(np.float32),
                faces=np.concatenate(fs).astype(np.int32),
                vertex_colors=np.concatenate(cs).astype(np.float32))
