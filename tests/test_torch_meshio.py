"""Mesh files, PNG files and procedural assets: the port against the JAX
package on the same bytes.

Files are written by one side (or by a writer in this file, for the PLY
flavours that neither package writes) and read by both: arrays must be
equal, `save_ply` files byte-equal. The PNG codec of the port
(`utils/png.py`, zlib + struct) is held to PIL both ways for every type it
supports and every row filter. `_resize_texture` (numpy) is held to the
JAX package's, which resizes through PIL. Generators and `decimate_mesh`
are numpy on both sides: equal for the same seed.
"""

import io as _io
import struct
from pathlib import Path
import zlib

import numpy as np
import pytest
from PIL import Image

import happypose_tpu.meshes.io as jio
import happypose_tpu_torch.meshes.io as tio
from happypose_tpu.meshes.database import _resize_texture as jax_resize_texture
from happypose_tpu_torch.csrc import fastply
from happypose_tpu_torch.meshes.database import _resize_texture
from happypose_tpu_torch.utils import png

MESH_FIELDS = ("vertices", "faces", "vertex_colors", "vertex_normals_", "vertex_uv", "texture")


def assert_meshes_equal(a, b, fields=MESH_FIELDS):
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype and x.shape == y.shape, f
            np.testing.assert_array_equal(x, y, err_msg=f)


# ---------------------------------------------------------------- textures

# One 8-bit level: PIL resizes 8-bit images in fixed point (22-bit weights),
# rounding after the horizontal and after the vertical pass; the port does
# the same arithmetic in numpy, so the observed difference is 0 and a single
# level would already mean a different rounding somewhere.
RESIZE_ATOL = 1.0 / 255.0


@pytest.mark.parametrize(
    "shape,size",
    [((64, 64), 256), ((512, 512), 256), ((100, 37), 64), ((37, 300), 128), ((256, 512), 256)],
    ids=["up64to256", "down512to256", "tall100x37", "wide37x300", "one_axis"],
)
def test_resize_texture_matches_jax(shape, size):
    tex = np.random.RandomState(0).rand(*shape, 3).astype(np.float32)
    ours, ref = _resize_texture(tex, size), jax_resize_texture(tex, size)
    assert ours.shape == ref.shape == (size, size, 3) and ours.dtype == np.float32
    assert np.abs(ours - ref).max() <= RESIZE_ATOL
    np.testing.assert_array_equal(ours, ref)  # observed: the same 8-bit levels


def test_resize_texture_has_one_code_path():
    import inspect

    import happypose_tpu_torch.meshes.database as db

    assert "PIL" not in inspect.getsource(db)
    same = np.random.RandomState(1).rand(16, 16, 3).astype(np.float32)
    np.testing.assert_array_equal(_resize_texture(same, 16), same)


# --------------------------------------------------------------------- PNG

PNG_TYPES = {
    "grey8": ((13, 17), np.uint8),
    "rgb8": ((13, 17, 3), np.uint8),
    "rgba8": ((13, 17, 4), np.uint8),
    "grey16": ((13, 17), np.uint16),
}


def _png_image(kind):
    shape, dtype = PNG_TYPES[kind]
    rs = np.random.RandomState(len(kind))
    smooth = np.cumsum(rs.randint(0, 7, shape), axis=1)  # rows that the filters can predict
    return (smooth * (257 if dtype == np.uint16 else 1) % np.iinfo(dtype).max).astype(dtype)


@pytest.mark.parametrize("row_filter", range(5))
@pytest.mark.parametrize("kind", sorted(PNG_TYPES))
def test_png_written_by_the_port(kind, row_filter, tmp_path):
    """Every type with every row filter: PIL and the port read what the port
    wrote, and every row carries the filter asked for."""
    img = _png_image(kind)
    path = tmp_path / "a.png"
    png.write_png(path, img, row_filter=row_filter)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    back = png.read_png(path)
    assert back.dtype == img.dtype
    np.testing.assert_array_equal(back, img)
    buf = path.read_bytes()
    start = buf.index(b"IDAT")
    (length,) = struct.unpack(">I", buf[start - 4:start])
    raw = zlib.decompress(buf[start + 4:start + 4 + length])
    stride = len(raw) // img.shape[0]
    assert set(raw[::stride]) == {row_filter}


@pytest.mark.parametrize("kind", sorted(PNG_TYPES))
def test_png_written_by_pil(kind, tmp_path):
    """PIL chooses a filter per row; the port undoes whichever it finds."""
    img = _png_image(kind)
    big = np.tile(img, (6, 5) + (1,) * (img.ndim - 2))  # enough rows for PIL to mix filters
    path = tmp_path / "b.png"
    Image.fromarray(big).save(path)
    back = png.read_png(path)
    assert back.dtype == big.dtype
    np.testing.assert_array_equal(back, big)


def test_png_mixed_filters_in_one_file():
    """Rows with different filters, Average and Paeth among them."""
    img = _png_image("rgb8")
    rows = []
    for y in range(img.shape[0]):
        buf = png.encode_png(img[: y + 1], row_filter=y % 5)
        start = buf.index(b"IDAT")
        (length,) = struct.unpack(">I", buf[start - 4:start])
        raw = zlib.decompress(buf[start + 4:start + 4 + length])
        stride = len(raw) // (y + 1)
        rows.append(raw[y * stride:(y + 1) * stride])
    H, W = img.shape[:2]
    mixed = (png._SIGNATURE
             + png._chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0))
             + png._chunk(b"IDAT", zlib.compress(b"".join(rows)))
             + png._chunk(b"IEND", b""))
    np.testing.assert_array_equal(png.decode_png(mixed), img)
    np.testing.assert_array_equal(np.asarray(Image.open(_io.BytesIO(mixed))), img)


@pytest.mark.parametrize("what", ["palette", "one_bit", "interlaced", "not_png", "damaged"])
def test_png_unsupported_raises_with_the_file_name(what, tmp_path):
    path = tmp_path / f"{what}.png"
    if what == "palette":
        Image.fromarray(_png_image("rgb8")).convert("P").save(path)
    elif what == "one_bit":
        Image.fromarray(_png_image("grey8") > 40).save(path)
    elif what == "interlaced":
        buf = bytearray(png.encode_png(_png_image("grey8")))
        buf[28] = 1  # the interlace byte of IHDR (its CRC is not checked on read)
        path.write_bytes(bytes(buf))
    elif what == "not_png":
        path.write_bytes(b"GIF89a" + bytes(40))
    else:
        buf = png.encode_png(_png_image("grey8"))
        start = buf.index(b"IDAT")
        path.write_bytes(buf[:start + 8] + b"\x00\x01\x02" + buf[start + 11:])
    with pytest.raises(ValueError, match=path.name):
        png.read_png(path)


def test_png_rejects_other_arrays():
    with pytest.raises(ValueError):
        png.encode_png(np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError):
        png.encode_png(np.zeros((4, 4, 2), np.uint8))


# --------------------------------------------------------------------- PLY

def _sample_mesh(rs, n_vertices=40, n_faces=70):
    return dict(
        vertices=rs.randn(n_vertices, 3).astype(np.float32),
        faces=rs.randint(0, n_vertices, (n_faces, 3)).astype(np.int32),
        colors=rs.randint(0, 256, (n_vertices, 3)).astype(np.uint8),
        normals=rs.randn(n_vertices, 3).astype(np.float32),
        uv=rs.rand(n_vertices, 2).astype(np.float32),
    )


def _write_ply(path, fmt, m, colors=False, normals=False, uv_names=None, texture_file=None,
               quads=False):
    """A PLY writer for the flavours under test: `fmt` ascii | binary_little_endian |
    binary_big_endian; optional uchar colours, float normals, float uv under
    the given property names, a `TextureFile` comment, quad faces."""
    cols = [("x", "f4"), ("y", "f4"), ("z", "f4")]
    data = [m["vertices"][:, i] for i in range(3)]
    if normals:
        cols += [("nx", "f4"), ("ny", "f4"), ("nz", "f4")]
        data += [m["normals"][:, i] for i in range(3)]
    if colors:
        cols += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
        data += [m["colors"][:, i] for i in range(3)]
    if uv_names:
        cols += [(uv_names[0], "f4"), (uv_names[1], "f4")]
        data += [m["uv"][:, 0], m["uv"][:, 1]]
    faces = m["faces"]
    if quads:
        faces = np.concatenate([faces, (faces[:, :1] + 1) % len(m["vertices"])], axis=1)
    ply_type = {"f4": "float", "u1": "uchar"}
    header = ["ply", f"format {fmt} 1.0"]
    if texture_file:
        header.append(f"comment TextureFile {texture_file}")
    header.append(f"element vertex {len(m['vertices'])}")
    header += [f"property {ply_type[t]} {n}" for n, t in cols]
    header += [f"element face {len(faces)}", "property list uchar int vertex_indices",
               "end_header", ""]
    with open(path, "wb") as fh:
        fh.write("\n".join(header).encode())
        if fmt == "ascii":
            for i in range(len(m["vertices"])):
                fh.write((" ".join(repr(float(d[i])) if t == "f4" else str(int(d[i]))
                                   for d, (_, t) in zip(data, cols)) + "\n").encode())
            for f in faces:
                fh.write((f"{len(f)} " + " ".join(str(int(i)) for i in f) + "\n").encode())
        else:
            e = "<" if "little" in fmt else ">"
            arr = np.empty(len(m["vertices"]), np.dtype([(n, e + t if t != "u1" else t)
                                                         for n, t in cols]))
            for d, (n, _) in zip(data, cols):
                arr[n] = d
            fh.write(arr.tobytes())
            k = faces.shape[1]
            farr = np.empty(len(faces), np.dtype([("n", "u1")] + [(f"i{j}", e + "i4")
                                                                 for j in range(k)]))
            farr["n"] = k
            for j in range(k):
                farr[f"i{j}"] = faces[:, j]
            fh.write(farr.tobytes())


PLY_VARIANTS = {
    "plain": {},
    "colors": {"colors": True},
    "normals": {"normals": True},
    "colors_normals": {"colors": True, "normals": True},
    "uv_texture_uv": {"uv_names": ("texture_u", "texture_v")},
    "uv_st": {"uv_names": ("s", "t"), "colors": True},
    "uv_uv": {"uv_names": ("u", "v"), "normals": True},
    "textured": {"uv_names": ("texture_u", "texture_v"), "texture_file": "skin.png"},
    "quads": {"quads": True, "colors": True},
}


@pytest.fixture(scope="module")
def jax_fastply(tmp_path_factory):
    """The JAX package's own `fastply.cpp`, built here with g++ under a
    temporary name and renamed, and bound with the JAX package's ctypes
    signatures. The JAX package builds its decoder in place, next to the
    source: under several test workers one worker can load a file another
    is still writing, and JAX's `load_ply` then reads every binary file of
    that worker with its Python parser (which returns the file's normals,
    where the native path returns none). Tests that compare the two
    packages pin JAX's decoder to this build instead."""
    import ctypes
    import os
    import subprocess

    import happypose_tpu.csrc as jcsrc

    src = Path(jcsrc.__file__).parent / "fastply.cpp"
    out = tmp_path_factory.mktemp("jax_fastply") / "libfastply.so"
    tmp = out.with_suffix(".so.tmp")
    subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(src), "-o", str(tmp)],
                   check=True, capture_output=True, timeout=300)
    os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    lib.fastply_parse.restype = ctypes.c_void_p
    lib.fastply_parse.argtypes = [ctypes.c_char_p]
    lib.fastply_counts.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_long),
                                   ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_int)]
    lib.fastply_copy.argtypes = [ctypes.c_void_p, np.ctypeslib.ndpointer(np.float32),
                                 np.ctypeslib.ndpointer(np.int32), ctypes.c_void_p]
    lib.fastply_free.argtypes = [ctypes.c_void_p]
    return lib


def _pin_jax_decoder(monkeypatch, lib):
    """JAX's `load_ply` uses `lib` for binary files without uv (None: its
    Python parser), whatever another test of this worker built or tried."""
    import happypose_tpu.csrc as jcsrc

    monkeypatch.setattr(jcsrc, "_LIB", lib)
    monkeypatch.setattr(jcsrc, "_TRIED", True)


@pytest.mark.parametrize("variant", sorted(PLY_VARIANTS))
@pytest.mark.parametrize("fmt", ["ascii", "binary_little_endian", "binary_big_endian"])
def test_load_ply_matches_jax(fmt, variant, tmp_path, jax_fastply, monkeypatch):
    """Both packages with their native decoders (JAX's pinned, see
    `jax_fastply`): the same mesh, field by field."""
    _pin_jax_decoder(monkeypatch, jax_fastply)
    rs = np.random.RandomState(3)
    m = _sample_mesh(rs)
    kw = PLY_VARIANTS[variant]
    if kw.get("texture_file"):
        tex = rs.randint(0, 256, (9, 12, 3)).astype(np.uint8)
        Image.fromarray(tex).save(tmp_path / kw["texture_file"])
    path = tmp_path / "m.ply"
    _write_ply(path, fmt, m, **kw)
    ours, ref = tio.load_ply(path), jio.load_ply(path)
    assert_meshes_equal(ours, ref)
    np.testing.assert_array_equal(ours.vertices, m["vertices"])
    if kw.get("texture_file"):
        np.testing.assert_array_equal(ours.texture, tex.astype(np.float32) / 255.0)
    if kw.get("uv_names"):
        np.testing.assert_array_equal(ours.vertex_uv, m["uv"])
    if kw.get("quads"):
        # binary files are fan-triangulated; of an ascii face both packages
        # keep the first three indices only
        assert len(ours.faces) == (1 if fmt == "ascii" else 2) * len(m["faces"])
    # the Python parser of the port alone: the same vertices, faces and colours
    slow = tio.load_ply(path, native=False)
    assert_meshes_equal(slow, ours, ("vertices", "faces", "vertex_colors", "vertex_uv", "texture"))
    if kw.get("normals"):
        np.testing.assert_array_equal(slow.vertex_normals_, m["normals"])


@pytest.mark.parametrize("fmt", ["ascii", "binary_little_endian", "binary_big_endian"])
def test_python_ply_parsers_match_jax(fmt, tmp_path, monkeypatch):
    """JAX's native path pinned off against the port's `load_ply(path,
    native=False)`: the Python parsers alone, normals included."""
    _pin_jax_decoder(monkeypatch, None)
    m = _sample_mesh(np.random.RandomState(5))
    path = tmp_path / "p.ply"
    _write_ply(path, fmt, m, colors=True, normals=True)
    ours, ref = tio.load_ply(path, native=False), jio.load_ply(path)
    assert_meshes_equal(ours, ref)
    np.testing.assert_array_equal(ours.vertex_normals_, m["normals"])


def test_both_ply_parsers_agree_on_a_binary_file(tmp_path):
    """The native decoder (built here with g++) takes a binary little-endian
    file without uv; the Python parser reads the same file: equal vertices,
    faces and colours. The native path returns no normals, as in JAX."""
    assert fastply.get_fastply() is not None, "g++ is present: the build must succeed"
    m = _sample_mesh(np.random.RandomState(4), 300, 500)
    path = tmp_path / "n.ply"
    _write_ply(path, "binary_little_endian", m, colors=True, normals=True)
    decoded = fastply.load_ply_native(path)
    assert decoded is not None, "the native decoder refused a file of its own format"
    fast, slow = tio.load_ply(path), tio.load_ply(path, native=False)
    assert_meshes_equal(fast, slow, ("vertices", "faces", "vertex_colors"))
    np.testing.assert_array_equal(decoded["colors"], m["colors"])
    assert fast.vertex_normals_ is None and slow.vertex_normals_ is not None
    # what it does not support it leaves to the Python parser
    _write_ply(path, "binary_big_endian", m)
    assert fastply.load_ply_native(path) is None
    np.testing.assert_array_equal(tio.load_ply(path).vertices, m["vertices"])


def test_fastply_build_failure_raises(tmp_path, monkeypatch):
    """With g++ present a build that fails raises; without g++ the loader
    falls back to the Python parser."""
    bad = tmp_path / "fastply.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(fastply, "_SRC", bad)
    monkeypatch.setattr(fastply, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        fastply.build()
    monkeypatch.setattr(fastply.shutil, "which", lambda name: None)
    assert fastply.build() is None


def test_unreadable_texture_raises(tmp_path):
    """A texture that the model names and that cannot be read raises in the
    port (the JAX package drops it silently); a texture file that is absent
    leaves the mesh untextured on both sides."""
    m = _sample_mesh(np.random.RandomState(5))
    path = tmp_path / "t.ply"
    _write_ply(path, "binary_little_endian", m, uv_names=("texture_u", "texture_v"),
               texture_file="skin.png")
    assert tio.load_ply(path).texture is None and jio.load_ply(path).texture is None
    (tmp_path / "skin.png").write_bytes(b"\x89PNG\r\n\x1a\n" + bytes(30))
    assert jio.load_ply(path).texture is None
    with pytest.raises(ValueError, match="skin.png"):
        tio.load_ply(path)


def _textured_sphere():
    mesh = tio.make_uv_sphere(radius=0.05, n_lat=8, n_lon=12, with_uv=True)
    mesh.texture = tio.make_procedural_texture(32, seed=2)
    return mesh


@pytest.mark.parametrize("variant", ["plain", "colors", "textured"])
def test_save_ply_is_byte_equal(variant, tmp_path):
    mesh = _textured_sphere()
    if variant == "plain":
        mesh = tio.Mesh(vertices=mesh.vertices, faces=mesh.faces)
    elif variant == "colors":
        mesh = tio.Mesh(vertices=mesh.vertices, faces=mesh.faces, vertex_colors=mesh.vertex_colors)
    jmesh = jio.Mesh(**{f: getattr(mesh, f) for f in MESH_FIELDS})
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    tio.save_ply(tmp_path / "a" / "obj.ply", mesh)
    jio.save_ply(tmp_path / "b" / "obj.ply", jmesh)
    assert (tmp_path / "a" / "obj.ply").read_bytes() == (tmp_path / "b" / "obj.ply").read_bytes()
    if variant == "textured":  # the PNG's bytes differ (two encoders), its pixels do not
        np.testing.assert_array_equal(png.read_png(tmp_path / "a" / "obj.png"),
                                      np.asarray(Image.open(tmp_path / "b" / "obj.png")))
    # each side reads the other's file
    for d in ("a", "b"):
        assert_meshes_equal(tio.load_mesh(tmp_path / d / "obj.ply"),
                            jio.load_mesh(tmp_path / d / "obj.ply"))


# --------------------------------------------------------------------- OBJ

OBJ_FILES = {
    "mtl_texture": (
        "mtllib m.mtl\nv 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\nf 1/1 2/2 3/3\nf 1/1 3/3 4/4\n"
    ),
    "negative_indices": (
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nvt 0.1 0.2\nvt 0.3 0.4\nvt 0.5 0.6\nf -3/-3 -2/-2 -1/-1\n"
        "v 0 0 1\nvt 0.7 0.8\nf -1/-1 -3/-3 -2/-2\n"
    ),
    "quads_no_uv": "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0 0 1\nf 1 2 3 4\nf 1//1 2//1 5//1\n",
    "shared_position_two_uvs": (
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nvt 0 0\nvt 1 0\nvt 1 1\nvt 0.5 0.5\n"
        "f 1/1 2/2 3/3 4/4\nf 1/4 3/2 2/1\n"
    ),
    "points_only": "v 0 0 0\nv 1 2 3\n",
}


@pytest.mark.parametrize("name", sorted(OBJ_FILES))
def test_load_obj_matches_jax(name, tmp_path):
    (tmp_path / "m.obj").write_text(OBJ_FILES[name])
    if name == "mtl_texture":
        (tmp_path / "m.mtl").write_text("newmtl a\nKd 1 1 1\nmap_Kd tex.png\n")
        tex = np.random.RandomState(6).randint(0, 256, (5, 7, 3)).astype(np.uint8)
        Image.fromarray(tex).save(tmp_path / "tex.png")
    ours, ref = tio.load_mesh(tmp_path / "m.obj"), jio.load_mesh(tmp_path / "m.obj")
    assert_meshes_equal(ours, ref)
    if name == "mtl_texture":
        np.testing.assert_array_equal(ours.texture, tex.astype(np.float32) / 255.0)
    if name == "quads_no_uv":
        assert len(ours.faces) == 3 and ours.vertex_uv is None
    if name == "shared_position_two_uvs":
        assert len(ours.vertices) > 4  # split on (position, uv) pairs


def test_load_mesh_rejects_other_suffixes(tmp_path):
    with pytest.raises(ValueError):
        tio.load_mesh(tmp_path / "m.stl")


# ------------------------------------------------- generators and decimation

def _mesh_pair(name):
    makers = {
        "box": lambda m: m.make_box_mesh((0.03, 0.02, 0.05)),
        "uv_sphere": lambda m: m.make_uv_sphere(0.04, 7, 9, with_uv=True),
        "cylinder": lambda m: m.make_cylinder_mesh(0.02, 0.1, 12),
        "capsule": lambda m: m.make_capsule_mesh(0.02, 0.1, 10, 3),
        "axes": lambda m: m.make_axes_mesh(0.1),
        "position_colored": lambda m: m.position_colored(m.make_capsule_mesh(n_seg=8, n_cap=2)),
    }
    return makers[name](tio), makers[name](jio)


@pytest.mark.parametrize("name", ["box", "uv_sphere", "cylinder", "capsule", "axes",
                                  "position_colored"])
def test_mesh_generators_match_jax(name):
    ours, ref = _mesh_pair(name)
    assert_meshes_equal(ours, ref)
    assert ours.diameter == ref.diameter
    np.testing.assert_array_equal(ours.vertex_normals, ref.vertex_normals)
    np.testing.assert_array_equal(ours.aabb, ref.aabb)


@pytest.mark.parametrize("family", [None, *sorted(tio.TEXTURE_FAMILIES)])
def test_procedural_textures_match_jax(family):
    assert sorted(tio.TEXTURE_FAMILIES) == sorted(jio.TEXTURE_FAMILIES)
    a = tio.make_random_texture(np.random.RandomState(7), size=48, family=family)
    b = jio.make_random_texture(np.random.RandomState(7), size=48, family=family)
    assert a.dtype == np.float32 and a.shape == (48, 48, 3)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tio.make_procedural_texture(64, 3),
                                  jio.make_procedural_texture(64, 3))


@pytest.mark.parametrize("target", [50, 400, 100000])
def test_decimate_mesh_matches_jax(target):
    dense = tio.make_uv_sphere(0.05, 30, 40, with_uv=True)
    dense.texture = tio.make_procedural_texture(16, 1)
    _ = dense.vertex_normals  # cached normals are carried over
    jdense = jio.Mesh(**{f: getattr(dense, f) for f in MESH_FIELDS})
    ours, ref = tio.decimate_mesh(dense, target), jio.decimate_mesh(jdense, target)
    assert_meshes_equal(ours, ref)
    assert len(ours.faces) <= max(target, 1) or target < 100
    if target == 100000:
        assert ours is dense


def test_mesh_scaled_and_baked_texture_match_jax():
    mesh = _textured_sphere()
    jmesh = jio.Mesh(**{f: getattr(mesh, f) for f in MESH_FIELDS})
    assert_meshes_equal(mesh.scaled(1000.0), jmesh.scaled(1000.0))
    assert_meshes_equal(mesh.with_baked_texture(), jmesh.with_baked_texture())
    plain = tio.make_box_mesh()
    assert plain.with_baked_texture() is plain
