"""The port's rasterizer (`ops/rasterizer_fused.py`) against the JAX package.

On the CPU the wrapper runs the kernel's plain version,
`raster_fused_reference`; the CUDA kernel itself is held to that plain
version on the card by `chip_smoke.py`. Here the plain version is held to
the Pallas kernels, run through the Pallas interpreter with both dispatch
paths pinned as `tests/test_rasterizer_pallas.py` runs them, and to JAX's
exact two-pass renderer `render_batch`.

The Pallas kernels and the two-pass renderer themselves disagree on sliver
faces (the UV sphere's poles), so the comparison with Pallas uses the
thresholds of `tests/test_rasterizer_pallas.py:42-63`. The port evaluates
the same packed rows without the kernel's 3-deep matmul and agrees with
the two-pass renderer much more tightly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from happypose_tpu.meshes.database import MeshDataBase as JaxMeshDataBase
from happypose_tpu.meshes.io import make_box_mesh as jax_box, make_uv_sphere as jax_sphere
from happypose_tpu.ops.rasterizer import _face_screen_data, render_batch
from happypose_tpu.ops.rasterizer_pallas import raster_fused_pallas, render_batch_pallas
from happypose_tpu_torch.meshes.database import MeshDataBase
from happypose_tpu_torch.meshes.io import make_box_mesh, make_uv_sphere
from happypose_tpu_torch.ops import rasterizer_fused as rf

torch.set_num_threads(2)

H, W = 64, 128


def _dbs(with_uv=False, n_lat=12, n_lon=16):
    rs = np.random.RandomState(5)
    tex = rs.rand(16, 16, 3).astype(np.float32) if with_uv else None
    jm = {"sphere": jax_sphere(radius=0.05, n_lat=n_lat, n_lon=n_lon, with_uv=with_uv),
          "box": jax_box((0.04, 0.04, 0.04))}
    tm = {"sphere": make_uv_sphere(radius=0.05, n_lat=n_lat, n_lon=n_lon, with_uv=with_uv),
          "box": make_box_mesh((0.04, 0.04, 0.04))}
    if with_uv:
        jm["sphere"].texture = tex
        tm["sphere"].texture = tex
    return JaxMeshDataBase(jm), MeshDataBase(tm)


def _cameras(B, random_rotations):
    """The K and TCO of `tests/test_rasterizer_pallas.py::_setup` (B=2), or
    B seeded generic poses."""
    K = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
    K[:, 0, 0] = K[:, 1, 1] = 150.0
    K[:, 0, 2] = W / 2
    K[:, 1, 2] = H / 2
    TCO = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    TCO[:, 2, 3] = 0.5
    TCO[1, 0, 3] = 0.03
    if random_rotations:
        rs = np.random.RandomState(B)
        TCO[:, :3, :3] = Rotation.random(B, random_state=rs).as_matrix()
        TCO[:, :3, 3] = [0, 0, 0.45] + rs.randn(B, 3) * [0.02, 0.01, 0.05]
    return K, TCO


def _render_both(jdb, tdb, obj_ids, K, TCO, jax_render, **kw):
    ref = jax_render(
        jdb.render_assets(texture_size=16), jnp.asarray(obj_ids), jnp.asarray(TCO),
        jnp.asarray(K), resolution=(H, W), **kw,
    )
    out = rf.render_batch_fused(
        tdb.render_assets(texture_size=16), torch.from_numpy(obj_ids),
        torch.from_numpy(TCO), torch.from_numpy(K), resolution=(H, W),
    )
    ref = {k: np.asarray(getattr(ref, k)) for k in ("rgb", "depth", "mask", "normals")}
    out = {k: getattr(out, k).numpy() for k in ("rgb", "depth", "mask", "normals")}
    return ref, out


def _agreement(ref, out):
    """(mask agreement, and on pixels both cover: the share with depth
    within 1e-3, rgb within 0.02 and normals within 0.05)."""
    both = ref["mask"] & out["mask"]
    d = np.abs(out["depth"][both] - ref["depth"][both]) < 1e-3
    rgb = np.abs(out["rgb"][both] - ref["rgb"][both]).max(-1) < 0.02
    n = np.abs(out["normals"][both] - ref["normals"][both]).max(-1) < 0.05
    return (ref["mask"] == out["mask"]).mean(), d.mean(), rgb.mean(), n.mean()


@pytest.mark.parametrize("force_path", ["tilemajor", "dense"])
@pytest.mark.parametrize("random_rotations", [False, True])
def test_reference_matches_pallas_kernels(force_path, random_rotations):
    """`rasterize` (packing + raster_fused_reference) against
    `raster_fused_pallas` on the same face data (random attributes in
    [0, 1]). Demand the same coverage on 99.9% of pixels and, on 95% of the
    pixels both cover (the share test_rasterizer_pallas.py demands), iz to
    1e-5 relative; the attributes to 1e-4 on 90%. What is left is the
    sphere's pole slivers, where the interpreter's f32 matmul picks other
    faces than the port's separate products and extrapolates their
    attributes (to ~1e8 for inputs in [0, 1]), and, when the pole faces the
    camera, the pole fan's near-tied faces: their iz agree, their random
    attributes do not (8% of covered pixels). The port's 8x32 tiles
    (against 8x128) also shift edge-exact pixels."""
    jdb, _ = _dbs()
    B = 4
    K, TCO = _cameras(B, random_rotations)
    assets = jdb.render_assets()
    obj_ids = jnp.asarray(np.arange(B) % 2)
    inst = assets.select(obj_ids)
    fd = [
        _face_screen_data(inst.vertices[b], inst.faces[b], inst.faces_mask[b],
                          jnp.asarray(TCO[b]), jnp.asarray(K[b]))[0]
        for b in range(B)
    ]
    u, v, inv_z, valid = (np.stack([np.asarray(getattr(f, k)) for f in fd])
                          for k in ("u", "v", "inv_z", "valid"))
    attrs = np.random.RandomState(0).rand(*u.shape, 6).astype(np.float32)

    iz_ref, attr_ref = raster_fused_pallas(
        u, v, inv_z, valid, attrs, (H, W), interpret=True, force_path=force_path
    )
    iz_ref, attr_ref = np.asarray(iz_ref), np.asarray(attr_ref)
    iz, attr = rf.rasterize(*map(torch.from_numpy, (u, v, inv_z, valid, attrs)), (H, W))
    iz, attr = iz.numpy(), attr.numpy()

    assert ((iz > 0) == (iz_ref > 0)).mean() >= 0.999
    both = (iz > 0) & (iz_ref > 0)
    assert both.sum() > 0.05 * both.size
    iz_ok = np.abs(iz - iz_ref)[both] <= 1e-5 * iz_ref[both]
    attr_ok = np.abs(attr - attr_ref).max(1)[both] <= 1e-4
    assert iz_ok.mean() >= 0.95 and attr_ok.mean() >= 0.9


@pytest.mark.parametrize(
    "jax_renderer, scene, limits",
    [
        ("pallas_interpret", "identity", (0.99, 0.95, 0.95, 0.95)),
        ("pallas_interpret", "random", (0.99, 0.95, 0.95, 0.95)),
        ("two_pass", "identity", (0.999, 0.99, 0.99, 0.99)),
        ("two_pass", "random", (0.999, 0.999, 0.999, 0.999)),
    ],
)
def test_render_batch_fused_matches_jax(jax_renderer, scene, limits):
    """Full renders (shading, normals, depth): the sphere+box scene of
    `tests/test_rasterizer_pallas.py` ("identity": the sphere's pole faces
    the camera at a pixel centre) and 8 seeded generic poses ("random").
    `limits` bound (mask agreement, and the shares of overlap pixels with
    depth within 1e-3, rgb within 0.02, normals within 0.05). Against the
    Pallas interpreter: test_rasterizer_pallas.py's thresholds. Against the
    two-pass renderer, which evaluates the same edge functions without the
    matmul, 99.9%, and 99% for the pole-on-pixel-centre scene."""
    jdb, tdb = _dbs()
    if scene == "identity":
        K, TCO = _cameras(2, random_rotations=False)
        obj_ids = np.asarray([jdb.id_of("sphere"), jdb.id_of("box")])
    else:
        K, TCO = _cameras(8, random_rotations=True)
        obj_ids = np.arange(8) % 2
    if jax_renderer == "two_pass":
        ref, out = _render_both(jdb, tdb, obj_ids, K, TCO, render_batch)
    else:
        ref, out = _render_both(jdb, tdb, obj_ids, K, TCO, render_batch_pallas, interpret=True)
    agree = _agreement(ref, out)
    assert all(a > lim for a, lim in zip(agree, limits)), agree


def test_analytic_probe():
    """Sphere of radius 0.05 at z = 0.5: depth 0.45 at the image centre,
    background in the corner (the probe of test_rasterizer_pallas.py)."""
    _, tdb = _dbs()
    K, TCO = _cameras(2, random_rotations=False)
    sphere = tdb.id_of("sphere")
    out = rf.render_batch_fused(
        tdb.render_assets(), torch.tensor([sphere, sphere]), torch.from_numpy(TCO),
        torch.from_numpy(K), resolution=(H, W),
    )
    depth, mask = out.depth[0].numpy(), out.mask[0].numpy()
    assert mask[H // 2, W // 2]
    np.testing.assert_allclose(depth[H // 2, W // 2], 0.45, atol=3e-3)
    assert not mask[0, 0] and depth[0, 0] == 0.0


def test_textured_instance_matches_jax():
    """A UV-mapped sphere with a 16x16 texture: the kernel carries (u, v, 0)
    in its color channels and `resolve_albedo` samples the texture after
    it. Against JAX's two-pass renderer with the strict thresholds; a hard
    texture makes rgb the most sensitive channel, so rgb gets 99%."""
    jdb, tdb = _dbs(with_uv=True)
    K, TCO = _cameras(4, random_rotations=True)
    obj_ids = np.asarray([jdb.id_of("sphere")] * 3 + [jdb.id_of("box")])
    assert np.asarray(jdb.render_assets(texture_size=16).has_texture).tolist() == [False, True]
    ref, out = _render_both(jdb, tdb, obj_ids, K, TCO, render_batch)
    mask_ok, d_ok, rgb_ok, n_ok = _agreement(ref, out)
    assert mask_ok > 0.999 and d_ok > 0.999 and n_ok > 0.999 and rgb_ok > 0.99
    # the texture really shows: textured pixels are not the vertex colors
    hit = out["mask"][:3]
    assert np.unique(out["rgb"][:3][hit].round(2), axis=0).shape[0] > 50


def test_large_mesh_matches_pallas_dense():
    """A ~16k-face sphere (n_lat=64, n_lon=128: 256 chunks), the face count
    for which the TPU needed its dense sweep; one chunk loop covers it here.
    Thresholds of test_rasterizer_pallas.py: its poles are 64x denser in
    slivers than the small sphere's."""
    jdb, tdb = _dbs(n_lat=64, n_lon=128)
    K, TCO = _cameras(2, random_rotations=True)
    obj_ids = np.asarray([jdb.id_of("sphere")] * 2)
    assert np.asarray(jdb.render_assets().faces_mask).sum(1).max() == 16384
    ref, out = _render_both(jdb, tdb, obj_ids, K, TCO, render_batch_pallas,
                            interpret=True, force_path="dense")
    mask_ok, d_ok, rgb_ok, n_ok = _agreement(ref, out)
    assert mask_ok > 0.99 and min(d_ok, rgb_ok, n_ok) > 0.95, (mask_ok, d_ok, rgb_ok, n_ok)


def test_cpu_tensors_take_the_plain_path():
    """On CPU tensors the wrapper runs the plain version and never counts a
    launch; a device that is neither CPU nor CUDA is refused, and so are
    inputs the kernel does not take."""
    _, tdb = _dbs()
    K, TCO = _cameras(2, random_rotations=False)
    before = rf.launches
    ids = torch.tensor([0, 1])
    rf.render_batch_fused(tdb.render_assets(), ids, torch.from_numpy(TCO),
                          torch.from_numpy(K), resolution=(H, W))
    assert rf.launches == before

    A = torch.zeros(1, rf.CHUNK, 3, rf.N_ROWS)
    bbox = torch.zeros(1, 1, 4)
    assert rf.raster_fused(A, bbox, (8, 8)).shape == (1, rf.N_OUT, 8, 8)
    assert rf.launches == before
    with pytest.raises(ValueError):
        rf.raster_fused(A.to("meta"), bbox.to("meta"), (8, 8))
    with pytest.raises(TypeError):
        rf.raster_fused(A.double(), bbox, (8, 8))
    with pytest.raises(ValueError):
        rf.raster_fused(A[:, :10], bbox, (8, 8))
    with pytest.raises(ValueError):
        rf.raster_fused(A.transpose(2, 3).contiguous().transpose(2, 3), bbox, (8, 8))
