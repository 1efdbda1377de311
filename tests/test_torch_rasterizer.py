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
from happypose_tpu_torch.ops import rasterizer as tr
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
        tdb.render_assets(texture_size=16, device="cpu"), torch.from_numpy(obj_ids),
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


def _ico_dbs():
    """An icosphere (no pole slivers) and a box in both databases."""
    from happypose_tpu.meshes.io import Mesh as JaxMesh

    ico = _icosphere()
    jm = {"ico": JaxMesh(vertices=ico.vertices, faces=ico.faces, vertex_colors=ico.vertex_colors),
          "box": jax_box((0.04, 0.03, 0.05))}
    tm = {"ico": ico, "box": make_box_mesh((0.04, 0.03, 0.05))}
    return JaxMeshDataBase(jm), MeshDataBase(tm)


@pytest.mark.parametrize("with_lights", [False, True])
def test_two_pass_render_batch_matches_jax(with_lights):
    """The port's two-pass `render_batch` against JAX's on an icosphere and
    a box at 64x128, 6 seeded poses, a face chunk (32) that does not divide
    the box's 12 faces: the masks are equal, depth, normals and rgb agree
    to 1e-5 (the same edge functions and interpolation, float32). With
    per-image `lights`: two directions off the optical axis."""
    jdb, tdb = _ico_dbs()
    K, TCO = _cameras(6, random_rotations=True)
    obj_ids = np.arange(6) % 2
    kw = {}
    if with_lights:
        lights = np.random.RandomState(0).rand(6, 5).astype(np.float32)
        lights[:, 2] -= 1.5  # toward the camera
        kw = {"lights": lights}
    ref = render_batch(
        jdb.render_assets(), jnp.asarray(obj_ids), jnp.asarray(TCO), jnp.asarray(K),
        resolution=(H, W), **{k: jnp.asarray(v) for k, v in kw.items()},
    )
    out = tr.render_batch(
        tdb.render_assets(device="cpu"), torch.from_numpy(obj_ids), torch.from_numpy(TCO),
        torch.from_numpy(K), resolution=(H, W), **{k: torch.from_numpy(v) for k, v in kw.items()},
    )
    mask = np.asarray(ref.mask)
    assert 0.05 < mask.mean() < 0.9
    np.testing.assert_array_equal(out.mask.numpy(), mask)
    for k in ("depth", "normals", "rgb"):
        np.testing.assert_allclose(getattr(out, k).numpy(), np.asarray(getattr(ref, k)),
                                   atol=1e-5, rtol=0, err_msg=k)
    if with_lights:
        plain = tr.render_batch(
            tdb.render_assets(device="cpu"), torch.from_numpy(obj_ids), torch.from_numpy(TCO),
            torch.from_numpy(K), resolution=(H, W),
        )
        assert (plain.rgb - out.rgb).abs().max() > 0.05


@pytest.mark.parametrize("scene", ["ico + box", "uv sphere + box"])
def test_render_batch_fused_matches_two_pass(scene):
    """The fused renderer (the CUDA kernel's plain version here) against the
    port's own two-pass renderer, the independent oracle of depth: on an
    icosphere every pixel's mask is equal and depth agrees to 1e-4 (1e-5 on
    all but a few pixels of faces seen nearly edge-on, where 1/z changes
    fast across a pixel and the fused form's affine rows and the two-pass
    form's barycentric weights round differently: 2.4e-5 measured); on the
    UV sphere, whose pole slivers the two resolve differently, 99.9% of the
    masks and of the covered pixels' depths (to 1e-3)."""
    _, tdb = _ico_dbs() if scene == "ico + box" else _dbs()
    K, TCO = _cameras(6, random_rotations=True)
    args = (tdb.render_assets(device="cpu"), torch.arange(6) % 2, torch.from_numpy(TCO),
            torch.from_numpy(K))
    ref = tr.render_batch(*args, resolution=(H, W))
    out = rf.render_batch_fused(*args, resolution=(H, W))
    if scene == "ico + box":
        assert torch.equal(out.mask, ref.mask)
        np.testing.assert_allclose(out.depth.numpy(), ref.depth.numpy(), atol=1e-4, rtol=0)
        assert ((out.depth - ref.depth).abs() > 1e-5).float().mean() < 1e-3
        np.testing.assert_allclose(out.normals.numpy(), ref.normals.numpy(), atol=1e-3, rtol=0)
    else:
        agree = _agreement({k: getattr(ref, k).numpy() for k in ("rgb", "depth", "mask", "normals")},
                           {k: getattr(out, k).numpy() for k in ("rgb", "depth", "mask", "normals")})
        assert min(agree) > 0.999, agree


def test_analytic_probe():
    """Sphere of radius 0.05 at z = 0.5: depth 0.45 at the image centre,
    background in the corner (the probe of test_rasterizer_pallas.py)."""
    _, tdb = _dbs()
    K, TCO = _cameras(2, random_rotations=False)
    sphere = tdb.id_of("sphere")
    out = rf.render_batch_fused(
        tdb.render_assets(device="cpu"), torch.tensor([sphere, sphere]), torch.from_numpy(TCO),
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


def _icosphere(radius=0.05, subdivisions=2):
    """Icosahedron subdivided `subdivisions` times: faces of even size, no
    pole slivers."""
    from happypose_tpu_torch.meshes.io import Mesh

    t = (1 + 5 ** 0.5) / 2
    v = [(-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0), (0, -1, t), (0, 1, t),
         (0, -1, -t), (0, 1, -t), (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1)]
    f = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11), (1, 5, 9), (5, 11, 4),
         (11, 10, 2), (10, 7, 6), (7, 1, 8), (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8),
         (3, 8, 9), (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    v = [np.asarray(x, np.float64) / np.linalg.norm(x) for x in v]
    for _ in range(subdivisions):
        mid, nf = {}, []

        def midpoint(i, j):
            key = (min(i, j), max(i, j))
            if key not in mid:
                m = v[i] + v[j]
                v.append(m / np.linalg.norm(m))
                mid[key] = len(v) - 1
            return mid[key]

        for a, b, c in f:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            nf += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        f = nf
    verts = (np.stack(v) * radius).astype(np.float32)
    colors = (verts / radius * 0.5 + 0.5).astype(np.float32)
    return Mesh(vertices=verts, faces=np.asarray(f, np.int32), vertex_colors=colors)


def _packed_scene(scene):
    """(A, chunk_bbox, resolution) of a seeded scene, packed by the port."""
    res, f, z, B = (H, W), 150.0, 0.45, 4
    if scene == "debug sphere + box":
        _, tdb = _dbs(n_lat=24, n_lon=32)
    elif scene == "icosphere":
        tdb = MeshDataBase({"ico": _icosphere()})
    elif scene == "16k-face sphere, small resolution":
        tdb, B = MeshDataBase({"sphere": make_uv_sphere(radius=0.05, n_lat=90, n_lon=90)}), 2
    elif scene == "ragged 45x77":
        (_, tdb), res = _dbs(), (45, 77)
    elif scene == "one tile holds 1200 faces":
        # a sphere of 16 px diameter: every face of the mesh reaches one or
        # two tiles, far more than any fixed per-tile capacity
        tdb, f, B = MeshDataBase({"sphere": make_uv_sphere(radius=0.05, n_lat=30, n_lon=40)}), 36.0, 2
    rs = np.random.RandomState(len(scene))
    K = np.tile(np.asarray([[f, 0, res[1] / 2], [0, f, res[0] / 2], [0, 0, 1]], np.float32), (B, 1, 1))
    TCO = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    TCO[:, :3, :3] = Rotation.random(B, random_state=rs).as_matrix()
    TCO[:, :3, 3] = [0, 0, z] + rs.randn(B, 3) * [0.02, 0.01, 0.03]
    ids = torch.arange(B) % len(tdb.labels)
    inst = tdb.render_assets(device="cpu").select(ids)
    fd, attrs = rf.face_inputs(inst, torch.from_numpy(TCO), torch.from_numpy(K))
    return (*rf.pack_faces(fd.u, fd.v, fd.inv_z, fd.valid, attrs, res), res)


def _frozen_chunk_reference(
    A: torch.Tensor, chunk_bbox: torch.Tensor, resolution
) -> torch.Tensor:
    """The plain version as it stood before the kernel got per-tile face
    lists, kept unchanged: a chunk is evaluated on the tiles its union bbox
    overlaps (no margin), every face of it at every pixel there."""
    rf._check_packed(A, chunk_bbox, resolution)
    H, W = resolution
    B, n_chunks = A.shape[0], A.shape[1] // rf.CHUNK
    dev = A.device
    n_th, n_tw = rf._cdiv(H, rf.TILE_H), rf._cdiv(W, rf.TILE_W)
    out = torch.zeros(B, rf.N_OUT, H, W, dtype=torch.float32, device=dev)
    if n_chunks == 0:
        return out

    # the tiles each chunk overlaps (the kernel's block-uniform cull); the
    # overlapping tiles of a chunk form one rectangle of whole tiles
    tu0s = torch.arange(n_tw, device=dev, dtype=torch.float32) * rf.TILE_W
    tv0s = torch.arange(n_th, device=dev, dtype=torch.float32) * rf.TILE_H
    umin, vmin, umax, vmax = chunk_bbox.unbind(-1)
    ok_u = (umax[..., None] >= tu0s) & (umin[..., None] <= tu0s + (rf.TILE_W - 1))
    ok_v = (vmax[..., None] >= tv0s) & (vmin[..., None] <= tv0s + (rf.TILE_H - 1))

    def span(ok):  # first and last overlapping tile, -1 when none
        n = ok.shape[-1]
        first = ok.int().argmax(-1)
        last = n - 1 - ok.flip(-1).int().argmax(-1)
        none = ~ok.any(-1)
        return first.masked_fill(none, -1), last.masked_fill(none, -1)

    spans = torch.stack([*span(ok_u), *span(ok_v)], dim=-1).tolist()

    fidx = torch.arange(rf.CHUNK, device=dev)[:, None, None]
    for b in range(B):
        best = out[b, 0]
        acc = out[b, 1:]
        for c in range(n_chunks):
            j0, j1, i0, i1 = spans[b][c]
            if j0 < 0 or i0 < 0:
                continue
            x0, x1 = j0 * rf.TILE_W, min((j1 + 1) * rf.TILE_W, W)
            y0, y1 = i0 * rf.TILE_H, min((i1 + 1) * rf.TILE_H, H)
            gu = torch.arange(x0, x1, device=dev)
            gv = torch.arange(y0, y1, device=dev)
            tu0 = ((gu // rf.TILE_W) * rf.TILE_W).float()
            tv0 = ((gv // rf.TILE_H) * rf.TILE_H).float()
            pu, pv = (gu.float() - tu0), (gv.float() - tv0)
            gu, gv = gu.float(), gv.float()

            Ac = A[b, c * rf.CHUNK:(c + 1) * rf.CHUNK]  # [rf.CHUNK, 3, rf.N_ROWS]
            a, bc, cc = Ac[:, 0], Ac[:, 1], Ac[:, 2]  # [rf.CHUNK, rf.N_ROWS]

            # edge and iz rows at every pixel of the window: [rf.CHUNK, 4, h, w]
            ra, rb, rc = (x[:, :4, None, None] for x in (a, bc, cc))
            R = (ra * pu + rb * pv[:, None]) + ((rc + ra * tu0) + rb * tv0[:, None])
            const = cc[:, rf.N_AFF:, None, None]  # [rf.CHUNK, 6, 1, 1]
            iz = torch.minimum(torch.maximum(R[:, 3], const[:, 0]), const[:, 1])
            cov = (R[:, 0] >= 0) & (R[:, 1] >= 0) & (R[:, 2] >= 0)
            inside = (
                (gu >= const[:, 2] - 1.0)
                & (gu <= const[:, 4] + 1.0)
                & (gv[:, None] >= const[:, 3] - 1.0)
                & (gv[:, None] <= const[:, 5] + 1.0)
            )
            cand = torch.where(cov & inside, iz, torch.full_like(iz, -1.0))
            cbest = cand.amax(0)  # [h, w]
            win = torch.where(cand == cbest, fidx, rf.CHUNK).amin(0)  # [h, w]
            # the winner's attribute rows, evaluated pixel by pixel
            aw = a[win, 4:rf.N_AFF].permute(2, 0, 1)  # [6, h, w]
            bw = bc[win, 4:rf.N_AFF].permute(2, 0, 1)
            cw = cc[win, 4:rf.N_AFF].permute(2, 0, 1)
            attr = (aw * pu + bw * pv[:, None]) + ((cw + aw * tu0) + bw * tv0[:, None])

            prev = best[y0:y1, x0:x1]
            better = (cbest > prev) & (cbest > 0)
            best[y0:y1, x0:x1] = torch.where(better, cbest, prev)
            acc[:, y0:y1, x0:x1] = torch.where(better, attr, acc[:, y0:y1, x0:x1])
    return out



SCENES = ["debug sphere + box", "icosphere", "16k-face sphere, small resolution",
          "ragged 45x77", "one tile holds 1200 faces"]


@pytest.mark.parametrize("scene", SCENES)
def test_plain_version_matches_frozen_chunk_version(scene):
    """The plain version with per-tile lists against the frozen one that
    culled by chunk union boxes. They may differ only where a face wins a
    pixel up to 1 px outside its own bbox in a tile its chunk's union bbox
    does not overlap (the frozen version's chunk cull took no margin, the
    lists do): at most 1e-4 of the pixels. Observed: none."""
    A, bbox, res = _packed_scene(scene)
    new = rf.raster_fused_reference(A, bbox, res)
    old = _frozen_chunk_reference(A, bbox, res)
    assert (new[:, 0] > 0).float().mean() > 0.005  # the scene is not empty
    differing = (new != old).any(dim=1).float().mean().item()
    assert differing <= 1e-4, differing


@pytest.mark.parametrize("scene", SCENES)
def test_lists_hold_every_face_that_can_win(scene):
    """Per tile, the list holds every face that `inside` accepts at a pixel
    of the tile (so every face `cov && inside` could accept), in ascending
    packed order, and nothing a tile's chunk-and-face bbox test rejects."""
    A, bbox, res = _packed_scene(scene)
    count, lists = rf.bin_faces_reference(A, bbox, res)
    n_tw = -(-res[1] // rf.TILE_W)
    gv, gu = torch.meshgrid(torch.arange(res[0]), torch.arange(res[1]), indexing="ij")
    tile_of_pixel = (gv // rf.TILE_H) * n_tw + gu // rf.TILE_W
    per_tile = iter(lists.split(count.flatten().tolist()))
    longest = 0
    for b in range(A.shape[0]):
        umin, vmin, umax, vmax = (A[b, :, 2, rf.N_AFF + 2 + k, None, None] for k in range(4))
        inside = ((gu >= umin - 1.0) & (gu <= umax + 1.0)
                  & (gv >= vmin - 1.0) & (gv <= vmax + 1.0))  # [Fp, H, W]
        for tile in range(count.shape[1]):
            faces = next(per_tile)
            assert bool((faces[1:] > faces[:-1]).all())
            needed = inside[:, tile_of_pixel == tile].any(dim=1).nonzero()[:, 0]
            assert bool(torch.isin(needed, faces).all()), (b, tile)
            longest = max(longest, len(faces))
    if scene == "one tile holds 1200 faces":
        assert longest >= 1200


def test_dead_faces_reach_no_tile():
    """Padding and degenerate faces carry a never-inside bbox in their
    constant rows, so they are in no list."""
    A, bbox, res = _packed_scene("debug sphere + box")
    dead = (A[:, :, 0, 0] == 0) & (A[:, :, 1, 0] == 0) & (A[:, :, 2, 0] == -1.0)
    assert dead.any()
    for b in range(A.shape[0]):
        _, lists = rf.bin_faces_reference(A[b:b + 1], bbox[b:b + 1], res)
        assert len(lists) > 0 and not dead[b][lists.long()].any()
    # labels sort to (box, sphere), so image 0 is the box: 12 live faces
    _, lists = rf.bin_faces_reference(A[:1], bbox[:1], res)
    assert 0 < len(lists.unique()) <= 12


def test_cpu_tensors_take_the_plain_path():
    """On CPU tensors the wrapper runs the plain version and never counts a
    launch; a device that is neither CPU nor CUDA is refused, and so are
    inputs the kernel does not take."""
    _, tdb = _dbs()
    K, TCO = _cameras(2, random_rotations=False)
    before = rf.launches
    ids = torch.tensor([0, 1])
    rf.render_batch_fused(tdb.render_assets(device="cpu"), ids, torch.from_numpy(TCO),
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
