"""lib3d, SO(3) grids and the mesh database: each ported function against its
JAX counterpart on the same seeded numpy inputs.

Tolerance: 1e-5 absolute + 1e-5 relative unless a case says otherwise —
float32 results of a few operations, summed in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import happypose_tpu.lib3d.camera as jcam
import happypose_tpu.lib3d.cropping as jcrop
import happypose_tpu.lib3d.distances as jdist
import happypose_tpu.lib3d.multiview_geom as jmv
import happypose_tpu.lib3d.pose_init as jinit
import happypose_tpu.lib3d.pose_update as jupd
import happypose_tpu.lib3d.rotations as jrot
import happypose_tpu.lib3d.so3_grid as jgrid
import happypose_tpu.lib3d.symmetries as jsym
import happypose_tpu.lib3d.transforms as jtf
import happypose_tpu.meshes.database as jdb
import happypose_tpu.meshes.io as jio
import happypose_tpu_torch.lib3d.camera as tcam
import happypose_tpu_torch.lib3d.cropping as tcrop
import happypose_tpu_torch.lib3d.distances as tdist
import happypose_tpu_torch.lib3d.multiview_geom as tmv
import happypose_tpu_torch.lib3d.pose_init as tinit
import happypose_tpu_torch.lib3d.pose_update as tupd
import happypose_tpu_torch.lib3d.rotations as trot
import happypose_tpu_torch.lib3d.so3_grid as tgrid
import happypose_tpu_torch.lib3d.symmetries as tsym
import happypose_tpu_torch.lib3d.transforms as ttf
import happypose_tpu_torch.meshes.database as tdb
import happypose_tpu_torch.meshes.io as tio

torch.set_num_threads(2)

B = 6


def _rigid(rs, n=B, z=0.5):
    T = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    T[:, :3, :3] = Rotation.random(n, random_state=rs).as_matrix()
    T[:, :3, 3] = rs.randn(n, 3) * 0.05 + [0, 0, z]
    return T


def _K(n=B):
    K = np.tile(np.asarray([[500.0, 0, 320], [0, 510.0, 240], [0, 0, 1]], np.float32), (n, 1, 1))
    return K


def _boxes(rs, n=B):
    xy = rs.rand(n, 2).astype(np.float32) * [400, 300]
    wh = rs.rand(n, 2).astype(np.float32) * 100 + 20
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _both(jfn, tfn, *args, **kw):
    """Run jfn on jnp arrays and tfn on tensors of the same numpy args."""
    j = jfn(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args], **kw)
    t = tfn(*[torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args], **kw)
    return np.asarray(j), t.numpy()


def case_rotmat_from_ortho6d(rs):
    return _both(jrot.rotmat_from_ortho6d, trot.rotmat_from_ortho6d,
                 rs.randn(B, 6).astype(np.float32))


def case_quat_to_rotmat(rs):
    return _both(jrot.quat_to_rotmat, trot.quat_to_rotmat, rs.randn(B, 4).astype(np.float32))


def _rotmats(rs):
    """Random rotations, plus ones whose largest quaternion component is
    each of w, x, y, z (the four branches) and the identity."""
    special = np.asarray([[0, 0, 0, 1], [1, 0, 0, 0.01], [0.01, 1, 0, 0], [0, 0.01, 1, 0]])
    q = np.concatenate([Rotation.random(B, random_state=rs).as_quat(), special])
    return Rotation.from_quat(q).as_matrix().astype(np.float32)


def case_rotmat_to_quat(rs):
    return _both(jrot.rotmat_to_quat, trot.rotmat_to_quat, _rotmats(rs))


def case_axis_angle_to_rotmat(rs):
    aa = rs.randn(B, 3).astype(np.float32)
    aa[0] = 0.0  # the Taylor branch
    aa[1] *= 1e-7
    return _both(jrot.axis_angle_to_rotmat, trot.axis_angle_to_rotmat, aa)


def case_euler_to_rotmat(rs):
    return _both(jrot.euler_to_rotmat, trot.euler_to_rotmat, rs.randn(2, B, 3).astype(np.float32))


def case_geodesic_distance(rs):
    R = _rotmats(rs)
    return _both(jrot.geodesic_distance, trot.geodesic_distance, R, R[::-1].copy())


def case_log_SO3(rs):
    return _both(jrot.log_SO3, trot.log_SO3, _rotmats(rs))


def case_log_SE3_norm(rs):
    return _both(jrot.log_SE3_norm, trot.log_SE3_norm, _rigid(rs), _rigid(rs))


def _sym_poses(lib):
    """A discrete symmetry (180 degrees about x, with an offset in mm) times
    a continuous z axis sampled 4 times: 8 poses, identity first."""
    flip = np.diag([1.0, -1.0, -1.0, 1.0])
    flip[:3, 3] = [0.0, 2.0, 0.0]
    return lib.make_symmetries_poses(
        [lib.DiscreteSymmetry(pose=flip)], [lib.ContinuousSymmetry()], n_symmetries_continuous=4,
    )


def case_make_symmetries_poses(rs):
    j, t = _sym_poses(jsym), _sym_poses(tsym)
    assert t.shape == (8, 4, 4) and np.array_equal(t[0], np.eye(4))
    return j, t


def _dist_inputs(rs, P=30, S=3):
    pts = rs.randn(B, P, 3).astype(np.float32) * 0.05
    mask = rs.rand(B, P) > 0.2
    syms = np.stack([_rigid(rs, n=S, z=0.0) for _ in range(B)])
    syms[:, 0] = np.eye(4)
    sym_mask = np.ones((B, S), bool)
    sym_mask[::2, -1] = False
    T1 = _rigid(rs)
    T2 = T1.copy()
    T2[:, :3, 3] += rs.randn(B, 3).astype(np.float32) * 0.01
    return T1, T2, pts, mask, syms, sym_mask


def case_dists_add(rs):
    T1, T2, pts, *_ = _dist_inputs(rs)
    return _both(jdist.dists_add, tdist.dists_add, T1, T2, pts)


def case_dists_add_symmetric(rs):
    T1, T2, pts, *_ = _dist_inputs(rs)
    return _both(jdist.dists_add_symmetric, tdist.dists_add_symmetric, T1, T2, pts)


def case_compute_ADD_L1_loss(rs):
    T1, T2, pts, mask, *_ = _dist_inputs(rs)
    plain = _both(jdist.compute_ADD_L1_loss, tdist.compute_ADD_L1_loss, T1, T2, pts)
    masked = _both(jdist.compute_ADD_L1_loss, tdist.compute_ADD_L1_loss, T1, T2, pts, mask)
    return tuple(np.stack(x) for x in zip(plain, masked))


def case_compute_ADDS_loss(rs):
    T1, T2, pts, *_ = _dist_inputs(rs)
    return _both(jdist.compute_ADDS_loss, tdist.compute_ADDS_loss, T1, T2, pts)


def _pair(jfn, tfn, *args, **kw):
    """As `_both` for functions that return (value [B], pose [B, 4, 4]):
    both are compared, flattened into one array."""
    j = jfn(*[jnp.asarray(a) for a in args], **kw)
    t = tfn(*[torch.from_numpy(a) for a in args], **kw)
    return (np.concatenate([np.asarray(j[0])[:, None], np.asarray(j[1]).reshape(B, -1)], 1),
            np.concatenate([t[0].numpy()[:, None], t[1].numpy().reshape(B, -1)], 1))


@pytest.fixture(params=[(False, False), (True, False), (False, True)])
def loss_kw(request):
    return request.param


def case_loss_CO_symmetric(rs, kw=(True, True)):
    l2, masked = kw
    T1, T2, pts, mask, syms, _ = _dist_inputs(rs)
    possible = np.einsum("bij,bsjk->bsik", T1, syms)
    args = (possible, T2, pts)
    if not masked:
        return _pair(jdist.loss_CO_symmetric, tdist.loss_CO_symmetric, *args, l2=l2)
    j = jdist.loss_CO_symmetric(*map(jnp.asarray, args), l2=l2, points_mask=jnp.asarray(mask))
    t = tdist.loss_CO_symmetric(*map(torch.from_numpy, args), l2=l2,
                                points_mask=torch.from_numpy(mask))
    return (np.concatenate([np.asarray(j[0])[:, None], np.asarray(j[1]).reshape(B, -1)], 1),
            np.concatenate([t[0].numpy()[:, None], t[1].numpy().reshape(B, -1)], 1))


def case_symmetric_distance_batched(rs):
    T1, T2, pts, mask, syms, sym_mask = _dist_inputs(rs)
    # T2 sits at one of T1's symmetric poses, so the argmin is decided
    T2 = np.einsum("bij,bjk->bik", T1, syms[:, 1]).astype(np.float32)
    T2[:, :3, 3] += rs.randn(B, 3).astype(np.float32) * 1e-3
    plain = _pair(jdist.symmetric_distance_batched, tdist.symmetric_distance_batched,
                  T1, T2, pts, syms)
    j = jdist.symmetric_distance_batched(*map(jnp.asarray, (T1, T2, pts, syms, mask, sym_mask)))
    t = tdist.symmetric_distance_batched(*map(torch.from_numpy, (T1, T2, pts, syms, mask, sym_mask)))
    assert plain[1][:, 0].max() < 5e-3  # the symmetric pose was found
    return (np.concatenate([plain[0], np.asarray(j[0])[:, None], np.asarray(j[1]).reshape(B, -1)], 1),
            np.concatenate([plain[1], t[0].numpy()[:, None], t[1].numpy().reshape(B, -1)], 1))


def case_make_T(rs):
    T = _rigid(rs)
    return _both(jtf.make_T, ttf.make_T, T[:, :3, :3], T[:, :3, 3])


def case_invert_transforms(rs):
    return _both(jtf.invert_transforms, ttf.invert_transforms, _rigid(rs))


def case_normalize_T(rs):
    T = _rigid(rs)
    T[:, :3, :3] += rs.randn(B, 3, 3).astype(np.float32) * 0.05
    return _both(jtf.normalize_T, ttf.normalize_T, T)


def case_transform_pts(rs):
    return _both(jtf.transform_pts, ttf.transform_pts, _rigid(rs),
                 rs.randn(B, 50, 3).astype(np.float32) * 0.05)


def case_transform_pts_sym(rs):
    T = np.stack([_rigid(rs, n=4) for _ in range(B)])  # [B, S, 4, 4]
    return _both(jtf.transform_pts, ttf.transform_pts, T,
                 rs.randn(B, 50, 3).astype(np.float32) * 0.05)


def case_project_points_robust(rs):
    pts = rs.randn(B, 50, 3).astype(np.float32) * 0.05
    T = _rigid(rs)
    T[0, 2, 3] = -0.02  # behind the camera: depth clamps at z_min
    return _both(jcam.project_points_robust, tcam.project_points_robust, pts, _K(), T)


def case_masked_boxes_from_uv(rs):
    uv = rs.randn(B, 30, 2).astype(np.float32) * 100
    mask = rs.rand(B, 30) > 0.3
    return _both(jcam.masked_boxes_from_uv, tcam.masked_boxes_from_uv, uv, mask)


def case_get_K_crop_resize(rs):
    boxes = _boxes(rs)
    j = jcam.get_K_crop_resize(jnp.asarray(_K()), jnp.asarray(boxes), (480, 640), (240, 320))
    t = tcam.get_K_crop_resize(torch.from_numpy(_K()), torch.from_numpy(boxes), (480, 640), (240, 320))
    return np.asarray(j), t.numpy()


def case_deepim_boxes(rs):
    center = rs.rand(B, 1, 2).astype(np.float32) * [640, 480]
    return _both(jcrop.deepim_boxes, tcrop.deepim_boxes, center, _boxes(rs), _boxes(rs),
                 lamb=1.4, im_size=(480, 640))


@pytest.fixture(params=[
    ("TCO", False, False), ("front_3views", False, False),
    ("front_5views", True, False), ("sphere_26views", False, True),
])
def multiview_kw(request):
    t, remove, inplane = request.param
    return dict(multiview_type=t, remove_TCO_rendering=remove, views_inplane_rotations=inplane)


def case_make_TCO_multiview(rs, kw=dict(multiview_type="sphere_26views", views_inplane_rotations=True)):
    T = _rigid(rs)
    return _both(jmv.make_TCO_multiview, tmv.make_TCO_multiview, T, T[:, :3, 3], **kw)


def case_pose_update_with_reference_point(rs):
    T = _rigid(rs)
    dR = Rotation.random(B, random_state=rs).as_matrix().astype(np.float32)
    v = (rs.randn(B, 3) * [5, 5, 0.05] + [0, 0, 1]).astype(np.float32)
    tCR = T[:, :3, 3] + rs.randn(B, 3).astype(np.float32) * 0.01
    return _both(jupd.pose_update_with_reference_point, tupd.pose_update_with_reference_point,
                 T, _K(), v, dR, tCR)


def case_TCO_init_from_boxes_autodepth_with_R(rs):
    pts = rs.randn(B, 40, 3).astype(np.float32) * 0.05
    mask = rs.rand(B, 40) > 0.2
    R = Rotation.random(B, random_state=rs).as_matrix().astype(np.float32)
    return _both(jinit.TCO_init_from_boxes_autodepth_with_R, tinit.TCO_init_from_boxes_autodepth_with_R,
                 _boxes(rs), pts, _K(), R, mask)


def case_load_SO3_grid_qua(rs):
    return jgrid.load_SO3_grid(72), tgrid.load_SO3_grid(72)


def case_load_SO3_grid_576(rs):
    return jgrid.load_SO3_grid(576), tgrid.load_SO3_grid(576)


def case_load_SO3_grid_super_fibonacci(rs):
    return jgrid.load_SO3_grid(16), tgrid.load_SO3_grid(16)


def case_make_uv_sphere(rs):
    j = jio.make_uv_sphere(radius=0.05, n_lat=7, n_lon=9, with_uv=True)
    t = tio.make_uv_sphere(radius=0.05, n_lat=7, n_lon=9, with_uv=True)
    np.testing.assert_array_equal(j.faces, t.faces)
    np.testing.assert_allclose(j.vertex_uv, t.vertex_uv, atol=1e-7, rtol=0)
    np.testing.assert_allclose(j.vertex_normals, t.vertex_normals, atol=1e-6, rtol=0)
    assert j.diameter == pytest.approx(t.diameter, rel=1e-6)
    return j.vertices, t.vertices


def _databases():
    tex = np.random.RandomState(1).rand(8, 8, 3).astype(np.float32)
    meshes = {}
    for lib, db in ((jio, jdb), (tio, tdb)):
        sphere = lib.make_uv_sphere(radius=0.04, n_lat=6, n_lon=8, with_uv=True)
        sphere.texture = tex
        meshes[lib] = db.MeshDataBase(
            {"sphere": sphere, "box": lib.make_box_mesh((0.02, 0.03, 0.04))},
            scales={"box": 2.0},
        )
    return meshes[jio], meshes[tio]


def _symmetric_databases():
    """Databases whose box has the 8 symmetries of `_sym_poses` and whose
    sphere has 2; `batched` pads the sphere's with the identity."""
    out = []
    for lib, db, sym in ((jio, jdb, jsym), (tio, tdb, tsym)):
        S = _sym_poses(sym)
        out.append(db.MeshDataBase(
            {"sphere": lib.make_uv_sphere(radius=0.04, n_lat=6, n_lon=8),
             "box": lib.make_box_mesh((0.02, 0.03, 0.04))},
            symmetries={"box": S, "sphere": S[:2]},
        ))
    return out


def case_batched_symmetries(rs):
    j, t = _symmetric_databases()
    jb, tb = j.batched(n_points=50), t.batched(n_points=50, device="cpu")
    assert tb.n_sym_max == jb.n_sym_max == 8
    ids = np.asarray([1, 0, 0])
    js, ts = jb.select(jnp.asarray(ids)), tb.select(torch.from_numpy(ids))
    np.testing.assert_array_equal(np.asarray(js.symmetries_mask), ts.symmetries_mask.numpy())
    assert ts.symmetries_mask.sum(1).tolist() == [2, 8, 8]
    np.testing.assert_array_equal(ts.symmetries[0, 2:].numpy(), np.tile(np.eye(4), (6, 1, 1)))
    return np.asarray(js.symmetries), ts.symmetries.numpy()


def case_batched_n_sym_and_aabb(rs):
    """`n_sym` truncates the symmetry slots; `aabb` replaces the sampled
    points by the 8 box corners."""
    j, t = _symmetric_databases()
    jb, tb = j.batched(n_sym=3, aabb=True), t.batched(n_sym=3, aabb=True, device="cpu")
    assert tuple(tb.points.shape) == (2, 8, 3) and tuple(tb.symmetries.shape) == (2, 3, 4, 4)
    np.testing.assert_array_equal(np.asarray(jb.symmetries_mask), tb.symmetries_mask.numpy())
    np.testing.assert_allclose(np.asarray(jb.symmetries), tb.symmetries.numpy(), atol=1e-6)
    assert (t.ids_of(["sphere", "box"]) == j.ids_of(["sphere", "box"])).all()
    return np.asarray(jb.points), tb.points.numpy()


def case_render_assets(rs):
    j, t = _databases()
    ja, ta = j.render_assets(texture_size=8), t.render_assets(texture_size=8, device="cpu")
    ids = np.asarray([1, 0, 1])
    js, ts = ja.select(jnp.asarray(ids)), ta.select(torch.from_numpy(ids))
    for k in ("faces", "faces_mask", "has_texture", "textures", "vertex_uv", "vertex_colors",
              "vertex_normals"):
        np.testing.assert_allclose(np.asarray(getattr(js, k)), getattr(ts, k).numpy(), atol=1e-6)
    return np.asarray(js.vertices), ts.vertices.numpy()


def case_batched_meshes(rs):
    j, t = _databases()
    jb, tb = j.batched(n_points=100), t.batched(n_points=100, device="cpu")
    ids = np.asarray([0, 1, 1])
    js, ts = jb.select(jnp.asarray(ids)), tb.select(torch.from_numpy(ids))
    np.testing.assert_array_equal(np.asarray(js.points_mask), ts.points_mask.numpy())
    np.testing.assert_allclose(np.asarray(js.diameters), ts.diameters.numpy(), rtol=1e-6)
    return np.asarray(js.points), ts.points.numpy()


CASES = {name[5:]: fn for name, fn in dict(globals()).items() if name.startswith("case_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax(name):
    j, t = CASES[name](np.random.RandomState(0))
    assert j.shape == t.shape
    assert np.isfinite(t).all()
    np.testing.assert_allclose(t, j, atol=1e-5, rtol=1e-5)


def test_loss_CO_symmetric_variants(loss_kw):
    """L1 and L2, with and without a points mask."""
    j, t = case_loss_CO_symmetric(np.random.RandomState(0), loss_kw)
    assert j.shape == t.shape
    np.testing.assert_allclose(t, j, atol=1e-5, rtol=1e-5)


def test_make_TCO_multiview_variants(multiview_kw):
    """Every view layout the predictor config can ask for."""
    j, t = case_make_TCO_multiview(np.random.RandomState(0), multiview_kw)
    assert j.shape == t.shape
    np.testing.assert_allclose(t, j, atol=1e-5, rtol=1e-5)
