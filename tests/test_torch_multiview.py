"""Multi-view scene reconstruction: the port's `multiview/` (RANSAC matching,
dense and Schur bundle adjustment, the scene predictor, `nms3d`),
`lib3d/camera.py::project_points` and `utils/colmap_io.py` against the JAX
package on the same numpy inputs.

Tolerances, each float32 arithmetic summed in another order:
- `project_points` 1e-5 px; `_sym_dist_pairs` 1e-6 m with the same symmetry
  chosen; `_align_targets` 1e-6 (a product of two poses once S* agrees).
- matching: component ids and view pairs equal, edges equal as sets (the
  greedy order of near-equal distances may differ), `TC1C2` within 1e-5.
- `_residuals` 1e-4 px; one dense LM step: parameters within 1e-5; the
  Schur blocks each within 1e-5 of the tensor's largest entry; the reduced
  solve on JAX's own blocks within 1e-4 of max |h|.
- `solve` (25 iterations, both solvers): loss within 1e-3 relative, poses
  within 1e-4 m and 1e-4 rad; LM's accept/reject turns an ulp into another
  branch, so one step is held tightly and the whole solve loosely.
- the scene predictor: object ids equal, poses within 1e-4.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as ScipyRot

import happypose_tpu.lib3d.camera as jcam
import happypose_tpu.lib3d.symmetries as jsym
import happypose_tpu.meshes.database as jdb
import happypose_tpu.meshes.io as jio
import happypose_tpu.multiview.bundle_adjustment as jba
import happypose_tpu.multiview.ransac as jransac
import happypose_tpu.multiview.scene_predictor as jsp
import happypose_tpu.utils.colmap_io as jcolmap
import happypose_tpu_torch.lib3d.camera as tcam
import happypose_tpu_torch.meshes.database as tdb
import happypose_tpu_torch.meshes.io as tio
import happypose_tpu_torch.multiview.bundle_adjustment as tba
import happypose_tpu_torch.multiview.ransac as transac
import happypose_tpu_torch.multiview.scene_predictor as tsp
import happypose_tpu_torch.utils.colmap_io as tcolmap
from happypose_tpu.lib3d.transforms import T_to_pose9d as j_T_to_pose9d
from happypose_tpu_torch.lib3d.transforms import pose9d_to_T

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _both_meshes(symmetric: bool, n_points=64):
    """The same mesh set in both packages, as `BatchedMeshes` of each; with
    `symmetric`, the sphere has a continuous z symmetry cut to 8 rotations
    and box_b its two-fold flip about z."""
    def meshes(io):
        return {
            "box_a": io.make_box_mesh((0.04, 0.03, 0.05)),
            "box_b": io.make_box_mesh((0.05, 0.05, 0.02)),
            "sphere": io.make_uv_sphere(radius=0.04, n_lat=10, n_lon=12),
        }

    syms = None
    if symmetric:
        flip = np.eye(4)
        flip[:2, :2] = -np.eye(2)
        syms = {
            "sphere": jsym.make_symmetries_poses(
                symmetries_continuous=[jsym.ContinuousSymmetry(offset=(0, 0, 0), axis=(0, 0, 1))],
                n_symmetries_continuous=8, units="m"),
            "box_b": jsym.make_symmetries_poses(
                symmetries_discrete=[jsym.DiscreteSymmetry(pose=flip)], units="m"),
        }
    j = jdb.MeshDataBase(meshes=meshes(jio), symmetries=syms).batched(n_points=n_points)
    t = tdb.MeshDataBase(meshes=meshes(tio), symmetries=syms).batched(
        n_points=n_points, device="cpu")
    for name in ("points", "points_mask", "symmetries", "symmetries_mask"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)))
    return j, t


def _scene(n_views=3, outlier=True, seed=0):
    """`tests/test_multiview.py::scene`'s construction: 3 objects, cameras on
    a small arc, every object in every view as gt + noise, and one garbage
    candidate of object 0's label."""
    rng = np.random.RandomState(seed)
    n_objects = 3
    TWO = np.tile(np.eye(4), (n_objects, 1, 1))
    TWO[:, :3, :3] = ScipyRot.random(n_objects, random_state=1).as_matrix()
    TWO[:, :3, 3] = rng.uniform(-0.1, 0.1, (n_objects, 3))
    TWC = np.tile(np.eye(4), (n_views, 1, 1))
    mid = (n_views - 1) / 2
    for v in range(n_views):
        TWC[v, :3, :3] = ScipyRot.from_euler("y", 0.15 * (v - mid)).as_matrix()
        TWC[v, :3, 3] = [0.1 * (v - mid), 0.0, -0.6]
    K = np.tile(np.eye(3, dtype=np.float32), (n_views, 1, 1))
    K[:, 0, 0] = K[:, 1, 1] = 400.0
    K[:, 0, 2] = 160.0
    K[:, 1, 2] = 120.0
    poses, view_ids, obj_ids = [], [], []
    for v in range(n_views):
        for o in range(n_objects):
            TCO = np.linalg.inv(TWC[v]) @ TWO[o]
            noise = np.eye(4)
            noise[:3, :3] = ScipyRot.from_rotvec(rng.normal(0, 0.01, 3)).as_matrix()
            noise[:3, 3] = rng.normal(0, 0.002, 3)
            poses.append(TCO @ noise)
            view_ids.append(v)
            obj_ids.append(o)
    if outlier:
        T_bad = np.eye(4)
        T_bad[:3, 3] = [0.5, 0.5, 2.0]
        poses.append(T_bad)
        view_ids.append(0)
        obj_ids.append(0)
    arrays = dict(poses=np.asarray(poses, np.float32), view_ids=np.asarray(view_ids),
                  obj_ids=np.asarray(obj_ids), scores=np.ones(len(poses), np.float32), K=K)
    return dict(TWO=TWO, TWC=TWC, K=K, cands_j=jransac.MultiviewCandidates(**arrays),
                cands_t=transac.MultiviewCandidates(**arrays))


@pytest.fixture(scope="module")
def meshes():
    return _both_meshes(symmetric=False)


@pytest.fixture(scope="module")
def sym_meshes():
    return _both_meshes(symmetric=True)


@pytest.fixture(scope="module")
def scene():
    return _scene()


# -------------------- project_points, symmetric distances --------------------


def test_project_points():
    rs = np.random.RandomState(0)
    pts = rs.randn(4, 50, 3).astype(np.float32) * 0.05
    TCO = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
    TCO[:, :3, :3] = ScipyRot.random(4, random_state=rs).as_matrix()
    TCO[:, :3, 3] = rs.randn(4, 3) * 0.05 + [0, 0, 0.5]
    K = np.tile(np.asarray([[500.0, 0, 320], [0, 510, 240], [0, 0, 1]], np.float32), (4, 1, 1))
    ref = np.asarray(jcam.project_points(jnp.asarray(pts), jnp.asarray(K), jnp.asarray(TCO)))
    out = tcam.project_points(_t(pts), _t(K), _t(TCO)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("symmetric", [False, True])
def test_sym_dist_pairs_and_best_symmetry(symmetric, meshes, sym_meshes):
    jm, tm = sym_meshes if symmetric else meshes
    rs = np.random.RandomState(3)
    B = 12
    ids = rs.randint(0, 3, B)
    T1 = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    T1[:, :3, :3] = ScipyRot.random(B, random_state=rs).as_matrix()
    T1[:, :3, 3] = rs.randn(B, 3) * 0.05 + [0, 0, 0.5]
    # T2: T1 under one of the object's symmetries, moved a little
    S_true = np.asarray(jm.symmetries)[ids, rs.randint(0, jm.symmetries.shape[1], B)]
    T2 = np.einsum("bij,bjk->bik", T1, S_true).astype(np.float32)
    T2[:, :3, 3] += rs.randn(B, 3).astype(np.float32) * 0.003
    ji, ti = jm.select(jnp.asarray(ids)), tm.select(torch.as_tensor(ids))
    jargs = (jnp.asarray(T1), jnp.asarray(T2), ji.points, ji.points_mask, ji.symmetries,
             ji.symmetries_mask)
    targs = (_t(T1), _t(T2), ti.points, ti.points_mask, ti.symmetries, ti.symmetries_mask)
    np.testing.assert_allclose(transac._sym_dist_pairs(*targs).numpy(),
                               np.asarray(jransac._sym_dist_pairs(*jargs)), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(transac._best_symmetry(*targs).numpy(),
                                  np.asarray(jransac._best_symmetry(*jargs)))


# -------------------- matching --------------------


def _assert_matches_equal(out, ref):
    np.testing.assert_array_equal(out["component_ids"], ref["component_ids"])
    assert out["view_pairs"] == ref["view_pairs"]
    assert {tuple(e) for e in out["edges"].tolist()} == {tuple(e) for e in ref["edges"].tolist()}
    assert len(out["edges"]) == len(ref["edges"])
    np.testing.assert_allclose(out["TC1C2"], ref["TC1C2"], atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", ["outlier", "symmetric", "known_TWC", "empty"])
def test_candidate_matching(case, scene, meshes, sym_meshes):
    jm, tm = sym_meshes if case == "symmetric" else meshes
    cands_j, cands_t = scene["cands_j"], scene["cands_t"]
    kw = dict(n_ransac_iter=30, dist_threshold=0.02, n_min_inliers=2, seed=0)
    if case == "known_TWC":
        kw = dict(dist_threshold=0.02, n_min_inliers=2, known_TWC=scene["TWC"])
    if case == "empty":  # one view: no view pair, no match
        keep = cands_j.view_ids == 0
        cands_j = jransac.MultiviewCandidates(
            cands_j.poses[keep], cands_j.view_ids[keep], cands_j.obj_ids[keep],
            cands_j.scores[keep])
        cands_t = transac.MultiviewCandidates(
            cands_t.poses[keep], cands_t.view_ids[keep], cands_t.obj_ids[keep],
            cands_t.scores[keep])
    ref = jransac.multiview_candidate_matching(cands_j, jm, **kw)
    out = transac.multiview_candidate_matching(cands_t, tm, **kw)
    _assert_matches_equal(out, ref)
    if case == "empty":
        assert (out["component_ids"] == -1).all() and out["TC1C2"].shape == (0, 4, 4)
    else:
        # the outlier is unmatched, the 9 true candidates are 3 components
        assert out["component_ids"][-1] == -1 and (out["component_ids"][:-1] >= 0).all()
        assert len(out["view_pairs"]) > 0


# -------------------- bundle adjustment --------------------


def _problem(meshes):
    """`tests/test_ba_schur.py`'s problem: 4 views, 3 objects, each seen in
    each view, gt + noise; the initial parameters 1 cm off in x."""
    jm, tm = meshes
    rng = np.random.RandomState(0)
    n_views, n_objects = 4, 3
    TWO = np.tile(np.eye(4), (n_objects, 1, 1))
    TWO[:, :3, :3] = ScipyRot.random(n_objects, random_state=1).as_matrix()
    TWO[:, :3, 3] = rng.uniform(-0.1, 0.1, (n_objects, 3))
    TWC = np.tile(np.eye(4), (n_views, 1, 1))
    for v in range(n_views):
        TWC[v, :3, :3] = ScipyRot.from_euler("y", 0.12 * (v - 1.5)).as_matrix()
        TWC[v, :3, 3] = [0.08 * (v - 1.5), 0.0, -0.6]
    K = np.tile(np.eye(3, dtype=np.float32), (n_views, 1, 1))
    K[:, 0, 0] = K[:, 1, 1] = 400.0
    K[:, 0, 2], K[:, 1, 2] = 160.0, 120.0
    poses, view_ids, obj_idx = [], [], []
    for v in range(n_views):
        for o in range(n_objects):
            TCO = np.linalg.inv(TWC[v]) @ TWO[o]
            noise = np.eye(4)
            noise[:3, :3] = ScipyRot.from_rotvec(rng.normal(0, 0.01, 3)).as_matrix()
            noise[:3, 3] = rng.normal(0, 0.002, 3)
            poses.append(TCO @ noise)
            view_ids.append(v)
            obj_idx.append(o)
    args = dict(cand_TCO=np.asarray(poses, np.float32), cand_view_idx=np.asarray(view_ids),
                cand_obj_idx=np.asarray(obj_idx), cand_obj_ids=np.asarray(obj_idx), K=K,
                n_points=8)
    TWO0 = TWO.astype(np.float32).copy()
    TWO0[:, 0, 3] += 0.01
    params = np.concatenate([
        np.asarray(j_T_to_pose9d(jnp.asarray(TWO0))).reshape(-1),
        np.asarray(j_T_to_pose9d(jnp.asarray(np.linalg.inv(TWC).astype(np.float32)))).reshape(-1),
    ])
    view_pairs = [(v, v + 1) for v in range(n_views - 1)]
    TC1C2 = np.stack([np.linalg.inv(TWC[a]) @ TWC[b] for a, b in view_pairs]).astype(np.float32)
    return dict(jm=jm, tm=tm, args=args, params=params, view_pairs=view_pairs, TC1C2=TC1C2,
                TWO=TWO, TWC=TWC)


@pytest.fixture(scope="module")
def problem(meshes):
    return _problem(meshes)


def _refiners(problem, solver):
    j = jba.MultiviewRefinement(meshes=problem["jm"], solver=solver, **problem["args"])
    t = tba.MultiviewRefinement(meshes=problem["tm"], solver=solver, device="cpu",
                                **problem["args"])
    return j, t


@pytest.fixture(scope="module")
def dense_pair(problem):
    return _refiners(problem, "dense")


@pytest.fixture(scope="module")
def schur_pair(problem):
    return _refiners(problem, "schur")


def _targets(pair, params):
    j, t = pair
    n = j.n_objects * 9
    jp = jnp.asarray(params)
    jt = j._align_targets(jp[:n].reshape(-1, 9), jp[n:].reshape(-1, 9))
    tp = _t(params)
    tt = t._align_targets(tp[:n].reshape(-1, 9), tp[n:].reshape(-1, 9))
    return jt, tt


def test_initialize_TWO_TWC(problem):
    a = problem["args"]
    for seed in range(3):
        ref = jba.initialize_TWO_TWC(4, 3, a["cand_view_idx"], a["cand_obj_idx"], a["cand_TCO"],
                                     problem["view_pairs"], problem["TC1C2"], seed=seed)
        out = tba.initialize_TWO_TWC(4, 3, a["cand_view_idx"], a["cand_obj_idx"], a["cand_TCO"],
                                     problem["view_pairs"], problem["TC1C2"], seed=seed)
        for o, r in zip(out, ref):
            np.testing.assert_array_equal(o, r)
    with pytest.raises(tba.SamplerError):
        tba.initialize_TWO_TWC(4, 3, a["cand_view_idx"], a["cand_obj_idx"], a["cand_TCO"],
                               problem["view_pairs"][:1], problem["TC1C2"][:1])


@pytest.mark.parametrize("symmetric", [False, True])
def test_align_targets_and_residuals(symmetric, problem, sym_meshes):
    """`_align_targets` within 1e-6, `_residuals` within 1e-4 px; with
    symmetries the aligned symmetry must be the same one."""
    if symmetric:
        jm, tm = sym_meshes
        pair = (jba.MultiviewRefinement(meshes=jm, **problem["args"]),
                tba.MultiviewRefinement(meshes=tm, device="cpu", **problem["args"]))
    else:
        pair = _refiners(problem, "dense")
    jt, tt = _targets(pair, problem["params"])
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-6, rtol=0)
    ref = np.asarray(pair[0]._residuals(jnp.asarray(problem["params"]), jt))
    out = pair[1]._residuals(_t(problem["params"]), tt).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)
    assert np.abs(ref).max() > 1.0  # the start is off: residuals are pixels, not zeros


LAMBDAS = [1e-3, 1.0, 1e2, 1e4, 1e6]  # LM's damping runs from 1e-8 to 1e6


def test_dense_jacobian(problem, dense_pair):
    """`torch.func.jacfwd` of the residuals against `jax.jacfwd`: within 1e-6
    of the largest entry (measured 1.5e-7)."""
    j, t = dense_pair
    jt, tt = _targets(dense_pair, problem["params"])
    ref = np.asarray(jax.jacfwd(j._residuals)(jnp.asarray(problem["params"]), jt))
    out = torch.func.jacfwd(t._residuals)(_t(problem["params"]), tt).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6 * np.abs(ref).max(), rtol=0)


def _poses(params):
    return pose9d_to_T(_t(np.asarray(params)).reshape(-1, 9)).numpy()


@pytest.mark.parametrize("lambd", LAMBDAS)
def test_dense_lm_step(lambd, problem, dense_pair):
    """One dense LM step. Its system is singular up to float32 noise: each
    9D pose has three directions that do not move the pose (the ortho6d
    scales and shear), and the gauge is fixed only after the solve. Where
    the damping is small those directions take noise over a near-zero
    pivot, in both packages alike: the parameters after the step differ by
    3.8 (lambda 1e-3) and 8.4e-4 (lambda 1), and the poses by 0.92 and
    8.4e-4. There the step is held by its loss and its accept/reject
    decision; from lambda 1e4 the parameters agree within 1e-5 (measured
    1.1e-6 and 6e-8)."""
    j, t = dense_pair
    jt, tt = _targets(dense_pair, problem["params"])
    jp, jl = j._lm_step(jnp.asarray(problem["params"]), jt, lambd, 25.0)
    tp, tl = t._lm_step(_t(problem["params"]), tt, lambd, 25.0)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    before = float(t._loss(_t(problem["params"]), tt, 25.0))
    assert (float(t._loss(tp, tt, 25.0)) < before) == (float(j._loss(jp, jt, 25.0)) < before)
    if lambd >= 1e4:
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5, rtol=0)
    # the gauge camera did not move
    n = 3 * 9
    np.testing.assert_array_equal(tp.numpy()[n:n + 9], problem["params"][n:n + 9])


def test_schur_blocks(problem, schur_pair):
    j, t = schur_pair
    jt, tt = _targets(schur_pair, problem["params"])
    ref = j._cand_blocks(jnp.asarray(problem["params"]), jt, j.o_idx, j.v_idx, j.cand_points,
                         j.cand_weight, 25.0)
    out = t._cand_blocks(_t(problem["params"]), tt, t.o_idx, t.v_idx, t.cand_points,
                         t.cand_weight, 25.0)
    for name, o, r in zip(("U", "V", "W", "b_o", "b_v", "loss_sum"), out, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(o.numpy(), r, atol=1e-5 * np.abs(r).max(), rtol=0,
                                   err_msg=name)


# poses after the Schur step on JAX's blocks (measured: 6.5e-4, 1.0e-4, 3.4e-7,
# 6.5e-7, 2.5e-6). At lambda <= 1 the scaled object blocks have eigenvalues
# within 3x of the truncation floor (1e-5 of the block's largest: 1.5e-5 to
# 2.4e-5 at lambda 1), so `eigh`'s last bits decide 1 / w of ~5e4
# along the ortho6d null directions; the raw step differs there by 64% and
# 9% of max |h|, and by 3.8e-4, 5.8e-5, 2.8e-4 of it at lambda 1e2 to 1e6.
SCHUR_POSE_ATOL = {1e-3: 1e-3, 1.0: 1e-3, 1e2: 1e-5, 1e4: 1e-5, 1e6: 1e-5}


@pytest.mark.parametrize("lambd", LAMBDAS)
def test_schur_reduce_solve_on_jax_blocks(lambd, problem, schur_pair):
    j, t = schur_pair
    jt, _ = _targets(schur_pair, problem["params"])
    blocks = j._cand_blocks(jnp.asarray(problem["params"]), jt, j.o_idx, j.v_idx,
                            j.cand_points, j.cand_weight, 25.0)[:5]
    ref = np.asarray(j._schur_reduce_solve(*blocks, lambd))
    out = t._schur_reduce_solve(*(_t(np.asarray(b)) for b in blocks), lambd).numpy()
    p = problem["params"]
    np.testing.assert_allclose(_poses(p + out), _poses(p + ref), atol=SCHUR_POSE_ATOL[lambd],
                               rtol=0)
    assert (out[27:36] == 0).all()  # the gauge block


def _rot_err(R1, R2):
    """Angle between rotations [..., 3, 3], from the chord in float64: an
    arccos of the trace loses everything below ~5e-4 rad in float32."""
    chord = np.linalg.norm(R1.astype(np.float64) - R2, axis=(-2, -1)) / (2 * np.sqrt(2))
    return 2 * np.arcsin(np.clip(chord, 0, 1))


def _assert_solves_agree(out, ref, loss_rtol, atol):
    np.testing.assert_allclose(out["loss"], ref["loss"], rtol=loss_rtol)
    for name in ("TWO", "TWC"):
        np.testing.assert_allclose(out[name][:, :3, 3], ref[name][:, :3, 3], atol=atol, rtol=0)
        assert _rot_err(out[name][:, :3, :3], ref[name][:, :3, :3]).max() < atol, name


@pytest.mark.parametrize("solver", ["dense", "schur"])
def test_solve_matches_jax(solver, problem, dense_pair, schur_pair):
    """25 iterations from `initialize_TWO_TWC`. Both packages step along
    +(J^T J)^-1 J^T e with e = target - model, uphill: on this problem
    every step of both is rejected and `solve` returns its start."""
    j, t = dense_pair if solver == "dense" else schur_pair
    ref = j.solve(problem["view_pairs"], problem["TC1C2"], n_iterations=25)
    out = t.solve(problem["view_pairs"], problem["TC1C2"], n_iterations=25)
    _assert_solves_agree(out, ref, 1e-3, 1e-4)
    assert out["loss"] < 5.0


def _descending(refiner, solver):
    """The refiner with its LM step turned to -(J^T J)^-1 J^T e."""
    step = refiner._lm_step if solver == "dense" else refiner._lm_step_schur

    def flipped(params, T_target, lambd, residuals_threshold):
        new, loss = step(params, T_target, lambd, residuals_threshold)
        return 2 * params - new, loss

    refiner.__dict__["_lm_step" if solver == "dense" else "_lm_step_schur"] = flipped
    return refiner


@pytest.mark.parametrize("solver", ["dense", "schur"])
def test_solve_with_descending_steps_matches_jax(solver, problem):
    """The accept branch (damping down, targets re-aligned) against JAX,
    with the step's sign turned in both packages so that steps descend
    (loss 1.554 -> 0.300). Schur: the same minimum, poses within 1e-5
    (measured 1.6e-6). Dense: the first step is noise along the singular
    directions (see `test_dense_lm_step`), so the two paths part at step
    1 and meet again near the minimum: loss within 1e-2 relative
    (measured 4.0e-3), poses within 2e-3 (measured 1.1e-3)."""
    j, t = (_descending(r, solver) for r in _refiners(problem, solver))
    ref = j.solve(problem["view_pairs"], problem["TC1C2"], n_iterations=25)
    out = t.solve(problem["view_pairs"], problem["TC1C2"], n_iterations=25)
    tol = (1e-4, 1e-5) if solver == "schur" else (1e-2, 2e-3)
    _assert_solves_agree(out, ref, *tol)
    assert out["loss"] < 0.31


def test_schur_sharded_is_not_ported(problem):
    """`schur_sharded` is ported (`tests/test_torch_parallel.py` holds it to
    JAX); without a mesh to split the candidates over, it refuses to run."""
    with pytest.raises(ValueError, match="needs a device_mesh"):
        tba.MultiviewRefinement(meshes=problem["tm"], solver="schur_sharded", device="cpu",
                                **problem["args"])


# -------------------- scene predictor, nms3d --------------------


@pytest.mark.parametrize("solver", ["dense", "schur"])
def test_predict_scene_state(solver, scene, meshes):
    jm, tm = meshes
    kw = dict(score_th=0.5, n_ransac_iter=30, dist_threshold=0.02, n_min_inliers=2,
              ba_n_iterations=25, ba_solver=solver)
    ref = jsp.MultiviewScenePredictor(jm, **kw).predict_scene_state(scene["cands_j"], scene["K"])
    out = tsp.MultiviewScenePredictor(tm, device="cpu", **kw).predict_scene_state(
        scene["cands_t"], scene["K"])
    np.testing.assert_array_equal(out.obj_ids, ref.obj_ids)
    np.testing.assert_array_equal(out.view_ids, ref.view_ids)
    np.testing.assert_array_equal(out.obj_scores, ref.obj_scores)
    np.testing.assert_allclose(out.TWO, ref.TWO, atol=1e-4, rtol=0)
    np.testing.assert_allclose(out.TWC, ref.TWC, atol=1e-4, rtol=0)
    np.testing.assert_allclose(out.ba_loss, ref.ba_loss, rtol=1e-3)
    pv, rv = out.predictions_per_view(), ref.predictions_per_view()
    assert sorted(pv) == sorted(rv) == [0, 1, 2]
    for v in pv:
        np.testing.assert_allclose(pv[v]["TCO"], rv[v]["TCO"], atol=1e-4, rtol=0)
        np.testing.assert_array_equal(pv[v]["obj_ids"], rv[v]["obj_ids"])


def test_predict_scene_state_nothing_matched(scene, meshes):
    """Every candidate under the score threshold: no scene."""
    out = tsp.MultiviewScenePredictor(meshes[1], score_th=2.0, device="cpu").predict_scene_state(
        scene["cands_t"], scene["K"])
    assert out is None


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nms3d(seed):
    rs = np.random.RandomState(seed)
    TWO = np.tile(np.eye(4), (12, 1, 1))
    TWO[:, :3, 3] = rs.rand(12, 3) * 0.1
    scores = rs.rand(12)
    scores[3] = scores[5]  # a tie
    for th in (0.02, 0.04):
        np.testing.assert_array_equal(tsp.nms3d(TWO, scores, th), jsp.nms3d(TWO, scores, th))


# -------------------- COLMAP text models --------------------


def _colmap_model(pkg, rs):
    cams = {1: pkg.Camera(1, "PINHOLE", 640, 480, np.asarray([600.0, 601.5, 320.25, 239.75])),
            2: pkg.Camera(2, "SIMPLE_PINHOLE", 320, 240, np.asarray([300.0, 160.0, 120.0]))}
    q = ScipyRot.random(2, random_state=rs).as_quat()[:, [3, 0, 1, 2]]
    images = {
        1: pkg.Image(1, q[0], rs.randn(3), 1, "000001.png", xys=rs.rand(3, 2) * 100,
                     point3D_ids=np.asarray([1, -1, 2])),
        2: pkg.Image(2, q[1], rs.randn(3), 2, "000002.png"),
    }
    points = {
        1: pkg.Point3D(1, rs.randn(3), np.asarray([255, 0, 12]), 0.5,
                       image_ids=np.asarray([1]), point2D_idxs=np.asarray([0])),
        2: pkg.Point3D(2, rs.randn(3), np.asarray([1, 2, 3])),
    }
    return cams, images, points


def test_colmap_write_read_against_jax(tmp_path):
    for pkg, name in ((jcolmap, "jax"), (tcolmap, "torch")):
        pkg.write_model(*_colmap_model(pkg, np.random.RandomState(0)), tmp_path / name)
    for f in ("cameras.txt", "images.txt", "points3D.txt"):
        assert (tmp_path / "torch" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
    # each package reads the other's files
    for reader, name in ((tcolmap, "jax"), (jcolmap, "torch")):
        cams, images, points = reader.read_model(tmp_path / name)
        ref = _colmap_model(reader, np.random.RandomState(0))
        assert sorted(cams) == [1, 2] and sorted(images) == [1, 2] and sorted(points) == [1, 2]
        for i in (1, 2):
            np.testing.assert_allclose(cams[i].params, ref[0][i].params, rtol=1e-11)
            np.testing.assert_allclose(images[i].TCW(), ref[1][i].TCW(), atol=1e-10)
            np.testing.assert_array_equal(images[i].point3D_ids, ref[1][i].point3D_ids)
            np.testing.assert_array_equal(points[i].image_ids, ref[2][i].image_ids)
        np.testing.assert_allclose(images[1].xys, ref[1][1].xys, rtol=1e-5)
