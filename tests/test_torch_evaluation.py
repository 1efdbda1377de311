"""Pose-error meters and BOP19 scoring: the port against JAX on the same
numpy inputs. Distances agree to 1e-5 (1e-6 where they are counts); the
host-side matching is the same numpy code, so matches and recalls are
equal. JAX renders VSD depth with its two-pass renderer, the port with the
fused one: the scene uses an icosphere and a box, on which the two agree
on every mask pixel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import happypose_tpu.evaluation.bop19 as jbop
import happypose_tpu.evaluation.meters as jmeters
import happypose_tpu_torch.evaluation.bop19 as tbop
import happypose_tpu_torch.evaluation.meters as tmeters
from happypose_tpu.meshes.database import MeshDataBase as JaxMeshDataBase
from happypose_tpu_torch.meshes.database import MeshDataBase
from happypose_tpu_torch.ops.rasterizer_fused import render_batch_fused
from test_torch_models import mesh_dbs

torch.set_num_threads(2)

H, W = 60, 80
N_POINTS = 60


def _dbs():
    """Icosphere and box; the box with its 180-degree symmetry about z."""
    jdb, tdb = mesh_dbs()
    sym = np.stack([np.eye(4), np.diag([-1.0, -1.0, 1.0, 1.0])])
    return (JaxMeshDataBase(jdb.meshes, symmetries={"box": sym}),
            MeshDataBase(tdb.meshes, symmetries={"box": sym}))


def _poses(rs, n, z=0.45):
    T = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    T[:, :3, :3] = Rotation.random(n, random_state=rs).as_matrix()
    T[:, :3, 3] = rs.randn(n, 3) * [0.04, 0.03, 0.02] + [0, 0, z]
    return T


def _moved(rs, T, t_scale, rot_scale):
    """T moved by per-row offsets of about `t_scale` metres and `rot_scale`
    radians."""
    out = T.copy()
    n = len(T)
    dR = Rotation.from_rotvec(rs.randn(n, 3) * np.reshape(rot_scale, (-1, 1))).as_matrix()
    out[:, :3, :3] = dR @ T[:, :3, :3]
    out[:, :3, 3] += rs.randn(n, 3) * np.reshape(t_scale, (-1, 1))
    return out.astype(np.float32)


def _pairs(rs, n=8):
    """n (estimate, GT) pairs over both objects; half of the box's
    estimates sit at the symmetric pose, so the symmetry decides."""
    jdb, tdb = _dbs()
    ids = np.arange(n) % 2
    gt = _poses(rs, n)
    pred = _moved(rs, gt, np.linspace(0.001, 0.03, n), np.linspace(0.01, 0.3, n))
    flip = np.diag([-1.0, -1.0, 1.0, 1.0]).astype(np.float32)
    box = tdb.id_of("box")
    for i in np.flatnonzero(ids == box)[::2]:
        pred[i] = pred[i] @ flip
    jb, tb = jdb.batched(n_points=N_POINTS), tdb.batched(n_points=N_POINTS, device="cpu")
    return (jb.select(jnp.asarray(ids)), tb.select(torch.from_numpy(ids)), ids, pred, gt, box)


def test_pose_errors_batch_matches_jax():
    """ADD (min over the symmetries), ADD-S, translation error to 1e-6 m,
    rotation error to 1e-3 degrees (arccos near 1 in float32)."""
    rs = np.random.RandomState(0)
    ji, ti, ids, pred, gt, box = _pairs(rs)
    ref = jmeters.pose_errors_batch(jnp.asarray(pred), jnp.asarray(gt), ji.points, ji.points_mask,
                                    ji.symmetries, ji.symmetries_mask)
    out = tmeters.pose_errors_batch(torch.from_numpy(pred), torch.from_numpy(gt), ti.points,
                                    ti.points_mask, ti.symmetries, ti.symmetries_mask)
    assert sorted(out) == sorted(ref) == ["ADD", "ADD-S", "rot_err_deg", "trans_err"]
    for k in ("ADD", "ADD-S", "trans_err"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=1e-6, rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(out["rot_err_deg"].numpy(), np.asarray(ref["rot_err_deg"]), atol=1e-3)
    # the flipped box estimates were scored at the symmetric pose
    flipped = np.flatnonzero(ids == box)[::2]
    assert (out["ADD"].numpy()[flipped] < 0.03).all()
    assert (out["rot_err_deg"].numpy()[flipped] > 150).all()


def test_compute_auc_posecnn_and_match_poses_match_jax():
    rs = np.random.RandomState(1)
    for errors in (rs.rand(40) * 0.15, np.asarray([0.2, 0.3]), np.zeros(0),
                   np.r_[rs.rand(10) * 0.05, np.inf, np.inf]):
        a, b = jmeters.compute_auc_posecnn(errors), tmeters.compute_auc_posecnn(errors)
        assert (np.isnan(a) and np.isnan(b)) or a == pytest.approx(b, abs=1e-12)
    pred_keys = np.stack([rs.randint(0, 2, 12), rs.randint(0, 3, 12)], 1)
    gt_keys = np.stack([rs.randint(0, 2, 9), rs.randint(0, 3, 9)], 1)
    scores = rs.randint(0, 4, 12).astype(np.float32)  # ties
    errors = rs.rand(12, 9)
    errors[rs.rand(12, 9) < 0.3] = np.inf
    ref = jmeters.match_poses(pred_keys, gt_keys, scores, errors)
    out = tmeters.match_poses(pred_keys, gt_keys, scores, errors)
    assert out == ref and len(out) >= 3


def _scene(rs):
    """Two images: GT instances (sphere, box, box / sphere, box), estimates
    = the GT moved by 1 mm to 4 cm, one of them flipped to the box's
    symmetric pose, plus a spurious box estimate; the test depth is the
    z-merge of the GT renders, with a hole."""
    jdb, tdb = _dbs()
    sphere, box = tdb.id_of("sphere"), tdb.id_of("box")
    K = np.asarray([[100.0, 0, W / 2], [0, 100.0, H / 2], [0, 0, 1]], np.float32)
    assets = tdb.render_assets(device="cpu")
    images = []
    for gt_ids, centres in (
        ([sphere, box, box], [[-0.1, 0.0, 0.45], [0.02, 0.03, 0.42], [0.12, -0.04, 0.5]]),
        ([sphere, box], [[0.06, 0.02, 0.4], [-0.07, -0.03, 0.47]]),
    ):
        gt_ids = np.asarray(gt_ids)
        gt = _poses(rs, len(gt_ids))
        gt[:, :3, 3] = centres
        pred = _moved(rs, gt, np.geomspace(0.001, 0.04, len(gt)), np.geomspace(0.01, 0.4, len(gt)))
        pred[1] = pred[1] @ np.diag([-1.0, -1.0, 1.0, 1.0]).astype(np.float32)
        extra = _poses(rs, 1)
        pred = np.concatenate([pred, extra])
        pred_ids = np.r_[gt_ids, box]
        scores = rs.rand(len(pred)).astype(np.float32)
        out = render_batch_fused(assets, torch.from_numpy(gt_ids), torch.from_numpy(gt),
                                 torch.from_numpy(K).expand(len(gt), 3, 3), resolution=(H, W))
        depth = np.zeros((H, W), np.float32)
        for d, m in zip(out.depth.numpy(), out.mask.numpy()):
            assert m.sum() > 40
            depth = np.where(m & ((depth == 0) | (d < depth)), d, depth)
        depth[25:30, 30:50] = 0.0
        visib = np.ones(len(gt), np.float32)
        visib[-1] = 0.05  # barely visible: matches to it score nothing
        images.append(dict(TCO_pred=pred, pred_obj_ids=pred_ids, pred_scores=scores, TCO_gt=gt,
                           gt_obj_ids=gt_ids, K=K, gt_visib_fract=visib, depth_test=depth))
    return jdb, tdb, images


def test_pose_error_meter_summary_matches_jax():
    """`PoseErrorMeter` over two images, ADD-S for the box: the same matches
    (counts equal), every summary value to 1e-5."""
    rs = np.random.RandomState(2)
    jdb, tdb, images = _scene(rs)
    jm = jmeters.PoseErrorMeter(jdb.batched(n_points=N_POINTS), is_symmetric=np.asarray([True, False]))
    tm = tmeters.PoseErrorMeter(tdb.batched(n_points=N_POINTS, device="cpu"),
                                is_symmetric=np.asarray([True, False]))
    assert tm.summary() == {"n_matched": 0, "n_gt": 0}
    for g, im in enumerate(images):
        args = (im["TCO_pred"], im["pred_obj_ids"], im["pred_scores"],
                np.full(len(im["TCO_pred"]), g), im["TCO_gt"], im["gt_obj_ids"],
                np.full(len(im["TCO_gt"]), g))
        jm.add(*args)
        tm.add(*args)
    ref, out = jm.summary(), tm.summary()
    assert sorted(out) == sorted(ref)
    assert out["n_matched"] == ref["n_matched"] >= 4 and out["n_gt"] == ref["n_gt"] == 5
    for k in ref:
        assert out[k] == pytest.approx(ref[k], abs=1e-5, rel=1e-5), k
    assert 0 < out["ADD(-S)<0.1d"] < 1


def test_mssd_mspd_batch_matches_jax():
    """MSSD to 1e-6 m, MSPD to 1e-3 px (coordinates of ~50 px in float32),
    the symmetric object's flipped estimates scored at the symmetric pose."""
    rs = np.random.RandomState(3)
    ji, ti, ids, pred, gt, box = _pairs(rs)
    K = np.tile(np.asarray([[100.0, 0, W / 2], [0, 100.0, H / 2], [0, 0, 1]], np.float32), (8, 1, 1))
    ref = jbop.mssd_mspd_batch(jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(K), ji.points,
                               ji.points_mask, ji.symmetries, ji.symmetries_mask)
    out = tbop.mssd_mspd_batch(torch.from_numpy(pred), torch.from_numpy(gt), torch.from_numpy(K),
                               ti.points, ti.points_mask, ti.symmetries, ti.symmetries_mask)
    np.testing.assert_allclose(out["mssd"].numpy(), np.asarray(ref["mssd"]), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(out["mspd"].numpy(), np.asarray(ref["mspd"]), atol=1e-3, rtol=1e-5)
    flipped = np.flatnonzero(ids == box)[::2]
    assert (out["mssd"].numpy()[flipped] < 0.06).all()


def test_vsd_from_depths_matches_jax():
    """The same depth arrays (rendered estimate and GT, a test depth with
    holes and an occluder) through both: pixel counts are exact, so the
    errors agree to 1e-6; the empty-union case gives 1."""
    rs = np.random.RandomState(4)
    jdb, tdb, images = _scene(rs)
    im = images[0]
    n = len(im["TCO_gt"])
    assets = tdb.render_assets(device="cpu")
    Kb = torch.from_numpy(im["K"]).expand(n, 3, 3).contiguous()
    ids = torch.from_numpy(im["gt_obj_ids"])
    d_est = render_batch_fused(assets, ids, torch.from_numpy(im["TCO_pred"][:n]), Kb,
                               resolution=(H, W)).depth.numpy()
    d_gt = render_batch_fused(assets, ids, torch.from_numpy(im["TCO_gt"]), Kb,
                              resolution=(H, W)).depth.numpy()
    d_test = np.tile(im["depth_test"], (n, 1, 1))
    d_test[:, 20:40, 35:45] = 0.3  # an occluder in front
    d_est[2] = 0.0  # nothing rendered, and
    d_gt[2] = 0.0  # nothing visible: union empty
    taus = (np.asarray(tbop.VSD_TAUS, np.float32)[None] * np.asarray([[0.1], [0.12], [0.12]])
            ).astype(np.float32)
    ref = np.asarray(jbop._vsd_from_depths(*map(jnp.asarray, (d_est, d_gt, d_test, Kb.numpy(), taus))))
    out = tbop._vsd_from_depths(*map(torch.from_numpy, (d_est, d_gt, d_test, Kb.numpy(), taus))).numpy()
    assert out.shape == (n, 10) and (out[2] == 1.0).all()
    assert 0 < out[0].min() and (np.diff(out[:2], axis=1) <= 0).all() and out[:2].min() < 1
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("resolution", [None, (30, 40)])
def test_vsd_batch_matches_jax(resolution):
    """`vsd_batch` end to end (render, visibility, discrepancy), at the
    frame's resolution and rescaled to half of it. JAX renders with its
    two-pass renderer, the port with the fused one; on this scene they
    agree on every mask pixel, and depths within 2.4e-5 move no pixel
    across a tau of >= 5 mm, so the errors agree to 1e-6."""
    rs = np.random.RandomState(4)
    jdb, tdb, images = _scene(rs)
    im = images[0]
    n = len(im["TCO_gt"])
    diam = tdb.batched(n_points=N_POINTS, device="cpu").diameters.numpy()[im["gt_obj_ids"]]
    args = (im["TCO_pred"][:n], im["TCO_gt"], im["gt_obj_ids"], np.tile(im["K"], (n, 1, 1)),
            np.tile(im["depth_test"], (n, 1, 1)))
    ref = jbop.vsd_batch(*args, jdb.render_assets(), diam, resolution=resolution)
    out = tbop.vsd_batch(*args, tdb.render_assets(device="cpu"), diam, resolution=resolution)
    assert out.shape == (n, 10) and 0 < out.min() and out.max() <= 1
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


def _evaluate(module, meshes, assets, images, with_depth=True):
    ev = module.Bop19Evaluator(meshes=meshes, assets=assets)
    for im in images:
        kw = dict(im)
        if not with_depth:
            kw.pop("depth_test")
        ev.add_image(**kw, im_width=W)
    return ev


def _threshold_gaps(ev, diam_by_id, images):
    """The smallest distance of any finite pairwise error from a threshold
    it is compared with, over all images: recalls are decided when it
    exceeds the error tolerance. Recomputed here from the port's errors."""
    gaps = []
    for im in images:
        n_est, n_gt = len(im["TCO_pred"]), len(im["TCO_gt"])
        pi, gi = np.meshgrid(np.arange(n_est), np.arange(n_gt), indexing="ij")
        same = im["pred_obj_ids"][pi.ravel()] == im["gt_obj_ids"][gi.ravel()]
        p, g = pi.ravel()[same], gi.ravel()[same]
        ids = im["gt_obj_ids"][g]
        inst = ev.meshes.select(torch.from_numpy(ids))
        K = torch.from_numpy(im["K"]).expand(len(p), 3, 3)
        e = tbop.mssd_mspd_batch(torch.from_numpy(im["TCO_pred"][p]), torch.from_numpy(im["TCO_gt"][g]),
                                 K, inst.points, inst.points_mask, inst.symmetries,
                                 inst.symmetries_mask)
        d = diam_by_id[ids]
        ths = np.asarray(tbop.CORRECTNESS_THS)
        gaps.append(np.abs(e["mssd"].numpy()[:, None] - ths[None] * d[:, None]).min())
        gaps.append(np.abs(e["mspd"].numpy()[:, None] - np.asarray(tbop.MSPD_THS)[None] * W / 640).min())
        vsd = tbop.vsd_batch(im["TCO_pred"][p], im["TCO_gt"][g], ids, K.numpy(),
                             np.tile(im["depth_test"], (len(p), 1, 1)), ev.assets, d)
        gaps.append(np.abs(vsd[:, :, None] - ths[None, None]).min())
    return min(gaps)


def test_bop19_evaluator_summary_matches_jax():
    """`Bop19Evaluator` over two images with estimates from 1 mm to 4 cm
    off, a symmetric-pose estimate, a spurious one, a barely visible GT and
    an image without estimates: AR_VSD, AR_MSSD, AR_MSPD and their mean
    are equal to JAX's (recalls are ratios of match counts). First: no
    pairwise error sits within 1e-4 of a threshold it is compared with, so
    the matches are decided beyond the error tolerances above."""
    rs = np.random.RandomState(5)
    jdb, tdb, images = _scene(rs)
    empty = dict(images[1], TCO_pred=np.zeros((0, 4, 4), np.float32),
                 pred_obj_ids=np.zeros(0, int), pred_scores=np.zeros(0, np.float32))
    images = images + [empty]
    tb = tdb.batched(n_points=N_POINTS, device="cpu")
    tev = _evaluate(tbop, tb, tdb.render_assets(device="cpu"), images)
    jev = _evaluate(jbop, jdb.batched(n_points=N_POINTS), jdb.render_assets(), images)
    assert _threshold_gaps(tev, tb.diameters.numpy(), images[:2]) > 1e-4
    ref, out = jev.summary(), tev.summary()
    assert sorted(out) == sorted(ref) == ["AR_MSPD", "AR_MSSD", "AR_VSD", "bop19_AR"]
    for k in ref:
        assert out[k] == pytest.approx(ref[k], abs=1e-9), (k, out, ref)
        assert 0 < out[k] < 1
    for name in ("vsd", "mssd", "mspd"):
        for a, b in zip(tev._tallies[name], jev._tallies[name]):
            np.testing.assert_array_equal(a, b)
    assert tev._tallies["vsd"][0].shape == (100, 2) and tev._tallies["vsd"][2][:, 0].sum() == 0


def test_bop19_without_depth_skips_vsd_and_ground_truth_scores_one():
    """Without a test depth AR is the mean of the MSSD and MSPD recalls, as
    in JAX; the ground-truth poses as estimates score AR = 1 with VSD."""
    rs = np.random.RandomState(5)
    jdb, tdb, images = _scene(rs)
    tb, assets = tdb.batched(n_points=N_POINTS, device="cpu"), tdb.render_assets(device="cpu")
    out = _evaluate(tbop, tb, assets, images, with_depth=False).summary()
    ref = _evaluate(jbop, jdb.batched(n_points=N_POINTS), jdb.render_assets(), images,
                    with_depth=False).summary()
    assert sorted(out) == sorted(ref) == ["AR_MSPD", "AR_MSSD", "bop19_AR"]
    assert all(out[k] == pytest.approx(ref[k], abs=1e-9) for k in ref)
    perfect = [dict(im, TCO_pred=im["TCO_gt"], pred_obj_ids=im["gt_obj_ids"],
                    pred_scores=np.ones(len(im["TCO_gt"]), np.float32)) for im in images]
    assert _evaluate(tbop, tb, assets, perfect).summary() == {
        "AR_VSD": 1.0, "AR_MSSD": 1.0, "AR_MSPD": 1.0, "bop19_AR": 1.0}
