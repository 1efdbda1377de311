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


# ------------------------------------------- exports and detection metrics
# numpy on both sides: the port's own copies must give what JAX's give

def _seeded_detections(rs, n_pred=40, n_gt=12, n_labels=3):
    """Boxes around shared centres, so that predictions overlap the GT, with
    scores drawn from a few values: ties everywhere."""
    centres = rs.uniform(20, 200, (n_gt, 2))
    size = rs.uniform(10, 40, (n_gt, 2))
    gt = np.concatenate([centres - size, centres + size], 1).astype(np.float32)
    pick = rs.randint(0, n_gt, n_pred)
    pred = (gt[pick] + rs.normal(0, 4, (n_pred, 4))).astype(np.float32)
    gt_labels = rs.randint(0, n_labels, n_gt)
    pred_labels = np.where(rs.rand(n_pred) < 0.8, gt_labels[pick], rs.randint(0, n_labels, n_pred))
    scores = rs.choice([0.9, 0.7, 0.5, 0.3], n_pred).astype(np.float32)
    return pred, pred_labels, scores, gt, gt_labels, rs.rand(n_gt).astype(np.float32)


@pytest.mark.parametrize("visib_gt_min", [-1.0, 0.3])
def test_detection_meter_matches_jax(visib_gt_min):
    import happypose_tpu.evaluation.detection_meters as jdm
    import happypose_tpu_torch.evaluation.detection_meters as tdm

    rs = np.random.RandomState(0)
    ours = tdm.DetectionMeter(iou_threshold=0.5, visib_gt_min=visib_gt_min)
    ref = jdm.DetectionMeter(iou_threshold=0.5, visib_gt_min=visib_gt_min)
    for image in range(4):
        args = _seeded_detections(rs)
        if image == 3:  # an image without predictions
            args = (np.zeros((0, 4), np.float32), np.zeros(0, int), np.zeros(0, np.float32)) + args[3:]
        ours.add(*args)
        ref.add(*args)
    a, b = ours.summary(), ref.summary()
    assert a == b and a["n_matched"] > 5 and 0.0 < a["mAP"] < 1.0
    np.testing.assert_array_equal(tdm.box_iou(args[3], args[3]), jdm.box_iou(args[3], args[3]))
    tp = rs.rand(30) < 0.5
    sc = rs.choice([0.9, 0.5], 30)
    assert tdm.average_precision(tp, sc, 20) == jdm.average_precision(tp, sc, 20)


def test_bop_csv_matches_jax(tmp_path):
    import happypose_tpu.evaluation.bop_export as jexp
    import happypose_tpu_torch.evaluation.bop_export as texp

    rs = np.random.RandomState(1)
    poses = _poses(rs, 6)
    args = (poses, rs.randint(1, 30, 6), rs.randint(0, 5, 6), rs.randint(0, 900, 6),
            rs.rand(6).astype(np.float32), rs.rand(6))
    texp.save_bop_csv(tmp_path / "t.csv", *args)
    jexp.save_bop_csv(tmp_path / "j.csv", *args)
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    assert texp.predictions_to_bop_csv(*args[:5]) == jexp.predictions_to_bop_csv(*args[:5])
    back, ref = texp.load_bop_csv(tmp_path / "j.csv"), jexp.load_bop_csv(tmp_path / "j.csv")
    assert sorted(back) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(back[k], ref[k], err_msg=k)
    # millimetres in the file, metres in memory
    np.testing.assert_allclose(back["poses"], poses, atol=1e-6)
    t_mm = np.fromstring((tmp_path / "t.csv").read_text().splitlines()[1].split(",")[5], sep=" ")
    np.testing.assert_allclose(t_mm, poses[0, :3, 3].astype(np.float64) * 1000.0, atol=1e-4)


def test_external_detections_match_jax(tmp_path):
    import json

    import happypose_tpu.evaluation.bop_export as jexp
    import happypose_tpu_torch.evaluation.bop_export as texp

    rs = np.random.RandomState(2)
    recs = [{"scene_id": int(s), "image_id": int(i), "category_id": int(c),
             "bbox": rs.uniform(0, 100, 4).round(2).tolist(),
             "score": float(rs.choice([0.9, 0.6, 0.6, 0.2]))}
            for s in (1, 2) for i in (0, 3) for c in rs.randint(1, 4, 6)]
    del recs[0]["score"]
    (tmp_path / "dets.json").write_text(json.dumps(recs))
    targets = [{"scene_id": s, "im_id": i, "obj_id": c, "inst_count": 1 + (c == 2)}
               for s in (1, 2) for i in (0, 3) for c in (1, 2)]
    (tmp_path / "targets.json").write_text(json.dumps(targets))
    ours, ref = (m.load_external_detections(tmp_path / "dets.json") for m in (texp, jexp))
    kept, kept_ref = (m.keep_best_detections(d, m.load_bop_targets(tmp_path / "targets.json"))
                      for m, d in ((texp, ours), (jexp, ref)))
    for a, b in ((ours, ref), (kept, kept_ref)):
        assert sorted(a) == sorted(b) and len(a) == 4
        for key in a:
            assert a[key]["labels"] == b[key]["labels"]
            np.testing.assert_array_equal(a[key]["boxes"], b[key]["boxes"])
            np.testing.assert_array_equal(a[key]["scores"], b[key]["scores"])
    assert all("obj_000003" not in d["labels"] and len(d["labels"]) <= 3 for d in kept.values())


def test_coco_export_matches_jax(tmp_path):
    import happypose_tpu.evaluation.coco_export as jcoco
    import happypose_tpu_torch.evaluation.coco_export as tcoco

    rs = np.random.RandomState(3)
    masks = rs.rand(5, 9, 7) > 0.5
    masks[0] = False
    masks[1] = True
    masks[2, 0, 0] = True  # a mask that starts with a 1: the RLE starts with a 0 count
    for m in masks:
        rle = tcoco.binary_mask_to_rle(m)
        assert rle == jcoco.binary_mask_to_rle(m)
        np.testing.assert_array_equal(tcoco.rle_to_binary_mask(rle), m)
        np.testing.assert_array_equal(jcoco.rle_to_binary_mask(rle), m)
    assert tcoco.binary_mask_to_rle(masks[2])["counts"][0] == 0
    args = (rs.uniform(0, 50, (5, 4)), rs.rand(5), rs.randint(1, 9, 5), np.full(5, 4), np.arange(5))
    for kw in ({}, {"masks": masks, "times": rs.rand(5)}):
        a, b = tcoco.detections_to_coco(*args, **kw), jcoco.detections_to_coco(*args, **kw)
        assert a == b
    tcoco.save_coco_json(tmp_path / "t.json", a)
    jcoco.save_coco_json(tmp_path / "j.json", b)
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    assert tcoco.load_coco_json(tmp_path / "j.json") == a
    np.testing.assert_array_equal(tcoco.rle_to_binary_mask(a[3]["segmentation"]), masks[3])


def test_visualizations_match_jax(tmp_path):
    """Overlays and the glTF export (numpy on both sides): equal arrays,
    equal bytes but for the generator's name."""
    import happypose_tpu.visualization as jviz
    import happypose_tpu.visualization.gltf_export as jgltf
    import happypose_tpu_torch.visualization as tviz
    import happypose_tpu_torch.visualization.gltf_export as tgltf

    rs = np.random.RandomState(4)
    rgb = rs.randint(0, 256, (30, 40, 3)).astype(np.uint8)
    mask = np.zeros((30, 40), bool)
    mask[8:20, 10:30] = True
    render = rs.rand(30, 40, 3).astype(np.float32)
    np.testing.assert_array_equal(tviz.make_contour_overlay(rgb, mask, dilate=2),
                                  jviz.make_contour_overlay(rgb, mask, dilate=2))
    np.testing.assert_array_equal(tviz.make_pose_overlay(rgb, render, mask),
                                  jviz.make_pose_overlay(rgb, render, mask))
    boxes = np.asarray([[3.0, 4, 20, 25], [10, 2, 38, 28]])
    np.testing.assert_array_equal(tviz.draw_boxes(rgb, boxes, labels=["a", "b"]),
                                  jviz.draw_boxes(rgb, boxes, labels=["a", "b"]))
    jdb, tdb = _dbs()
    poses = _poses(rs, 2)
    cams = _poses(rs, 1)
    tgltf.export_scene_glb(tmp_path / "t.glb", tdb, ["box", "sphere"], poses, camera_poses=cams)
    jgltf.export_scene_glb(tmp_path / "j.glb", jdb, ["box", "sphere"], poses, camera_poses=cams)
    a, b = (tmp_path / "t.glb").read_bytes(), (tmp_path / "j.glb").read_bytes()
    assert a[:4] == b[:4] == b"glTF"
    assert a.replace(b"happypose_tpu_torch", b"happypose_tpu") .split(b"BIN\x00")[1] == b.split(b"BIN\x00")[1]
