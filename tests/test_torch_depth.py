"""The depth refiners (ICP, GNC-TLS) of the port against JAX.

The deterministic pieces run on the same numpy inputs. `refine` draws a
random subsample, which the two libraries cannot share, so it is compared
at a resolution where `H * W == n_points`: the subsample is then a
permutation of all pixels, every sum runs over the same set, and the two
must agree whatever the noise. At a larger resolution the outcomes are
compared: both recover a perturbed pose. The JAX refiners render with the
two-pass `render_batch`; the port's get its own two-pass `render_batch`
(equal masks, depth to 1e-5: test_torch_rasterizer.py) as `renderer_fn`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import happypose_tpu.inference.icp_refiner as jicp
import happypose_tpu.inference.teaser_refiner as jteaser
import happypose_tpu_torch.inference.icp_refiner as ticp
import happypose_tpu_torch.inference.teaser_refiner as tteaser
from happypose_tpu.ops.rasterizer import render_batch as jax_render_batch
from happypose_tpu_torch.ops.rasterizer import render_batch
from test_torch_models import mesh_dbs

torch.set_num_threads(2)


def _K(f, H, W, n=None):
    K = np.asarray([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    return K if n is None else np.tile(K, (n, 1, 1))


def _rand_T(rs, rot_scale=0.3, t_scale=0.05):
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = Rotation.from_rotvec(rs.randn(3) * rot_scale).as_matrix()
    T[:3, 3] = rs.randn(3) * t_scale
    return T


def _depth_map(rs, H=16, W=32):
    """A smooth bumpy surface with a hole and a missing border column."""
    v, u = np.mgrid[:H, :W].astype(np.float32)
    depth = 0.5 + 0.03 * np.sin(u / 5.0) + 0.02 * np.cos(v / 3.0) + rs.rand(H, W) * 1e-3
    depth[4:7, 10:15] = 0.0
    depth[:, -1] = 0.0
    return depth.astype(np.float32)


def test_backproject_depth_and_normals():
    """Points, validity and normals of one depth map (and the same as a
    batch of one through the port's leading axes): 1e-6 on points, 1e-5 on
    unit normals, border wrap included."""
    rs = np.random.RandomState(0)
    depth, K = _depth_map(rs), _K(40.0, 16, 32)
    jp, jv = jicp.backproject_depth(jnp.asarray(depth), jnp.asarray(K))
    jn = jicp.depth_normals(jnp.asarray(depth), jnp.asarray(K))
    tp, tv = ticp.backproject_depth(torch.from_numpy(depth), torch.from_numpy(K))
    tn = ticp.depth_normals(torch.from_numpy(depth), torch.from_numpy(K))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-5, rtol=0)
    bp, bv = ticp.backproject_depth(torch.from_numpy(depth)[None], torch.from_numpy(K)[None])
    bn = ticp.depth_normals(torch.from_numpy(depth)[None], torch.from_numpy(K)[None])
    assert torch.equal(bp[0], tp) and torch.equal(bv[0], tv) and torch.equal(bn[0], tn)


def _icp_clouds(rs, n=200):
    """The target: a bumpy surface patch with its normals; the source: the
    same points moved by a small rigid offset; random validity on both."""
    depth, K = _depth_map(rs, 20, 20), _K(60.0, 20, 20)
    pts, valid = ticp.backproject_depth(torch.from_numpy(depth), torch.from_numpy(K))
    nrm = ticp.depth_normals(torch.from_numpy(depth), torch.from_numpy(K)).reshape(-1, 3)
    pick = rs.permutation(400)[:n]
    tgt, tv, tn = pts.numpy()[pick], valid.numpy()[pick] & (rs.rand(n) > 0.1), nrm.numpy()[pick]
    off = _rand_T(rs, rot_scale=0.03, t_scale=0.004)
    src = (pts.numpy()[rs.permutation(400)[:n]] - off[:3, 3]) @ off[:3, :3]
    return src.astype(np.float32), rs.rand(n) > 0.1, tgt, tn, tv, off


def test_icp_point_to_plane_matches_jax():
    """dT of 10 iterations on the same clouds, unbatched and as a batch of
    two: 1e-5 (ten 6x6 solves of sums over 200 points; measured 2e-7)."""
    rs = np.random.RandomState(1)
    cases = [_icp_clouds(rs) for _ in range(2)]
    outs = []
    for src, sv, tgt, tn, tv, off in cases:
        ref = np.asarray(jicp.icp_point_to_plane(
            *map(jnp.asarray, (src, sv, tgt, tn, tv)), max_corr_dist=0.02, n_iterations=10))
        out = ticp.icp_point_to_plane(
            *map(torch.from_numpy, (src, sv, tgt, tn, tv)), max_corr_dist=0.02, n_iterations=10)
        assert np.abs(ref - np.eye(4)).max() > 1e-3  # it moved
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)
        outs.append(out)
    batched = ticp.icp_point_to_plane(
        *(torch.from_numpy(np.stack(x)) for x in list(zip(*cases))[:5]),
        max_corr_dist=0.02, n_iterations=10)
    np.testing.assert_allclose(batched.numpy(), torch.stack(outs).numpy(), atol=1e-6, rtol=0)


def test_icp_without_correspondences_is_identity():
    """No valid pair: masked distances are inf, weights 0, the solve sees
    only its ridge, and the best iterate stays the identity in both."""
    rs = np.random.RandomState(2)
    src, sv, tgt, tn, tv, _ = _icp_clouds(rs, n=50)
    tv[:] = False
    ref = np.asarray(jicp.icp_point_to_plane(*map(jnp.asarray, (src, sv, tgt, tn, tv))))
    out = ticp.icp_point_to_plane(*map(torch.from_numpy, (src, sv, tgt, tn, tv))).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=1e-7)
    np.testing.assert_allclose(out, np.eye(4), atol=1e-7)


def test_weighted_procrustes_matches_jax():
    """R and t to 1e-5, with zero weights on corrupted pairs and a
    reflection case (a planar cloud, where det decides the third axis)."""
    rs = np.random.RandomState(3)
    src = rs.randn(3, 40, 3).astype(np.float32)
    src[2, :, 2] = 0.0  # planar
    T = np.stack([_rand_T(rs) for _ in range(3)])
    dst = np.einsum("bij,bnj->bni", T[:, :3, :3], src) + T[:, None, :3, 3]
    dst[:, :10] += 5.0
    w = np.r_[np.zeros(10), rs.rand(30) + 0.5].astype(np.float32)
    out_R, out_t = tteaser.weighted_procrustes(
        torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(w).expand(3, -1))
    for b in range(3):
        R, t = jteaser.weighted_procrustes(jnp.asarray(src[b]), jnp.asarray(dst[b]), jnp.asarray(w))
        np.testing.assert_allclose(out_R[b].numpy(), np.asarray(R), atol=1e-5, rtol=0)
        np.testing.assert_allclose(out_t[b].numpy(), np.asarray(t), atol=1e-5, rtol=0)
        np.testing.assert_allclose(out_R[b].numpy(), T[b, :3, :3], atol=1e-5)


@pytest.mark.parametrize("outliers", [0.0, 0.4])
def test_gnc_tls_registration_matches_jax(outliers):
    """Clean correspondences and 40% outliers with a validity mask: T to
    1e-5 (51 SVDs of 3x3 sums over 300 weighted points; U and Vt may differ
    in sign between the libraries, R does not), the inlier count equal."""
    rs = np.random.RandomState(4)
    n = 300
    src = rs.randn(n, 3).astype(np.float32) * 0.05
    T = _rand_T(rs, rot_scale=0.5)
    dst = src @ T[:3, :3].T + T[:3, 3] + rs.randn(n, 3).astype(np.float32) * 0.001
    n_out = int(n * outliers)
    dst[:n_out] = rs.randn(n_out, 3).astype(np.float32) * 0.2
    valid = rs.rand(n) > 0.1
    dst[~valid] = 99.0  # garbage, masked
    ref_T, ref_n = jteaser.gnc_tls_registration(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid), noise_bound=0.01)
    out_T, out_n = tteaser.gnc_tls_registration(
        torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(valid), noise_bound=0.01)
    np.testing.assert_allclose(out_T.numpy(), np.asarray(ref_T), atol=1e-5, rtol=0)
    assert int(out_n) == int(ref_n) >= valid[n_out:].sum() - 10
    assert np.abs(out_T.numpy()[:3, 3] - T[:3, 3]).max() < 5e-3


def test_farthest_point_sample_matches_jax():
    """The scan from JAX's own start (its random draw cannot be shared):
    every index equal, with invalid points, and with more samples asked for
    than valid points exist (the scan then repeats the first valid point;
    no inf - inf arises in either library)."""
    rs = np.random.RandomState(5)
    pts = rs.randn(60, 3).astype(np.float32)
    valid = rs.rand(60) > 0.5
    ref = np.asarray(jteaser.farthest_point_sample(
        jnp.asarray(pts), jnp.asarray(valid), 48, jax.random.PRNGKey(3)))
    out = tteaser._farthest_point_scan(
        torch.from_numpy(pts), torch.from_numpy(valid), 48, torch.tensor(int(ref[0]))).numpy()
    np.testing.assert_array_equal(out, ref)
    n_valid = int(valid.sum())
    assert n_valid < 48 and valid[out].all() and len(set(out[:n_valid])) == n_valid
    assert (out[n_valid:] == np.flatnonzero(valid)[0]).all()
    # the public function starts at a valid point and follows its generator
    g = torch.Generator().manual_seed(1)
    idx = tteaser.farthest_point_sample(
        torch.from_numpy(pts)[None], torch.from_numpy(valid)[None], 8, g)
    assert idx.shape == (1, 8) and valid[idx[0].numpy()].all()


def _scene(H, W, f, z=0.45):
    """Icosphere and box at seeded rotations, the observed depth rendered
    at the ground truth by each library's two-pass renderer, and the poses
    moved by about 1 cm."""
    jdb, tdb = mesh_dbs()
    rs = np.random.RandomState(6)
    T_gt = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    T_gt[:, :3, :3] = Rotation.random(2, random_state=rs).as_matrix()
    T_gt[:, :3, 3] = [[0.005, -0.003, z], [-0.004, 0.002, z]]
    ids = np.asarray([jdb.id_of("sphere"), jdb.id_of("box")])
    K = _K(f, H, W, 2)
    j_assets, t_assets = jdb.render_assets(), tdb.render_assets(device="cpu")
    j_obs = jax_render_batch(j_assets, jnp.asarray(ids), jnp.asarray(T_gt), jnp.asarray(K),
                             resolution=(H, W)).depth
    t_obs = render_batch(t_assets, torch.from_numpy(ids), torch.from_numpy(T_gt),
                         torch.from_numpy(K), resolution=(H, W)).depth
    np.testing.assert_allclose(t_obs.numpy(), np.asarray(j_obs), atol=1e-5)
    T0 = T_gt.copy()
    T0[:, :3, 3] += [[0.006, -0.004, 0.008], [-0.005, 0.006, 0.007]]
    return j_assets, t_assets, ids, K, T_gt, T0, j_obs, t_obs


def _refiners(name, j_assets, t_assets, **kw):
    jcls, tcls = {"icp": (jicp.ICPRefiner, ticp.ICPRefiner),
                  "teaser": (jteaser.TeaserRefiner, tteaser.TeaserRefiner)}[name]
    return jcls(j_assets, jax_render_batch, **kw), tcls(t_assets, render_batch, **kw)


@pytest.mark.parametrize("name, kw", [
    ("icp", dict(n_iterations=10, max_corr_dist=0.05)),
    ("teaser", dict(n_min_points=20, min_num_inliers=20)),
    ("teaser", dict(n_min_points=20, min_num_inliers=20, use_farthest_point_sampling=False)),
], ids=["icp", "teaser-fps", "teaser-random"])
def test_refine_matches_jax_when_every_pixel_is_sampled(name, kw):
    """`refine` at 16x32 with n_points = 512 = H * W. Tolerance 2e-5 m and
    2e-5 in rotation entries, not the 1e-5 of the pieces: the permuted
    order changes every float32 sum (ICP: 20 passes of 512-point sums
    feeding 6x6 solves whose updates compose ten times; measured 5e-6 for
    ICP, 4e-6 and 4e-7 for GNC-TLS). Both move the pose by 5-11 mm."""
    j_assets, t_assets, ids, K, T_gt, T0, j_obs, t_obs = _scene(16, 32, 70.0)
    jref, tref = _refiners(name, j_assets, t_assets, resolution=(16, 32), n_points=512, **kw)
    ref = np.asarray(jref.refine(jnp.asarray(ids), jnp.asarray(T0), jnp.asarray(K), j_obs,
                                 key=jax.random.PRNGKey(1)))
    out = tref.refine(torch.from_numpy(ids), torch.from_numpy(T0), torch.from_numpy(K), t_obs,
                      generator=torch.Generator().manual_seed(5)).numpy()
    moved = np.linalg.norm(ref[:, :3, 3] - T0[:, :3, 3], axis=-1)
    assert (moved > 2e-3).all(), moved
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=0)
    # a second generator state gives the same answer: the sample is all pixels
    again = tref.refine(torch.from_numpy(ids), torch.from_numpy(T0), torch.from_numpy(K), t_obs)
    np.testing.assert_allclose(again.numpy(), out, atol=2e-5, rtol=0)


@pytest.mark.parametrize("name, kw", [
    ("icp", dict(n_iterations=15, max_corr_dist=0.05)),
    ("teaser", dict(n_points=256, min_num_inliers=30, n_outer_iterations=3)),
])
def test_refine_recovers_a_perturbed_pose_as_jax_does(name, kw):
    """96x128, 512 (256) of 12,288 pixels sampled at random, differently in
    the two libraries: both cut the translation error of both objects (ICP
    to under half; GNC-TLS, whose same-pixel correspondences leave a
    residual on a rotated box, by a third in both libraries alike), and end
    within 2 mm of each other (the spread between two random samples)."""
    j_assets, t_assets, ids, K, T_gt, T0, j_obs, t_obs = _scene(96, 128, 160.0)
    jref, tref = _refiners(name, j_assets, t_assets, resolution=(96, 128), **kw)
    ref = np.asarray(jref.refine(jnp.asarray(ids), jnp.asarray(T0), jnp.asarray(K), j_obs))
    out = tref.refine(torch.from_numpy(ids), torch.from_numpy(T0), torch.from_numpy(K),
                      t_obs).numpy()
    err0 = np.linalg.norm(T0[:, :3, 3] - T_gt[:, :3, 3], axis=-1)
    err_j = np.linalg.norm(ref[:, :3, 3] - T_gt[:, :3, 3], axis=-1)
    err_t = np.linalg.norm(out[:, :3, 3] - T_gt[:, :3, 3], axis=-1)
    cut = 0.5 if name == "icp" else 0.7
    assert (err_j < cut * err0).all() and (err_t < cut * err0).all(), (err0, err_j, err_t)
    assert np.abs(out[:, :3, 3] - ref[:, :3, 3]).max() < 2e-3


def test_refiners_keep_the_pose_without_depth():
    """An empty observed depth: no correspondences, poses unchanged."""
    _, t_assets, ids, K, _, T0, _, _ = _scene(16, 32, 70.0)
    empty = torch.zeros(2, 16, 32)
    for cls in (ticp.ICPRefiner, tteaser.TeaserRefiner):
        out = cls(t_assets, render_batch, resolution=(16, 32)).refine(
            torch.from_numpy(ids), torch.from_numpy(T0), torch.from_numpy(K), empty)
        np.testing.assert_allclose(out.numpy(), T0, atol=1e-7)


# ----------------------------------------------------------------------
# The cut RGB-D pipeline: run_inference_pipeline with run_depth_refiner
# ----------------------------------------------------------------------

FRAME = (32, 48)  # 1536 depth pixels: every one is sampled (n_points = 1536)
RENDER = (64, 128)


def _rgbd_frame(tdb, seed=13):
    """Two boxes rendered by the port at seeded poses over noise (a
    uniformly coloured sphere's coarse logits tie across rotations, and
    which tied hypothesis wins is not the port's to decide); the depth
    image is the z-merge of the two; detections are the masks' boxes."""
    from happypose_tpu_torch.ops.rasterizer_fused import render_batch_fused

    H, W = FRAME
    K = _K(85.0, H, W)
    rs = np.random.RandomState(seed)
    TCO = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    TCO[:, :3, :3] = Rotation.random(2, random_state=rs).as_matrix()
    TCO[:, :3, 3] = [[-0.045, 0.01, 0.42], [0.045, -0.01, 0.40]]
    obj_ids = np.asarray([tdb.id_of("box"), tdb.id_of("box")])
    out = render_batch_fused(
        tdb.render_assets(device="cpu"), torch.from_numpy(obj_ids), torch.from_numpy(TCO),
        torch.from_numpy(np.stack([K, K])), resolution=FRAME,
    )
    rgb = rs.rand(H, W, 3).astype(np.float32) * 0.3
    depth = np.zeros((H, W), np.float32)
    boxes = []
    for i in range(2):
        m = out.mask[i].numpy()
        rgb[m] = out.rgb[i].numpy()[m]
        d = out.depth[i].numpy()
        depth = np.where(m & ((depth == 0) | (d < depth)), d, depth)
        ys, xs = np.nonzero(m)
        boxes.append([xs.min() - 1, ys.min() - 1, xs.max() + 1, ys.max() + 1])
    return rgb, depth, K, np.asarray(boxes, np.float32), obj_ids, TCO


def _to_numpy(est):
    import dataclasses

    if dataclasses.is_dataclass(est) and isinstance(est.poses, torch.Tensor):
        return {f.name: getattr(est, f.name).numpy() for f in dataclasses.fields(est)}
    return {f: np.asarray(getattr(est, f)) for f in est.__dataclass_fields__}


def _rgbd_estimators():
    """Both libraries' `megapose-RGB` cut to test size (64x128 renders, the
    72-rotation grid, top-2, 2 refiner iterations) with the same perturbed
    weights and `run_depth_refiner=True` (ICP). The refiner's pose head is
    perturbed by a twentieth of the other tests' amount: its updates stay
    small, so the poses stay where the autodepth init put them, within 1-2
    cm of the observed surface on this frame, and the depth refiners have a
    well-posed registration to solve."""
    import dataclasses

    from happypose_tpu.utils import load_model as jax_load_model
    from happypose_tpu_torch.utils import load_model as torch_load_model
    from happypose_tpu_torch.utils.weights_from_jax import pose_predictor_state_dict
    from test_torch_models import perturb

    def small(spec, **renderer):
        return dataclasses.replace(
            spec,
            refiner_cfg=dataclasses.replace(spec.refiner_cfg, render_size=RENDER, **renderer),
            coarse_cfg=dataclasses.replace(spec.coarse_cfg, render_size=RENDER, **renderer),
            inference_cfg=dataclasses.replace(
                spec.inference_cfg, SO3_grid_size=72, n_pose_hypotheses=2,
                n_refiner_iterations=2, run_depth_refiner=True, depth_refiner="icp",
            ),
        )

    jdb, tdb = mesh_dbs()
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_load_model.NAMED_MODELS, "megapose-RGBD-test",
                   small(jax_load_model.NAMED_MODELS["megapose-RGB"], renderer="reference"))
        mp.setitem(torch_load_model.NAMED_MODELS, "megapose-RGBD-test",
                   small(torch_load_model.NAMED_MODELS["megapose-RGB"]))
        jax_est = jax_load_model.load_named_model("megapose-RGBD-test", jdb, n_points=200)
        refiner_vars = perturb(jax_est.refiner_vars, seed=11)
        head = refiner_vars["params"]["pose_fc"]
        identity = np.asarray(jax_est.refiner_vars["params"]["pose_fc"]["bias"])
        head["kernel"] *= 0.05
        head["bias"] = identity + 0.05 * (head["bias"] - identity)
        coarse_vars = perturb(jax_est.coarse_vars, seed=12)
        jax_est.refiner_vars = jax.tree.map(jnp.asarray, refiner_vars)
        jax_est.coarse_vars = jax.tree.map(jnp.asarray, coarse_vars)
        est = torch_load_model.load_named_model(
            "megapose-RGBD-test", tdb, n_points=200, device="cpu",
            state_dicts={"refiner": pose_predictor_state_dict(refiner_vars),
                         "coarse": pose_predictor_state_dict(coarse_vars)},
        )
    return jax_est, est, tdb


@pytest.fixture(scope="module")
def rgbd_runs():
    """Both estimators of `_rgbd_estimators` on the same RGB-D frame. Each
    estimator's refiner cache is filled beforehand with refiners that
    sample all 1536 depth pixels, so the random subsample is a permutation.
    Then GNC-TLS (`depth_refiner="teaserpp"`) on the poses the ICP run
    started from."""
    import dataclasses

    from happypose_tpu.inference.types import DetectionBatch as JaxDetections
    from happypose_tpu.inference.types import ObservationBatch as JaxObservation
    from happypose_tpu_torch.inference.types import DetectionBatch, ObservationBatch
    from happypose_tpu_torch.ops.rasterizer_fused import render_batch_fused

    jax_est, est, tdb = _rgbd_estimators()
    rgb, depth, K, boxes, obj_ids, TCO_gt = _rgbd_frame(tdb)
    n_px = FRAME[0] * FRAME[1]
    for cls in (jicp.ICPRefiner, jteaser.TeaserRefiner):
        jax_est._depth_refiners[(cls, jax_render_batch, FRAME)] = cls(
            jax_est.assets, jax_render_batch, resolution=FRAME, n_points=n_px)
    for cls in (ticp.ICPRefiner, tteaser.TeaserRefiner):
        est._depth_refiners[(cls, FRAME)] = cls(
            est.assets, render_batch_fused, resolution=FRAME, n_points=n_px)

    j_obs = JaxObservation.from_numpy(rgb, K, depth=depth)
    t_obs = ObservationBatch.from_numpy(rgb, K, depth=depth, device="cpu")
    jax_res = jax_est.run_inference_pipeline(j_obs, JaxDetections.from_numpy(boxes, obj_ids))
    res = est.run_inference_pipeline(t_obs, DetectionBatch.from_numpy(boxes, obj_ids, device="cpu"))

    # GNC-TLS from the same starting poses: the top-1 of "scored"
    jax_est.cfg = dataclasses.replace(jax_est.cfg, depth_refiner="teaserpp")
    est.cfg = dataclasses.replace(est.cfg, depth_refiner="teaserpp")
    j_start = jax_est.filter_top_k(jax_res["scored"], by="pose_logits", k=1)
    t_start = est.filter_top_k(res["scored"], by="pose_logits", k=1)
    jax_res["teaserpp"] = jax_est.run_depth_refiner(j_obs, j_start)
    res["teaserpp"] = est.run_depth_refiner(t_obs, t_start)
    jax_res["start"], res["start"] = j_start, t_start
    return ({k: _to_numpy(v) for k, v in jax_res.items()},
            {k: _to_numpy(v) for k, v in res.items()}, TCO_gt)


@pytest.mark.parametrize("stage", ["depth_refined", "final", "teaserpp"])
def test_rgbd_pipeline_matches_jax(rgbd_runs, stage):
    """`results["depth_refined"]` and `["final"]` (ICP) and the GNC-TLS
    refinement of the same poses: the valid rows are JAX's hypotheses and
    their poses agree to 5e-5 m and 5e-5 in rotation entries (measured
    9e-6 for ICP, 1.9e-5 for GNC-TLS; the poses they start from agree to
    1e-7). Looser than the RGB pipeline's 1e-5: JAX's depth refiner renders
    with its two-pass renderer and the port's with the fused one (depth
    equal to 1e-5 on all but a few edge-on pixels, 2.4e-5 there), and the
    sums run in permuted order. Rows that are not valid do not move."""
    jax_res, res, _ = rgbd_runs
    j, t, start = jax_res[stage], res[stage], res["start"]
    assert t["valid"].sum() == j["valid"].sum() == 2
    assert (t["hypothesis_ids"][t["valid"]] == j["hypothesis_ids"][j["valid"]]).all()
    np.testing.assert_array_equal(t["poses"][~t["valid"]], start["poses"][~t["valid"]])
    np.testing.assert_allclose(t["poses"][t["valid"]], j["poses"][j["valid"]], atol=5e-5, rtol=0)
    if stage == "final":
        np.testing.assert_array_equal(t["poses"], res["depth_refined"]["poses"])


def test_rgbd_pipeline_depth_refiners_move_the_poses(rgbd_runs):
    """The comparison above is not of two no-ops: each refiner moves at
    least one detection's pose by more than a millimetre, and "scored" is
    what it started from."""
    _, res, _ = rgbd_runs
    start = res["start"]
    np.testing.assert_array_equal(start["poses"], res["scored"]["poses"])
    for stage in ("depth_refined", "teaserpp"):
        v = res[stage]["valid"]
        moved = np.linalg.norm(res[stage]["poses"][v][:, :3, 3] - start["poses"][v][:, :3, 3], axis=-1)
        assert moved.max() > 1e-3, (stage, moved)


def test_rgb_only_observation_skips_the_depth_refiner():
    """`run_depth_refiner=True` without observed depth: no "depth_refined"
    stage (the CosyPose flavour without a coarse model, identity-update
    weights, one iteration)."""
    from happypose_tpu_torch.inference.pose_estimator import PoseEstimator
    from happypose_tpu_torch.inference.types import (
        DetectionBatch,
        InferenceConfig,
        ObservationBatch,
    )
    from happypose_tpu_torch.models.pose_predictor import PosePredictor, PosePredictorConfig

    _, tdb = mesh_dbs()
    rgb, depth, K, boxes, obj_ids, TCO_gt = _rgbd_frame(tdb)
    model = PosePredictor(PosePredictorConfig(
        backbone="wide_resnet18", render_size=(32, 64), render_normals=False,
    )).init_weights(torch.Generator().manual_seed(0)).eval()
    est = PoseEstimator(
        model, None, tdb.render_assets(device="cpu"), tdb.batched(n_points=100, device="cpu"),
        InferenceConfig(n_refiner_iterations=1, run_depth_refiner=True, depth_refiner="teaserpp"),
    )
    det = DetectionBatch.from_numpy(boxes, obj_ids, device="cpu")
    res = est.run_inference_pipeline(ObservationBatch.from_numpy(rgb, K, device="cpu"), det)
    assert "depth_refined" not in res
    rgb_only = res["iteration=1"].poses
    # with depth, the CosyPose flavour refines too, toward the true depth
    res = est.run_inference_pipeline(
        ObservationBatch.from_numpy(rgb, K, depth=depth, device="cpu"), det)
    # an RGB model reads the RGB frame, whatever else the observation holds
    assert torch.equal(res["iteration=1"].poses, rgb_only)
    assert torch.equal(res["final"].poses, res["depth_refined"].poses)
    assert (type(next(iter(est._depth_refiners.values()))).__name__ == "TeaserRefiner"
            and len(est._depth_refiners) == 1)
    err0 = (res["iteration=1"].poses[:, 2, 3] - torch.from_numpy(TCO_gt[:, 2, 3])).abs()
    err1 = (res["final"].poses[:, 2, 3] - torch.from_numpy(TCO_gt[:, 2, 3])).abs()
    assert (err1 <= err0 + 1e-6).all() and (err1 < err0).any(), (err0, err1)
