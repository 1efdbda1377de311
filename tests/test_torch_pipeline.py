"""The slice as a whole: MegaPose single-view inference, port against JAX.

Both sides load the `megapose-RGB` spec cut to test size (64x128 renders,
the shipped 72-rotation grid, 2 detections, top-2, 2 refiner iterations)
through their own `load_named_model`, with the same perturbed weights (the
JAX variables carried over by `weights_from_jax`), on the same synthetic
frame. The JAX renders go through the Pallas kernel in interpret mode; the
port's run on the CPU through the CUDA kernel's plain version.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from happypose_tpu.inference.types import DetectionBatch as JaxDetections
from happypose_tpu.inference.types import ObservationBatch as JaxObservation
from happypose_tpu.utils import load_model as jax_load_model
from happypose_tpu_torch.inference.types import DetectionBatch, ObservationBatch
from happypose_tpu_torch.ops.rasterizer_fused import render_batch_fused
from happypose_tpu_torch.utils import load_model as torch_load_model
from happypose_tpu_torch.utils.weights_from_jax import pose_predictor_state_dict
from test_torch_models import mesh_dbs, perturb

torch.set_num_threads(2)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

RENDER = (64, 128)
FRAME = (120, 160)
N_HYP, N_ITER, GRID = 2, 2, 72
# Measured on the CPU: logits agree to 2e-6 and poses to 2e-7; the
# tolerances leave 10x for other thread counts and summation orders.
LOGIT_TOL = 2e-5


def _frame(tdb):
    """A synthetic frame: the icosphere and the box, rendered by the port's
    renderer at seeded poses over a noise background, with their mask
    boxes as detections."""
    H, W = FRAME
    K = np.asarray([[180.0, 0, W / 2], [0, 180.0, H / 2], [0, 0, 1]], np.float32)
    rs = np.random.RandomState(7)
    TCO = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    TCO[:, :3, :3] = Rotation.random(2, random_state=rs).as_matrix()
    TCO[:, :3, 3] = [[-0.06, 0.01, 0.6], [0.06, -0.02, 0.55]]
    obj_ids = np.asarray([tdb.id_of("sphere"), tdb.id_of("box")])
    out = render_batch_fused(
        tdb.render_assets(device="cpu"), torch.from_numpy(obj_ids), torch.from_numpy(TCO),
        torch.from_numpy(np.stack([K, K])), resolution=FRAME,
    )
    rgb = rs.rand(H, W, 3).astype(np.float32) * 0.3
    boxes = []
    for i in range(2):
        m = out.mask[i].numpy()
        rgb[m] = out.rgb[i].numpy()[m]
        ys, xs = np.nonzero(m)
        boxes.append([xs.min() - 2, ys.min() - 2, xs.max() + 2, ys.max() + 2])
    return rgb, K, np.asarray(boxes, np.float32), obj_ids


def _small(spec, **renderer):
    return dataclasses.replace(
        spec,
        refiner_cfg=dataclasses.replace(spec.refiner_cfg, render_size=RENDER, **renderer),
        coarse_cfg=dataclasses.replace(spec.coarse_cfg, render_size=RENDER, **renderer),
        inference_cfg=dataclasses.replace(
            spec.inference_cfg, SO3_grid_size=GRID, n_pose_hypotheses=N_HYP,
            n_refiner_iterations=N_ITER,
        ),
    )


@pytest.fixture(scope="module")
def runs():
    jdb, tdb = mesh_dbs()
    rgb, K, boxes, obj_ids = _frame(tdb)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_load_model.NAMED_MODELS, "megapose-RGB-test",
                   _small(jax_load_model.NAMED_MODELS["megapose-RGB"],
                          renderer="pallas_interpret"))
        mp.setitem(torch_load_model.NAMED_MODELS, "megapose-RGB-test",
                   _small(torch_load_model.NAMED_MODELS["megapose-RGB"]))

        jax_est = jax_load_model.load_named_model("megapose-RGB-test", jdb, n_points=200)
        refiner_vars = perturb(jax_est.refiner_vars, seed=11)
        coarse_vars = perturb(jax_est.coarse_vars, seed=12)
        jax_est.refiner_vars = jax.tree.map(jnp.asarray, refiner_vars)
        jax_est.coarse_vars = jax.tree.map(jnp.asarray, coarse_vars)
        jax_res = jax_est.run_inference_pipeline(
            JaxObservation.from_numpy(rgb, K), JaxDetections.from_numpy(boxes, obj_ids)
        )

        est = torch_load_model.load_named_model(
            "megapose-RGB-test", tdb, n_points=200,
            state_dicts={"refiner": pose_predictor_state_dict(refiner_vars),
                         "coarse": pose_predictor_state_dict(coarse_vars)},
            device="cpu",
        )
        res = est.run_inference_pipeline(
            ObservationBatch.from_numpy(rgb, K, device="cpu"),
            DetectionBatch.from_numpy(boxes, obj_ids, device="cpu"),
        )
    jax_res = {k: jax.tree.map(np.asarray, v) for k, v in jax_res.items()}
    res = {k: {f.name: getattr(v, f.name).numpy() for f in dataclasses.fields(v)}
           for k, v in res.items()}
    return jax_res, res


def _rows(est, keys=("instance_ids", "obj_ids", "hypothesis_ids")):
    """Row order by (detection, hypothesis), for comparing stage outputs
    whose row order depends on near-equal logits."""
    get = est.get if isinstance(est, dict) else lambda k: getattr(est, k)
    return np.lexsort([get(k) for k in reversed(keys)])


def test_coarse_logits(runs):
    jax_res, res = runs
    j, t = jax_res["coarse"], res["coarse"]
    assert t["coarse_logits"].shape == (2 * GRID,)
    np.testing.assert_allclose(t["poses"], j.poses, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(t["coarse_logits"], j.coarse_logits, atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_top_k_hypotheses(runs):
    """The kept hypotheses per detection are JAX's. First: the gap at the
    K-th logit exceeds twice the logit tolerance, so the set is decided."""
    jax_res, res = runs
    j = jax_res["coarse"]
    logits = j.coarse_logits.reshape(2, GRID)
    top = np.sort(logits, axis=1)[:, ::-1]
    assert (top[:, N_HYP - 1] - top[:, N_HYP] > 2 * LOGIT_TOL).all()
    for name in ("iteration=1", "scored"):
        jr, tr = jax_res[name], res[name]
        jsets = sorted(zip(jr.obj_ids[jr.valid].tolist(), jr.hypothesis_ids[jr.valid].tolist()))
        tsets = sorted(zip(tr["obj_ids"][tr["valid"]].tolist(),
                           tr["hypothesis_ids"][tr["valid"]].tolist()))
        assert jsets == tsets and len(tsets) == 2 * N_HYP


@pytest.mark.parametrize("iteration", range(1, N_ITER + 1))
def test_refiner_iterations(runs, iteration):
    """Poses after each refiner iteration, row by row: 2e-6 m and 2e-6 in
    rotation entries."""
    jax_res, res = runs
    j, t = jax_res[f"iteration={iteration}"], res[f"iteration={iteration}"]
    jo, to = _rows(j), _rows(t)
    assert (j.hypothesis_ids[jo] == t["hypothesis_ids"][to]).all()
    # the perturbed head really moves the poses (by ~0.1 on this frame)
    c = res["coarse"]
    before = np.stack([
        c["poses"][(c["obj_ids"] == o) & (c["hypothesis_ids"] == h)][0]
        for o, h in zip(t["obj_ids"][to], t["hypothesis_ids"][to])
    ]) if iteration == 1 else res[f"iteration={iteration - 1}"]["poses"][to]
    assert np.abs(t["poses"][to] - before).max() > 1e-2
    np.testing.assert_allclose(t["poses"][to][:, :3, 3], j.poses[jo][:, :3, 3], atol=2e-6, rtol=0)
    np.testing.assert_allclose(t["poses"][to][:, :3, :3], j.poses[jo][:, :3, :3], atol=2e-6, rtol=0)


def test_final_poses(runs):
    """One valid, finite pose per detection, the same hypothesis as JAX's,
    within 1e-5 m and 1e-5 rad."""
    jax_res, res = runs
    j, t = jax_res["final"], res["final"]
    assert t["valid"].sum() == j.valid.sum() == 2
    jo = _rows({k: getattr(j, k)[j.valid] for k in ("instance_ids", "obj_ids", "hypothesis_ids")})
    to = _rows({k: t[k][t["valid"]] for k in ("instance_ids", "obj_ids", "hypothesis_ids")})
    jp, tp = j.poses[j.valid][jo], t["poses"][t["valid"]][to]
    assert np.isfinite(tp).all()
    assert (j.hypothesis_ids[j.valid][jo] == t["hypothesis_ids"][t["valid"]][to]).all()
    assert np.abs(tp[:, :3, 3] - jp[:, :3, 3]).max() < 1e-5
    # rotation angle between the two: |R1 - R2|_F = 2 sqrt(2) sin(angle / 2),
    # well conditioned near 0, unlike the arccos of the trace
    dR = np.linalg.norm((tp[:, :3, :3] - jp[:, :3, :3]).astype(np.float64), axis=(1, 2))
    angle = 2 * np.arcsin(np.clip(dR / (2 * np.sqrt(2)), 0, 1))
    assert angle.max() < 1e-5
    np.testing.assert_allclose(t["pose_logits"][t["valid"]][to], j.pose_logits[j.valid][jo],
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
