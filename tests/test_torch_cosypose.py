"""CosyPose known-object inference: the PyTorch port against JAX.

The z-up and box inits, the WideResNet18/34 backbones, one PosePredictor
iteration with the ortho6d and the quaternion head, and the pipeline as a
whole (z-up init -> coarse pose model -> refiner). Flax variables are
perturbed with a seed (the pose heads included: a fresh head is an
identity update) and carried over by `weights_from_jax`; both sides see the
same numpy inputs. The JAX renders go through its two-pass `render_batch`
(`renderer="reference"`), the port's through the CUDA kernel's plain
version.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from happypose_tpu.inference.types import DetectionBatch as JaxDetections
from happypose_tpu.inference.types import ObservationBatch as JaxObservation
from happypose_tpu.lib3d import pose_init as jax_pose_init
from happypose_tpu.models import backbones as jax_backbones
from happypose_tpu.models.pose_predictor import (
    PosePredictor as JaxPosePredictor,
    PosePredictorConfig as JaxConfig,
)
from happypose_tpu.utils import load_model as jax_load_model
from happypose_tpu_torch.inference.types import DetectionBatch, ObservationBatch
from happypose_tpu_torch.lib3d import pose_init
from happypose_tpu_torch.models import backbones
from happypose_tpu_torch.models.pose_predictor import PosePredictor, PosePredictorConfig
from happypose_tpu_torch.utils import load_model as torch_load_model
from happypose_tpu_torch.utils.weights_from_jax import (
    pose_predictor_state_dict,
    wide_resnet_state_dict,
)
from test_torch_models import _scene, perturb
from test_torch_pipeline import _frame

torch.set_num_threads(2)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

RENDER = (60, 80)
N_REFINER = 2
POSE_TOL = 1e-5  # metres and rotation-matrix entries


def _init_inputs(B=5, P=50, seed=0):
    rs = np.random.RandomState(seed)
    xy = rs.uniform(20, 100, (B, 2))
    boxes = np.concatenate([xy, xy + rs.uniform(10, 60, (B, 2))], axis=1).astype(np.float32)
    K = np.tile(np.asarray([[300.0, 0, 80], [0, 310.0, 60], [0, 0, 1]], np.float32), (B, 1, 1))
    K[:, :2, 2] += rs.uniform(-5, 5, (B, 2)).astype(np.float32)
    points = rs.uniform(-0.05, 0.05, (B, P, 3)).astype(np.float32)
    mask = rs.rand(B, P) > 0.2
    points[~mask] = 10.0  # padding far away: only the mask keeps it out
    return boxes, K, points, mask


def test_TCO_init_from_boxes_matches_jax():
    boxes, K, _, _ = _init_inputs()
    ref = jax_pose_init.TCO_init_from_boxes((0.4, 0.9), jnp.asarray(boxes), jnp.asarray(K))
    out = pose_init.TCO_init_from_boxes((0.4, 0.9), torch.from_numpy(boxes), torch.from_numpy(K))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("masked", [True, False])
def test_zup_autodepth_init_matches_jax(masked):
    boxes, K, points, mask = _init_inputs()
    if not masked:
        points[~mask] = 0.0
    m = mask if masked else None
    ref = jax_pose_init.TCO_init_from_boxes_zup_autodepth(
        jnp.asarray(boxes), jnp.asarray(points), jnp.asarray(K),
        None if m is None else jnp.asarray(m),
    )
    out = pose_init.TCO_init_from_boxes_zup_autodepth(
        torch.from_numpy(boxes), torch.from_numpy(points), torch.from_numpy(K),
        None if m is None else torch.from_numpy(m),
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)
    zup = np.asarray(jax_pose_init._ZUP)[:3, :3]
    np.testing.assert_array_equal(out.numpy()[:, :3, :3], np.broadcast_to(zup, (len(boxes), 3, 3)))


@pytest.mark.parametrize("depth", [18, 34])
def test_wide_resnet_matches_flax(depth):
    """Features of a 6-channel input [2, 6, 60, 80] (crop + rgb render) to
    1e-4 relative of their largest magnitude."""
    x = np.random.RandomState(depth).rand(2, 6, 60, 80).astype(np.float32)
    flax_model = getattr(jax_backbones, f"WideResNet{depth}")()
    x_nhwc = jnp.asarray(np.moveaxis(x, 1, -1))
    variables = perturb(jax.jit(flax_model.init)(jax.random.PRNGKey(0), x_nhwc), seed=depth)
    ref = np.asarray(jax.jit(flax_model.apply)(variables, x_nhwc))

    model = getattr(backbones, f"WideResNet{depth}")(n_inputs=6).eval()
    model.load_state_dict(wide_resnet_state_dict(variables["params"], variables["batch_stats"]))
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, model.n_features) == (2, 512)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("pose_head", ["ortho6d", "quaternion"])
def test_pose_predictor_iteration_matches_flax(pose_head):
    """One CosyPose iteration (crop, RGB render, WideResNet18, pose head):
    the head's raw output to 1e-4, TCO_output to 1e-5."""
    jdb, tdb, images, K, TCO, obj_ids = _scene()
    kw = dict(backbone="wide_resnet18", render_size=RENDER, render_normals=False,
              pose_head=pose_head)
    jax_model = JaxPosePredictor(JaxConfig(renderer="reference", **kw))
    args = (
        jnp.asarray(images), jnp.asarray(K), jnp.asarray(obj_ids), jnp.asarray(TCO),
        jdb.render_assets(), jdb.batched(n_points=200).select(jnp.asarray(obj_ids)),
    )
    variables = perturb(jax_model.init(jax.random.PRNGKey(0), *args), seed=2)
    ref = jax_model.apply(variables, *args, n_iterations=1)

    model = PosePredictor(PosePredictorConfig(**kw)).eval()
    model.load_state_dict(pose_predictor_state_dict(variables))
    ids = torch.from_numpy(obj_ids)
    with torch.no_grad():
        out = model(
            torch.from_numpy(images), torch.from_numpy(K), ids, torch.from_numpy(TCO),
            tdb.render_assets(device="cpu"), tdb.batched(n_points=200, device="cpu").select(ids),
        )
    assert out.pose_raw.shape == ref.pose_raw.shape == (1, 2, 7 if pose_head == "quaternion" else 9)
    assert not np.allclose(np.asarray(ref.TCO_output), np.asarray(ref.TCO_input), atol=1e-3)
    np.testing.assert_allclose(out.pose_raw.numpy(), np.asarray(ref.pose_raw), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(out.TCO_output.numpy(), np.asarray(ref.TCO_output),
                               atol=POSE_TOL, rtol=0)


def test_identity_heads_are_no_ops():
    """Fresh seeded weights: both heads predict the identity update."""
    for head in ("ortho6d", "quaternion"):
        model = PosePredictor(PosePredictorConfig(
            backbone="wide_resnet18", render_size=RENDER, render_normals=False, pose_head=head))
        model.init_weights(torch.Generator().manual_seed(0))
        with torch.no_grad():
            model.pose_fc.weight.zero_()
        _, tdb, images, K, TCO, obj_ids = _scene()
        ids = torch.from_numpy(obj_ids)
        with torch.no_grad():
            out = model.eval()(
                torch.from_numpy(images), torch.from_numpy(K), ids, torch.from_numpy(TCO),
                tdb.render_assets(device="cpu"),
                tdb.batched(n_points=50, device="cpu").select(ids),
            )
        np.testing.assert_allclose(out.TCO_output[0].numpy(), TCO, atol=1e-6)


def _small(spec, **renderer):
    return dataclasses.replace(
        spec,
        refiner_cfg=dataclasses.replace(spec.refiner_cfg, backbone="wide_resnet18",
                                        render_size=RENDER, **renderer),
        coarse_cfg=dataclasses.replace(spec.coarse_cfg, backbone="wide_resnet18",
                                       render_size=RENDER, **renderer),
        inference_cfg=dataclasses.replace(spec.inference_cfg, n_refiner_iterations=N_REFINER),
    )


@pytest.fixture(scope="module")
def runs():
    """Both packages' `load_named_model("cosypose-RGB")` cut to test size
    (WideResNet18, 60x80 renders, 1 coarse + 2 refiner iterations), the
    same perturbed weights, the same synthetic frame with D = 2."""
    from test_torch_models import mesh_dbs

    jdb, tdb = mesh_dbs()
    rgb, K, boxes, obj_ids = _frame(tdb)
    scores = np.asarray([0.9, 0.7], np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_load_model.NAMED_MODELS, "cosypose-RGB-test",
                   _small(jax_load_model.NAMED_MODELS["cosypose-RGB"], renderer="reference"))
        mp.setitem(torch_load_model.NAMED_MODELS, "cosypose-RGB-test",
                   _small(torch_load_model.NAMED_MODELS["cosypose-RGB"]))

        jax_est = jax_load_model.load_named_model("cosypose-RGB-test", jdb, n_points=200)
        refiner_vars = perturb(jax_est.refiner_vars, seed=21)
        coarse_vars = perturb(jax_est.coarse_vars, seed=22)
        jax_est.refiner_vars = jax.tree.map(jnp.asarray, refiner_vars)
        jax_est.coarse_vars = jax.tree.map(jnp.asarray, coarse_vars)
        jax_res = jax_est.run_inference_pipeline(
            JaxObservation.from_numpy(rgb, K),
            JaxDetections.from_numpy(boxes, obj_ids, scores=scores),
        )

        est = torch_load_model.load_named_model(
            "cosypose-RGB-test", tdb, n_points=200,
            state_dicts={"refiner": pose_predictor_state_dict(refiner_vars),
                         "coarse": pose_predictor_state_dict(coarse_vars)},
            device="cpu",
        )
        res = est.run_inference_pipeline(
            ObservationBatch.from_numpy(rgb, K, device="cpu"),
            DetectionBatch.from_numpy(boxes, obj_ids, scores=scores, device="cpu"),
        )
    jax_res = {k: jax.tree.map(np.asarray, v) for k, v in jax_res.items()}
    res = {k: {f.name: getattr(v, f.name).numpy() for f in dataclasses.fields(v)}
           for k, v in res.items()}
    return jax_res, res, scores


STAGES = ["init", "coarse"] + [f"iteration={k}" for k in range(1, N_REFINER + 1)] + ["final"]


def test_pipeline_stages(runs):
    jax_res, res, _ = runs
    assert sorted(res) == sorted(jax_res) == sorted(STAGES)


@pytest.mark.parametrize("stage", STAGES)
def test_pipeline_poses_match_jax(runs, stage):
    """Every stage's poses, row by row, to 1e-5; each stage after the init
    moves the poses (the perturbed heads are not identity updates)."""
    jax_res, res, _ = runs
    j, t = jax_res[stage], res[stage]
    assert t["poses"].shape == (2, 4, 4) and np.isfinite(t["poses"]).all()
    np.testing.assert_array_equal(t["obj_ids"], j.obj_ids)
    np.testing.assert_array_equal(t["valid"], j.valid)
    if stage != "init":
        prev = STAGES[STAGES.index(stage) - 1] if stage != "final" else f"iteration={N_REFINER}"
        moved = np.abs(t["poses"] - res[prev]["poses"]).max()
        assert moved > 1e-3 if stage != "final" else moved == 0
    np.testing.assert_allclose(t["poses"], j.poses, atol=POSE_TOL, rtol=0)


def test_final_carries_detection_scores(runs):
    jax_res, res, scores = runs
    np.testing.assert_array_equal(res["final"]["pose_logits"], scores)
    np.testing.assert_array_equal(jax_res["final"].pose_logits, scores)
    assert res["final"]["valid"].all()


def test_cosypose_rgb_full_width_spec():
    """`load_named_model("cosypose-RGB")` at full width builds on the CPU:
    WideResNet34 on crop + RGB render (6 channels), ortho6d heads, 240x320
    renders, 1 coarse + 4 refiner iterations."""
    from test_torch_models import mesh_dbs

    _, tdb = mesh_dbs()
    est = torch_load_model.load_named_model("cosypose-RGB", tdb, n_points=50, device="cpu")
    for model in (est.refiner_model, est.coarse_model):
        assert isinstance(model.backbone, backbones.WideResNet)
        assert model.backbone.conv1.in_channels == 6
        assert len(model.backbone.blocks) == 16 and model.pose_fc.out_features == 9
        assert model.cfg.render_size == (240, 320)
    assert (est.cfg.n_coarse_iterations, est.cfg.n_refiner_iterations) == (1, 4)
    assert not est._coarse_is_classifier
