"""A refiner loss and the cut MegaPose pipeline with EfficientNet-B3, the
PyTorch port against JAX, on the seeded and calibrated Flax variables of
`test_torch_backbones.py` (one file each, so that the slow JAX compiles of
both spread over two test workers).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from happypose_tpu.inference.pose_estimator import PoseEstimator as JaxPoseEstimator
from happypose_tpu.inference.types import DetectionBatch as JaxDetections
from happypose_tpu.inference.types import InferenceConfig as JaxInferenceConfig
from happypose_tpu.inference.types import ObservationBatch as JaxObservation
from happypose_tpu.training import forward_loss as jax_fl
from happypose_tpu.training.synth_data import make_synth_batch as jax_synth_batch
from happypose_tpu_torch.inference.pose_estimator import PoseEstimator
from happypose_tpu_torch.inference.types import DetectionBatch, InferenceConfig, ObservationBatch
from happypose_tpu_torch.models.pose_predictor import PosePredictor
from happypose_tpu_torch.training.forward_loss import PoseTrainingBatch, make_refiner_loss_fn
from happypose_tpu_torch.utils.weights_from_jax import pose_predictor_state_dict
from test_torch_backbones import (
    _jax_predictor,
    _port_config,
    _predictor_variables,
    seeded_variables,
)
from test_torch_models import mesh_dbs
from test_torch_pipeline import _frame, _rows
from test_torch_training import jax_noise_draws, t

torch.set_num_threads(2)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


# ------------------------------------------------------------- training

IMAGE = (120, 160)
TRAIN_RENDER = (64, 96)
TRAIN_KEY = 137
# The refiner's loss with EfficientNet-B3 to 1e-5 relative. Its gradients
# are continuous (swish and sigmoid are smooth: no activation decides
# differently in the two frameworks), but float32 does not give them to
# 1e-4: against a float64 run of the port (renders in float32 in both), the
# port's float32 gradients are up to 5.9e-4 of a tensor's largest entry
# off and JAX's up to 5.8e-4 (the squeeze-excite's convolutions, whose
# per-sample gate a train-mode BatchNorm then averages away: a small
# difference of large terms); images moved by 1e-7 (relative) move the
# port's by 1.2e-4. So each tensor is held within GRAD_REL of its largest
# |JAX| entry (measured 6.2e-4) and, from the float64 run, within GRAD_F64
# of its largest exact entry; the running statistics within STATS_REL of a
# tensor's largest value (measured 2.6e-5 from JAX's, 2.1e-5 from float64).
GRAD_REL = 2e-3
GRAD_F64 = 1e-3
STATS_REL = 5e-5


def _double_run(model, batch, draws, assets, meshes):
    """The port's refiner loss in float64 from `model`'s weights: the
    network, the crops and the loss in float64, the renders in float32
    (the rasterizer takes float32 only) and cast up."""
    from happypose_tpu_torch.models import pose_predictor as pp

    exact = PosePredictor(model.cfg)
    exact.load_state_dict(model.state_dict())
    exact.double()
    as_double = lambda obj: dataclasses.replace(obj, **{  # noqa: E731
        f.name: getattr(obj, f.name).double() for f in dataclasses.fields(obj)
        if torch.is_tensor(getattr(obj, f.name)) and getattr(obj, f.name).is_floating_point()})
    render = pp.PosePredictor._render_views
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pp.PosePredictor, "_render_views",
                   lambda self, a, ids, T, KV: render(self, a, ids, T.float(), KV.float()).double())
        loss, _ = make_refiner_loss_fn(exact, assets, as_double(meshes), n_iterations=1)(
            batch._replace(images=batch.images.double(), K=batch.K.double(),
                           TCO_gt=batch.TCO_gt.double()),
            {k: v.double() for k, v in draws.items()})
    loss.backward()
    return loss.item(), exact


@pytest.fixture(scope="module")
def refiner_run():
    """The refiner loss (one iteration) with EfficientNet-B3 at 64x96 renders
    on a batch of 4 synthetic 120x160 images (JAX's two-pass renderer draws
    the batch and renders inside the loss): JAX's jitted value and gradient,
    the port's on JAX's noise draws, and the port's in float64. (With a
    second iteration its renders follow the first one's poses, which agree
    to ~1e-7, and its batch statistics move with them: one iteration holds
    the network alone.)"""
    jdb, tdb = mesh_dbs()
    K1 = jnp.asarray([[150.0, 0, IMAGE[1] / 2], [0, 150.0, IMAGE[0] / 2], [0, 0, 1]], jnp.float32)
    jbatch = jax_synth_batch(jax.random.PRNGKey(37), jdb.render_assets(), K1, n_objects=2,
                             batch_size=4, resolution=IMAGE, z_range=(0.35, 0.45),
                             xy_extent=0.03)
    jmodel = _jax_predictor("efficientnet_b3", "refiner", renderer="reference",
                            render=TRAIN_RENDER)
    j_meshes = jdb.batched(n_points=128)
    variables = seeded_variables(jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0), jbatch.images, jbatch.K, jbatch.obj_ids,
        jbatch.TCO_gt, jdb.render_assets(), j_meshes.select(jbatch.obj_ids)), seed=21)
    loss_fn = jax_fl.make_refiner_loss_fn(jmodel, jdb.render_assets(), j_meshes, n_iterations=1)
    rng = jax.random.PRNGKey(TRAIN_KEY)

    @jax.jit
    def step(params, stats):
        return jax.value_and_grad(
            lambda p: loss_fn({"params": p, "batch_stats": stats}, jbatch, rng), has_aux=True
        )(params)

    (loss_ref, (_, stats_ref)), grads_ref = step(variables["params"], variables["batch_stats"])
    ref = pose_predictor_state_dict(jax.tree.map(np.asarray, {
        "params": grads_ref, "batch_stats": stats_ref}))

    model = PosePredictor(_port_config(jmodel))
    model.load_state_dict(pose_predictor_state_dict(variables))
    b = {k: np.asarray(v) for k, v in jbatch._asdict().items()}
    batch = PoseTrainingBatch(images=t(b["images"]), K=t(b["K"]), obj_ids=t(b["obj_ids"]).long(),
                              TCO_gt=t(b["TCO_gt"]))
    assets, meshes = tdb.render_assets(device="cpu"), tdb.batched(n_points=128, device="cpu")
    draws = jax_noise_draws(rng, 4)
    world = dict(batch=batch, draws=draws, assets=assets, meshes=meshes)
    exact_loss, exact = _double_run(model, **world)
    loss, _ = make_refiner_loss_fn(model, assets, meshes, n_iterations=1)(batch, draws)
    loss.backward()
    return dict(loss_ref=float(loss_ref), ref=ref, loss=loss.item(), model=model,
                exact_loss=exact_loss, exact=exact, before=pose_predictor_state_dict(variables),
                world=world)


# bn2 of blocks 1-25: each feeds only 1x1 convolutions (the next block's
# expansion, the head) whose outputs a train-mode BatchNorm normalizes, and
# such a BatchNorm removes any per-channel constant: their biases' gradient is
# 0 in exact arithmetic, float32 noise in both frameworks (~1e-10 where the
# largest entry of the whole gradient is ~0.4).
ZERO_GRADIENT = {f"backbone.blocks.{i}.bn2.bias" for i in range(1, 26)}


def test_refiner_loss_and_gradients_match_jax(refiner_run):
    """The loss to 1e-5 relative of JAX's and of the float64 run; the
    gradient of every parameter within GRAD_REL of its tensor's largest
    |JAX| entry and within GRAD_F64 of the float64 gradient's; the biases
    of ZERO_GRADIENT below 1e-6 of the whole gradient's largest entry in
    both frameworks."""
    r = refiner_run
    np.testing.assert_allclose(r["loss"], r["loss_ref"], rtol=1e-5)
    np.testing.assert_allclose(r["loss"], r["exact_loss"], rtol=1e-5)
    assert r["loss"] > 1e-3
    exact = dict(r["exact"].named_parameters())
    grads = dict(r["model"].named_parameters())
    largest = max(r["ref"][name].abs().max().item() for name in grads)
    worst, worst_exact = {}, {}
    for name, p in grads.items():
        g_ref = r["ref"][name]
        if name in ZERO_GRADIENT:
            assert max(g_ref.abs().max().item(), p.grad.abs().max().item()) < 1e-6 * largest, name
            continue
        scale = g_ref.abs().max().item()
        assert scale > 1e-6 * largest, name
        worst[name] = (p.grad - g_ref).abs().max().item() / scale
        g64 = exact[name].grad
        worst_exact[name] = (p.grad.double() - g64).abs().max().item() / g64.abs().max().item()
    assert max(worst.values()) <= GRAD_REL, sorted(worst.items(), key=lambda kv: -kv[1])[:5]
    assert max(worst_exact.values()) <= GRAD_F64, sorted(
        worst_exact.items(), key=lambda kv: -kv[1])[:5]


def test_refiner_batchnorm_statistics_match_jax(refiner_run):
    """Every running mean and variance after the loss's train-mode forward
    within STATS_REL of its tensor's largest |value| of JAX's and of the
    float64 run's, and every one moved."""
    r = refiner_run
    exact = dict(r["exact"].named_buffers())
    n = 0
    for name, buf in r["model"].named_buffers():
        if name.endswith(("running_mean", "running_var")):
            for ref in (r["ref"][name].numpy(), exact[name].numpy()):
                np.testing.assert_allclose(buf.numpy(), ref, rtol=0,
                                           atol=STATS_REL * np.abs(ref).max(), err_msg=name)
            assert not torch.allclose(buf, r["before"][name]), name
            n += 1
    assert n == 2 * (2 + 2 * 2 + 24 * 3)  # stem, head; 2 or 3 a block


def test_bfloat16_refiner_loss_close_to_float32(refiner_run):
    """`compute_dtype="bfloat16"` runs EfficientNet-B3 under the same
    `torch.autocast` as the other backbones: the loss lies within 2% of the
    float32 loss (bfloat16 keeps 8 bits; the loss averages the features'
    noise over points and samples), the parameters keep float32 gradients."""
    r = refiner_run
    model = PosePredictor(dataclasses.replace(r["model"].cfg, compute_dtype="bfloat16"))
    model.load_state_dict(r["before"])
    w = r["world"]
    loss, _ = make_refiner_loss_fn(model, w["assets"], w["meshes"], n_iterations=1)(
        w["batch"], w["draws"])
    loss.backward()
    assert loss.dtype == torch.float32 and np.isfinite(loss.item())
    assert all(p.grad.dtype == torch.float32 for p in model.parameters())
    np.testing.assert_allclose(loss.item(), r["loss"], rtol=2e-2)
    assert loss.item() != r["loss"]


# ------------------------------------------------------------- the pipeline

N_HYP, N_ITER, GRID = 2, 2, 72


@pytest.fixture(scope="module")
def pipeline_runs():
    """MegaPose with an EfficientNet-B3 refiner and coarse classifier cut to
    32x48 renders, the 72-rotation grid, top-2 and 2 refiner iterations, on
    `test_torch_pipeline.py`'s synthetic frame (the icosphere and the box,
    2 detections), both packages with the same weights."""
    jdb, tdb = mesh_dbs()
    rgb, K, boxes, obj_ids = _frame(tdb)
    j_assets, j_meshes = jdb.render_assets(), jdb.batched(n_points=200)
    jax_models, state_dicts = {}, {}
    # the statistics: the two detections at 4 rotations each, about where
    # autodepth puts them
    ids = np.repeat(obj_ids, 4)
    TCO = np.tile(np.eye(4, dtype=np.float32), (8, 1, 1))
    TCO[:, :3, :3] = Rotation.random(8, random_state=3).as_matrix()
    TCO[:, :3, 3] = np.repeat([[-0.06, 0.01, 0.6], [0.06, -0.02, 0.55]], 4, axis=0)
    images = np.repeat(np.moveaxis(rgb, -1, 0)[None], 8, 0)
    Ks = np.tile(K, (8, 1, 1))
    jax_args = (jnp.asarray(images), jnp.asarray(Ks), jnp.asarray(ids), jnp.asarray(TCO),
                j_assets, j_meshes.select(jnp.asarray(ids)))
    port_args = (torch.from_numpy(images), torch.from_numpy(Ks), torch.from_numpy(ids),
                 torch.from_numpy(TCO), tdb.render_assets(device="cpu"),
                 tdb.batched(n_points=200, device="cpu").select(torch.from_numpy(ids)))
    for seed, role in enumerate(("refiner", "coarse")):
        jmodel = _jax_predictor("efficientnet_b3", role)
        variables = _predictor_variables(jmodel, 11 + seed, jax_args, port_args)
        jax_models[role] = (jmodel, jax.tree.map(jnp.asarray, variables))
        state_dicts[role] = pose_predictor_state_dict(variables)
    jcfg = JaxInferenceConfig(n_refiner_iterations=N_ITER, n_pose_hypotheses=N_HYP,
                              SO3_grid_size=GRID)
    jax_est = JaxPoseEstimator(refiner=jax_models["refiner"], coarse=jax_models["coarse"],
                               assets=j_assets, meshes=j_meshes, cfg=jcfg)
    jax_res = jax_est.run_inference_pipeline(
        JaxObservation.from_numpy(rgb, K), JaxDetections.from_numpy(boxes, obj_ids))

    models = {}
    for role, (jmodel, _) in jax_models.items():
        models[role] = PosePredictor(_port_config(jmodel)).eval()
        models[role].load_state_dict(state_dicts[role])
    est = PoseEstimator(
        refiner=models["refiner"], coarse=models["coarse"], assets=tdb.render_assets(device="cpu"),
        meshes=tdb.batched(n_points=200, device="cpu"),
        cfg=InferenceConfig(n_refiner_iterations=N_ITER, n_pose_hypotheses=N_HYP,
                            SO3_grid_size=GRID))
    res = est.run_inference_pipeline(ObservationBatch.from_numpy(rgb, K, device="cpu"),
                                     DetectionBatch.from_numpy(boxes, obj_ids, device="cpu"))
    jax_res = {k: jax.tree.map(np.asarray, v) for k, v in jax_res.items()}
    res = {k: {f.name: getattr(v, f.name).numpy() for f in dataclasses.fields(v)}
           for k, v in res.items()}
    return jax_res, res


LOGIT_TOL = 2e-5


def test_pipeline_coarse_logits_and_kept_hypotheses(pipeline_runs):
    """EfficientNet-B3's coarse logits over 2 x 72 hypotheses to LOGIT_TOL
    (as `test_torch_pipeline.py`), and the top-2 sets equal (first: the gap
    at the 2nd logit exceeds twice that, so the sets are decided)."""
    jax_res, res = pipeline_runs
    j, t_ = jax_res["coarse"], res["coarse"]
    np.testing.assert_allclose(t_["coarse_logits"], j.coarse_logits, atol=LOGIT_TOL, rtol=LOGIT_TOL)
    top = np.sort(j.coarse_logits.reshape(2, GRID), axis=1)[:, ::-1]
    assert (top[:, N_HYP - 1] - top[:, N_HYP] > 2 * LOGIT_TOL).all()
    jr, tr = jax_res["scored"], res["scored"]
    assert sorted(zip(jr.obj_ids[jr.valid].tolist(), jr.hypothesis_ids[jr.valid].tolist())) == \
        sorted(zip(tr["obj_ids"][tr["valid"]].tolist(), tr["hypothesis_ids"][tr["valid"]].tolist()))


def test_pipeline_final_poses(pipeline_runs):
    """One valid, finite pose per detection, JAX's hypothesis, within 1e-5
    m and 1e-5 rad; the refiner moved the poses."""
    jax_res, res = pipeline_runs
    j, t_ = jax_res["final"], res["final"]
    assert t_["valid"].sum() == j.valid.sum() == 2
    keys = ("instance_ids", "obj_ids", "hypothesis_ids")
    jo = _rows({k: getattr(j, k)[j.valid] for k in keys})
    to = _rows({k: t_[k][t_["valid"]] for k in keys})
    jp, tp = j.poses[j.valid][jo], t_["poses"][t_["valid"]][to]
    assert np.isfinite(tp).all()
    assert (j.hypothesis_ids[j.valid][jo] == t_["hypothesis_ids"][t_["valid"]][to]).all()
    assert np.abs(tp[:, :3, 3] - jp[:, :3, 3]).max() < 1e-5
    dR = np.linalg.norm((tp[:, :3, :3] - jp[:, :3, :3]).astype(np.float64), axis=(1, 2))
    assert (2 * np.arcsin(np.clip(dR / (2 * np.sqrt(2)), 0, 1))).max() < 1e-5
    c = res["coarse"]
    before = np.stack([c["poses"][(c["obj_ids"] == o) & (c["hypothesis_ids"] == h)][0]
                       for o, h in zip(t_["obj_ids"][t_["valid"]][to],
                                       t_["hypothesis_ids"][t_["valid"]][to])])
    assert np.abs(tp - before).max() > 1e-3
