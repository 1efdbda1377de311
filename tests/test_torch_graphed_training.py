"""The graphed training sites on their CPU path, against JAX's jits and
against their eager bodies: the train step (`make_train_step`, JAX's
`jax.jit(_step)`), the learning rate from the device count, the host reads
of a step, the synthetic batch, `eval_refiner_checkpoint`'s refine and the
detector training's eval forward.

The step's world is `test_torch_training_grads.py`'s refiner world
(WideResNet18, 60x80 renders, 120x160 images, B = 4, 2 iterations, the
Flax weights carried over, batch seed 37, draws from key 137), trained 3
steps by both packages with a warm-up of 2 updates and a decay at update
1, so every applied step has its own rate: the first applied, the second
skipped by a NaN pixel, the third applied on the first step's batch and
draws. The JAX step is jitted and run once, in a module fixture.

Tolerances (the loss and gradient tolerances of
`test_torch_training_grads.py`): losses and metrics 1e-5 relative; the
gradient norm and Adam's first moments GRAD_REL (1e-4) of their largest
entry; the second moments, quadratic in the gradients, 2 x GRAD_REL; the
BatchNorm running statistics 1e-5 relative + 1e-6; the counts exactly.
The parameters: Adam moves an entry by lr x m / (sqrt(v) + eps), which
is ill-conditioned where the gradient is within its float32 error of 0
(1e-8 eps), so parameters after a step are held to JAX where the update
is well posed and to the step's rate elsewhere, and the step after that
one takes its gradient at parameters that differ there (see
`test_graphed_step_matches_jax`). Graph path against eager: bit for bit.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _disable_current_modes

from happypose_tpu.lib3d.rotations import quat_to_rotmat as jax_quat_to_rotmat
from happypose_tpu.lib3d.transforms import add_pose_noise as jax_add_pose_noise
from happypose_tpu.training import forward_loss as jax_fl
from happypose_tpu.training.synth_data import make_synth_batch as jax_synth_batch
from happypose_tpu.training.trainer import TrainState as JaxTrainState
from happypose_tpu.training.trainer import make_lr_schedule as jax_schedule
from happypose_tpu.training.trainer import make_optimizer as jax_make_optimizer
from happypose_tpu.training.trainer import make_train_step as jax_make_train_step
from happypose_tpu_torch.ops import rasterizer_fused as rf
from happypose_tpu_torch.scripts.eval_refiner_checkpoint import make_refine
from happypose_tpu_torch.scripts import run_detector_training as rdt
from happypose_tpu_torch.scripts.run_detector_training import eval_forward
from happypose_tpu_torch.training.forward_loss import make_refiner_loss_fn
from happypose_tpu_torch.training.synth_data import (
    make_synth_batch, make_synth_batch_eager, synth_batch_graphs,
)
from happypose_tpu_torch.training.trainer import (
    TrainState, make_lr_schedule, make_optimizer, make_train_step,
)
from happypose_tpu_torch.utils.weights_from_jax import pose_predictor_state_dict
from test_torch_cuda_graphs import _HostReads
from test_torch_models import mesh_dbs
from test_torch_training import jax_noise_draws, t
from test_torch_training_grads import GRAD_REL, REFINER_KEY, _torch_batch, _world

torch.set_num_threads(2)

OPT = dict(lr=1e-4, n_warmup_steps=2, decay_steps=(1,))
EPS = 1e-8  # Adam's, in both packages
KINK_REL = 0.11  # a gradient across a ReLU kink (ROADMAP section 3, caveats)
STATS_REL = 1e-4  # running statistics after a forward at parameters that differ
N_ITER = 2
# (batch made non-finite, draws key) of each step
STEPS = ((False, REFINER_KEY), (True, REFINER_KEY + 1), (False, REFINER_KEY))


def _step_batch(b, nan):
    b = {k: v.copy() for k, v in b.items()}
    if nan:
        b["images"][1, 0, 10, 10] = np.nan
    return b


@pytest.fixture(scope="module")
def world():
    return _world("refiner", B=4, seed=21, batch_seed=37)


@pytest.fixture(scope="module")
def jax_run(world):
    """JAX's jitted train step, 3 steps: (metrics a step, state a step)."""
    w = world
    tx = jax_make_optimizer(**OPT)
    loss_fn = jax_fl.make_refiner_loss_fn(w["jmodel"], w["j_assets"], w["j_meshes"],
                                          n_iterations=N_ITER)
    step = jax_make_train_step(loss_fn, tx, donate=False)
    state = JaxTrainState.create(w["variables"], tx)
    metrics, states = [], []
    for nan, key in STEPS:
        b = _step_batch(w["batch"], nan)
        batch = jax_fl.PoseTrainingBatch(**{k: jnp.asarray(v) for k, v in b.items()})
        state, m = step(state, batch, jax.random.PRNGKey(key))
        metrics.append({k: float(v) for k, v in m.items()})
        states.append(jax.device_get(state))
    return metrics, states


def _port_world(w):
    model = copy.deepcopy(w["model"])
    loss_fn = make_refiner_loss_fn(model, w["assets"], w["meshes"], n_iterations=N_ITER)
    return TrainState(model, make_optimizer(model.parameters(), **OPT)), make_train_step(loss_fn)


def _snapshot(state):
    opt = state.optimizer
    return ({k: v.clone() for k, v in state.model.state_dict().items()},
            {i: {k: v.clone() for k, v in s.items()}
             for i, s in opt.adam.state_dict()["state"].items()},
            opt.count, state.step)


@pytest.fixture(scope="module")
def port_run(world):
    """The graphed step (its CPU path) and the eager body from the same
    weights, 3 steps each: (metrics a step, snapshots a step) of both."""
    out = {}
    for name in ("graph", "eager"):
        state, step = _port_world(world)
        fn = step if name == "graph" else step.eager
        metrics, snaps = [], []
        for nan, key in STEPS:
            batch = _torch_batch(_step_batch(world["batch"], nan))
            metrics.append(fn(state, batch, jax_noise_draws(jax.random.PRNGKey(key), 4)))
            snaps.append(_snapshot(state))
        out[name] = (metrics, snaps, state, step)
    return out


def _held(state_tree):
    """JAX's state as the port's names: (parameters and statistics, Adam's
    first and second moments, Adam's count, the schedule's count, steps)."""
    adam = state_tree.opt_state[1][0]
    as_sd = lambda params: pose_predictor_state_dict(  # noqa: E731
        {"params": params, "batch_stats": state_tree.batch_stats})
    return (as_sd(state_tree.params), as_sd(adam.mu), as_sd(adam.nu), int(adam.count),
            int(state_tree.opt_state[1][1].count), int(state_tree.step))


def test_graphed_step_matches_jax(world, jax_run, port_run):
    """3 steps (the second skipped) of the graphed step's CPU path against
    JAX's jitted step, at the tolerances of the module docstring, after
    every step.

    - Every step: losses, metrics, gradient norm; the step, Adam's and the
      schedule's counts exactly (the skipped step counts as a step only).
    - After the first step (equal weights before it): Adam's moments; the
      parameters to GRAD_REL of the largest displacement where the update
      is well posed (|gradient| > 1e3 x eps: the update is its sign), plus
      two float32 roundings of the parameter (the sum p + update), and
      within twice the rate everywhere (a sign flip of a gradient within
      its error of 0); the running statistics.
    - The skipped step changes nothing, in both packages.
    - After the third step, whose gradient is taken at parameters that
      already differ where the first update was ill-posed: the moments to
      KINK_REL of their largest entry (ROADMAP section 3: such a difference
      moves a tensor's gradient by up to 11% of its largest entry while the
      loss agrees to 1e-5), the parameters within twice the rates of the
      applied steps, the running statistics to STATS_REL of each buffer's
      largest entry (a forward at parameters that differ by that much;
      7.3e-6 measured)."""
    ref_metrics, ref_states = jax_run
    metrics, snaps, state, _ = port_run["graph"]
    for i, (m, r) in enumerate(zip(metrics, ref_metrics)):
        assert sorted(m) == sorted(r)
        for k in m:
            tol = dict(rtol=GRAD_REL) if k == "grad_norm" else dict(rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(m[k], r[k], equal_nan=True, err_msg=f"step {i} {k}", **tol)
    assert [m["skipped_nonfinite"] for m in metrics] == [0.0, 1.0, 0.0]
    assert metrics[1]["loss"] == 0.0 and metrics[1]["grad_norm"] == 0.0

    names = [n for n, _ in state.model.named_parameters()]
    p0 = world["model"].state_dict()
    rates = [OPT["lr"] * 0.5, OPT["lr"] * 0.1]  # the schedule at counts 0 and 1
    for i, (snap, ref) in enumerate(zip(snaps, ref_states)):
        sd, adam, count, n_steps = snap
        ref_sd, mu, nu, adam_count, sched_count, ref_steps = _held(ref)
        assert (count, n_steps) == (adam_count, ref_steps) and sched_count == adam_count, i
        assert all(float(s["step"]) == count for s in adam.values())
        if i == 1:  # skipped: nothing moved, in either package
            assert all(torch.equal(sd[k], snaps[0][0][k]) for k in sd)
            assert all(torch.equal(ref_sd[k], _held(ref_states[0])[0][k]) for k in ref_sd)
            continue
        bound = 2 * sum(rates[:count])
        worst = {}
        for j, n in enumerate(names):
            for key, ref_t, tol in (("exp_avg", mu[n], GRAD_REL), ("exp_avg_sq", nu[n], 2 * GRAD_REL)):
                tol = tol if i == 0 else KINK_REL
                err = (adam[j][key] - ref_t).abs().max().item()
                assert err <= tol * ref_t.abs().max().item(), (i, n, key, err)
            err = (sd[n] - ref_sd[n]).abs()
            assert err.max().item() <= bound, (i, n, err.max().item())
            well_posed = mu[n].abs() > 0.1 * 1e3 * EPS  # |g| > 1e3 eps: mu = 0.1 g
            if i == 0 and well_posed.any():
                rounding = 2 * torch.finfo(torch.float32).eps * ref_sd[n].abs()
                worst[n] = ((err - rounding)[well_posed].max().item()
                            / (ref_sd[n] - p0[n]).abs().max().item())
        if i == 0:
            assert max(worst.values()) <= GRAD_REL, sorted(worst.items(), key=lambda kv: -kv[1])[:5]
        for n in sd:
            if "running" in n and i == 0:
                np.testing.assert_allclose(sd[n].numpy(), ref_sd[n].numpy(), rtol=1e-5, atol=1e-6,
                                           err_msg=n)
            elif "running" in n:
                err = (sd[n] - ref_sd[n]).abs().max().item()
                assert err <= STATS_REL * ref_sd[n].abs().max().item(), (n, err)


def test_graphed_step_equals_eager(port_run):
    """The graphed step's CPU path (static input buffers, the body, clones
    out) equals the eager body bit for bit after every step: metrics,
    parameters, BatchNorm buffers, Adam's state, the counts."""
    (m_g, s_g, _, step), (m_e, s_e, _, _) = port_run["graph"], port_run["eager"]
    assert len(step.graphs) == 1  # one key for three calls
    for i in range(len(STEPS)):
        assert m_g[i].keys() == m_e[i].keys()
        for k in m_g[i]:
            assert np.array_equal(m_g[i][k], m_e[i][k], equal_nan=True), (i, k)
        (sd_g, adam_g, count_g, step_g), (sd_e, adam_e, count_e, step_e) = s_g[i], s_e[i]
        assert (count_g, step_g) == (count_e, step_e)
        for k in sd_g:
            assert torch.equal(sd_g[k], sd_e[k]), (i, k)
        for j in adam_g:
            for k in adam_g[j]:
                assert torch.equal(adam_g[j][k], adam_e[j][k]), (i, j, k)


def test_one_call_is_one_update(port_run):
    """After N calls the step count is N and the count of applied updates N
    less the skipped steps (as JAX counts them), step by step: 1, 1, 2."""
    _, snaps, _, _ = port_run["graph"]
    assert [(s[2], s[3]) for s in snaps] == [(1, 1), (1, 2), (2, 3)]


@pytest.mark.parametrize("count", [0, 1, 3, 4, 6, 8, 9, 11])
def test_rate_from_the_device_count(count):
    """The schedule of a device count (an int64 tensor: float32 arithmetic,
    as JAX's on its int32 count) equals JAX's `make_lr_schedule` over the
    warm-up (4 updates) and two decays, and is the rate `Optimizer.apply`
    takes: a first Adam update of a large gradient moves each entry by the
    rate of the count set before it, times the float32 bias corrections'
    ratio (1 - 0.9 and 1 - 0.999 in float32 round to 2e-7 and 1.3e-5 of
    their value, as optax's do): 7e-6 off the rate, held to 1e-5."""
    kw = dict(base_lr=3e-4, n_warmup_steps=4, total_steps=12, decay_steps=(6, 9))
    lr = make_lr_schedule(**kw)(torch.tensor(count))
    assert lr.dtype == torch.float32
    assert lr.item() == float(jax_schedule(**kw)(jnp.asarray(count, jnp.int32)))
    p = torch.nn.Parameter(torch.zeros(3))
    opt = make_optimizer([p], lr=3e-4, n_warmup_steps=4, decay_steps=(6, 9), clip_grad_norm=None)
    opt.count = count
    p.grad = torch.tensor([1.0, -2.0, 4.0])
    opt.apply(torch.tensor(0.0))
    np.testing.assert_allclose(p.detach().numpy(), -lr.item() * np.sign([1.0, -2.0, 4.0]),
                               rtol=1e-5)
    assert opt.count == count + 1


def _refiner_world():
    from happypose_tpu_torch.models.pose_predictor import PosePredictor, PosePredictorConfig
    from happypose_tpu_torch.training.forward_loss import make_coarse_grid_loss_fn
    from happypose_tpu_torch.training.synth_data import make_synth_mesh_db, sample_synth_scenes

    db = make_synth_mesh_db("debug")
    assets, meshes = db.render_assets(device="cpu"), db.batched(n_points=64, device="cpu")
    K1 = torch.tensor([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]])
    batch = make_synth_batch(assets, K1, sample_synth_scenes(
        torch.Generator().manual_seed(0), 2, 2, (48, 64), z_range=(0.3, 0.4)))
    worlds = {}
    for role in ("refiner", "coarse"):
        model = PosePredictor(PosePredictorConfig(
            backbone="wide_resnet18", render_size=(24, 32),
            predict_pose_update=role == "refiner", predict_rendered_views_logits=role == "coarse"))
        model.init_weights(torch.Generator().manual_seed(0))
        loss_fn = (make_refiner_loss_fn(model, assets, meshes, n_iterations=2) if role == "refiner"
                   else make_coarse_grid_loss_fn(model, assets, meshes, n_hypotheses=3,
                                                 so3_grid_size=72))
        worlds[role] = (TrainState(model, make_optimizer(model.parameters(), n_warmup_steps=2)),
                        make_train_step(loss_fn), batch,
                        loss_fn.sample(torch.Generator().manual_seed(1), batch))
    return worlds


def _detector_world():
    from happypose_tpu_torch.scripts.run_detector_training import make_detector_trainer
    from happypose_tpu_torch.training.detector_loss import DetectionTargets

    trainer = make_detector_trainer(2, 32, 1e-4, "cpu")
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.rand(2, 3, 64, 96).astype(np.float32))
    boxes = torch.tensor([[[8.0, 8.0, 40.0, 36.0], [50.0, 20.0, 90.0, 60.0]]] * 2)
    masks = torch.zeros(2, 2, 16, 24, dtype=torch.bool)
    masks[:, 0, 2:9, 2:10] = True
    masks[:, 1, 5:15, 12:22] = True
    targets = DetectionTargets(boxes=boxes, labels=torch.tensor([[0, 1]] * 2),
                               masks=masks, valid=torch.ones(2, 2, dtype=torch.bool))
    return trainer.state, trainer.step, (x, targets), {}


@pytest.mark.parametrize("role", ["refiner", "coarse", "detector"])
def test_step_has_no_host_reads(role, monkeypatch):
    """One eager step after a warm step (which made Adam's state) runs no
    operator that a capture refuses, the optimizer's update included; the
    kernel's plain version aside (on the card the kernel takes its
    place)."""
    state, step, batch, draws = (_detector_world() if role == "detector"
                                 else _refiner_world()[role])
    step.eager(state, batch, draws)
    plain = rf.raster_fused_reference

    def kernel_stand_in(*args):
        with _disable_current_modes():
            return plain(*args)

    monkeypatch.setattr(rf, "raster_fused_reference", kernel_stand_in)
    mode = _HostReads()
    with mode:
        out = step.body(state, batch, draws)
    assert not mode.seen, sorted(mode.seen)
    assert float(out["skipped_nonfinite"]) == 0.0 and state.optimizer.count == 2


def _jax_synth_draws(rng, B, H, W):
    k_obj, k_rot, k_xy, k_z, k_bg, k_noise = jax.random.split(rng, 6)
    return {
        "obj_ids": t(jax.random.randint(k_obj, (B,), 0, 2)).long(),
        "R": t(jax_quat_to_rotmat(jax.random.normal(k_rot, (B, 4)))),
        "xy": t(jax.random.uniform(k_xy, (B, 2), minval=-0.03, maxval=0.03)),
        "z": t(jax.random.uniform(k_z, (B, 1), minval=0.3, maxval=0.4)),
        "bg": t(jax.random.uniform(k_bg, (B, H, W, 3))),
        "noise": t(jax.random.normal(k_noise, (B, H, W, 3))),
    }


def test_synth_batch_graph_matches_jax_and_eager():
    """Two batches of one shape through the synthetic batch's graph (one
    key: the second call copies its draws into the first's buffers) against
    JAX's jitted `make_synth_batch` on the draws JAX made (ids and poses to
    1e-6, images to 1e-5 on 99.9% of the pixels: an edge pixel can go to
    the other side between the two rasterizers) and against the eager body
    bit for bit."""
    jdb, tdb = mesh_dbs()
    B, (H, W) = 3, (48, 64)
    K1 = np.asarray([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]], np.float32)
    assets = tdb.render_assets(device="cpu")
    n0 = len(synth_batch_graphs)
    for seed in (3, 4):
        rng = jax.random.PRNGKey(seed)
        ref = jax_synth_batch(rng, jdb.render_assets(), jnp.asarray(K1), n_objects=2,
                              batch_size=B, resolution=(H, W), z_range=(0.3, 0.4), xy_extent=0.03)
        draws = _jax_synth_draws(rng, B, H, W)
        out = make_synth_batch(assets, t(K1), draws)
        eager = make_synth_batch_eager(assets, t(K1), draws)
        for a, b in zip(out, eager):
            assert torch.equal(a, b)
        np.testing.assert_array_equal(out.obj_ids.numpy(), np.asarray(ref.obj_ids))
        np.testing.assert_allclose(out.TCO_gt.numpy(), np.asarray(ref.TCO_gt), atol=1e-6)
        close = np.abs(out.images.numpy() - np.asarray(ref.images)) <= 1e-5
        assert close.mean() >= 0.999, close.mean()
    assert len(synth_batch_graphs) == n0 + 1


@pytest.mark.parametrize("init_mode", ["noise", "grid"])
def test_refiner_checkpoint_refine_matches_jax(world, init_mode):
    """`eval_refiner_checkpoint`'s refine through its graph's CPU path
    against the JAX script's jitted `refine` (copied from
    `happypose_tpu/scripts/eval_refiner_checkpoint.py`) on the same weights,
    batch and noise key: the initial and refined poses to 1e-5 (float32 work
    of two refiner iterations, as `tests/test_torch_pipeline.py`'s poses),
    and the graph path equal to the eager body."""
    from happypose_tpu.lib3d.pose_init import TCO_init_from_boxes_autodepth_with_R
    from happypose_tpu.lib3d.so3_grid import load_SO3_grid
    from happypose_tpu.lib3d.transforms import transform_pts

    w = world
    grid = jnp.asarray(load_SO3_grid(72))
    rng = jax.random.PRNGKey(7)
    jbatch = jax_fl.PoseTrainingBatch(**{k: jnp.asarray(v) for k, v in w["batch"].items()})

    @jax.jit
    def refine_ref(batch, rng):
        inst = w["j_meshes"].select(batch.obj_ids)
        if init_mode == "grid":
            tr = jnp.einsum("mji,bji->bm", grid, batch.TCO_gt[:, :3, :3])
            ang = jnp.arccos(jnp.clip((tr - 1.0) / 2.0, -1.0, 1.0))
            R_init = grid[jnp.argmin(ang, axis=-1)]
            uv = jnp.einsum("bij,bpj->bpi", batch.K, transform_pts(batch.TCO_gt, inst.points))
            uv = uv[..., :2] / jnp.maximum(uv[..., 2:3], 1e-6)
            mask = inst.points_mask[..., None]
            boxes = jnp.concatenate([jnp.min(jnp.where(mask, uv, 1e6), axis=1),
                                     jnp.max(jnp.where(mask, uv, -1e6), axis=1)], axis=-1)
            TCO_init = TCO_init_from_boxes_autodepth_with_R(
                boxes, inst.points, batch.K, R_init, inst.points_mask)
        else:
            TCO_init = jax_add_pose_noise(rng, batch.TCO_gt)
        out = w["jmodel"].apply(w["variables"], batch.images, batch.K, batch.obj_ids, TCO_init,
                                w["j_assets"], inst, n_iterations=N_ITER)
        return TCO_init, out.TCO_output[-1]

    ref = [np.asarray(x) for x in refine_ref(jbatch, rng)]
    model = copy.deepcopy(w["model"])
    refine = make_refine(model, w["assets"], w["meshes"], N_ITER, init_mode, t(grid))
    noise = (tuple(jax_noise_draws(rng, 4).values()) if init_mode == "noise" else None)
    batch = _torch_batch(w["batch"])
    out = refine(batch, noise)
    again = refine(batch, noise)
    for a, b, r in zip(out, again, ref):
        assert torch.equal(a, b)
        np.testing.assert_allclose(a.numpy(), r, atol=1e-5, rtol=0)


def test_detector_eval_forward_matches_jax():
    """The detector training's eval forward through its graph's CPU path
    against JAX's jitted `eval_forward` (`model.apply(v, x, train=False)`)
    on the same perturbed weights: every output to `RAW_RTOL` of the
    largest |value| (`tests/test_torch_detector.py`); a second image shape
    is a key of its own, and a repeated call equals the first."""
    from happypose_tpu.models import detector as jd
    from happypose_tpu_torch.models import detector as td
    from happypose_tpu_torch.utils.weights_from_jax import detector_state_dict
    from test_torch_detector import CFG, RAW_RTOL, H, W
    from test_torch_models import perturb

    jax_model = jd.FCOSDetector(jd.DetectorConfig(**CFG))
    images = np.random.RandomState(1).rand(2, 3, H, W).astype(np.float32)
    variables = perturb(jax.jit(lambda k, x: jax_model.init(k, x, train=False))(
        jax.random.PRNGKey(0), jnp.asarray(images[:1])), seed=5)
    model = td.FCOSDetector(td.DetectorConfig(**CFG)).eval()
    model.load_state_dict(detector_state_dict(variables))
    ref = jax.tree.map(np.asarray, jax.jit(lambda v, x: jax_model.apply(v, x, train=False))(
        variables, jnp.asarray(images)))
    out = eval_forward(model, torch.from_numpy(images))
    for f in td.DetectorOutputs._fields:
        o, r = getattr(out, f), np.asarray(getattr(ref, f))
        if f in ("locations", "level_ids"):
            np.testing.assert_array_equal(o.numpy(), r)
        else:
            np.testing.assert_allclose(o.numpy(), r, rtol=RAW_RTOL, atol=RAW_RTOL * np.abs(r).max(),
                                       err_msg=f)
    # another image shape is another key; a repeated call replays the first
    eval_forward(model, torch.from_numpy(images[:1]))
    again = eval_forward(model, torch.from_numpy(images))
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    assert len(rdt._eval_graphs[model]) == 2
