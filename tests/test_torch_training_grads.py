"""The training losses through the network, port against JAX: loss values,
the gradient with respect to every parameter and the BatchNorm running
statistics after one train-mode step's forward, for the refiner (2
iterations) and the coarse grid loss; the multiview coarse loss's value;
bfloat16; and the stop of the gradient between refiner iterations.

Both sides run WideResNet18 at 60x80 renders on 120x160 synthetic images
(the icosphere and the box of `test_torch_models.py`) with the same
perturbed Flax weights carried over by `weights_from_jax`, and the draws
JAX made inside its loss (rebuilt from the keys it splits). The JAX side
renders with its two-pass `render_batch` (`renderer="reference"`), which the
port's plain rasterizer follows to 1e-5; each JAX loss is jitted once, in a
module-scoped fixture.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from happypose_tpu.models.pose_predictor import PosePredictor as JaxPosePredictor
from happypose_tpu.models.pose_predictor import PosePredictorConfig as JaxConfig
from happypose_tpu.training import forward_loss as jax_fl
from happypose_tpu.training.synth_data import make_synth_batch as jax_synth_batch
from happypose_tpu_torch.models.pose_predictor import PosePredictor, PosePredictorConfig
from happypose_tpu_torch.training.forward_loss import (
    PoseTrainingBatch, make_coarse_grid_loss_fn, make_coarse_loss_fn, make_refiner_loss_fn,
)
from happypose_tpu_torch.utils.weights_from_jax import pose_predictor_state_dict
from test_torch_models import mesh_dbs, perturb
from test_torch_training import jax_noise_draws, t

torch.set_num_threads(2)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

RENDER = (60, 80)
IMAGE = (120, 160)
N_POINTS = 128
GRID = 72
# Gradients: max |port - JAX| of each tensor against its largest |JAX| entry,
# measured <= 2e-5 on the CPU (float32 convolutions summed in other orders).
# A gradient is discontinuous where a ReLU input crosses 0 or the stem's
# max-pool changes its pick: a pre-activation within ~1e-5 of 0 passes its
# gradient in one framework and not in the other, which moves whole tensors
# by up to 11% of their largest entry while the loss agrees to 1e-5. The
# fixtures use batches (seeds 37, 41) on which no such decision moves the
# gradient; `test_torch_training_kinks.py` holds every batch of seeds 30-51
# to GRAD_REL once the port's ReLUs and pool decide as JAX's did.
GRAD_REL = 1e-4


def _batch(jdb, B, seed):
    K1 = jnp.asarray([[150.0, 0, IMAGE[1] / 2], [0, 150.0, IMAGE[0] / 2], [0, 0, 1]], jnp.float32)
    b = jax_synth_batch(jax.random.PRNGKey(seed), jdb.render_assets(), K1, n_objects=2,
                        batch_size=B, resolution=IMAGE, z_range=(0.35, 0.45), xy_extent=0.03)
    return {k: np.asarray(v) for k, v in b._asdict().items()}


def _torch_batch(b):
    return PoseTrainingBatch(images=t(b["images"]), K=t(b["K"]), obj_ids=t(b["obj_ids"]).long(),
                             TCO_gt=t(b["TCO_gt"]))


def _world(role, B, seed, batch_seed=None, **cfg_kw):
    """Both models (the port's with the Flax weights from `seed`), both
    worlds, a batch (from `batch_seed`, default `seed`)."""
    jdb, tdb = mesh_dbs()
    kw = dict(render_size=RENDER, **cfg_kw)
    if role == "coarse":
        kw.update(predict_pose_update=False, predict_rendered_views_logits=True)
    jmodel = JaxPosePredictor(JaxConfig(backbone="wide_resnet18", renderer="reference", **kw))
    j_assets, j_meshes = jdb.render_assets(), jdb.batched(n_points=N_POINTS)
    b = _batch(jdb, B, seed if batch_seed is None else batch_seed)
    variables = perturb(jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(b["images"]), jnp.asarray(b["K"]),
        jnp.asarray(b["obj_ids"]), jnp.asarray(b["TCO_gt"]), j_assets,
        j_meshes.select(jnp.asarray(b["obj_ids"]))), seed=seed)
    model = PosePredictor(PosePredictorConfig(backbone="wide_resnet18", **kw))
    model.load_state_dict(pose_predictor_state_dict(variables))
    return dict(jmodel=jmodel, j_assets=j_assets, j_meshes=j_meshes, variables=variables,
                model=model, assets=tdb.render_assets(device="cpu"),
                meshes=tdb.batched(n_points=N_POINTS, device="cpu"), batch=b)


def _jax_step(w, jax_loss_fn, rng):
    """JAX's loss, metrics, gradients and new batch stats, as numpy."""
    b = w["batch"]
    jbatch = jax_fl.PoseTrainingBatch(**{k: jnp.asarray(v) for k, v in b.items()})

    @jax.jit
    def step(params, stats):
        return jax.value_and_grad(
            lambda p: jax_loss_fn({"params": p, "batch_stats": stats}, jbatch, rng), has_aux=True
        )(params)

    (loss, (metrics, new_stats)), grads = step(w["variables"]["params"], w["variables"]["batch_stats"])
    as_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    return float(loss), {k: float(v) for k, v in metrics.items()}, as_np(grads), as_np(new_stats)


def _port_step(w, loss_fn, draws):
    model = w["model"]
    model.zero_grad(set_to_none=True)
    loss, metrics = loss_fn(_torch_batch(w["batch"]), draws)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return loss.item(), {k: v.item() for k, v in metrics.items()}, grads, {
        n: b.clone() for n, b in model.named_buffers()}


@pytest.fixture(scope="module")
def refiner_run():
    w = _world("refiner", B=4, seed=21, batch_seed=37)
    rng = jax.random.PRNGKey(REFINER_KEY)
    ref = _jax_step(w, jax_fl.make_refiner_loss_fn(
        w["jmodel"], w["j_assets"], w["j_meshes"], n_iterations=2), rng)
    out = _port_step(w, make_refiner_loss_fn(w["model"], w["assets"], w["meshes"], n_iterations=2),
                     jax_noise_draws(rng, 4))
    return w, ref, out


REFINER_KEY = 137


@pytest.fixture(scope="module")
def grid_run():
    n_hyp = 4
    w = _world("coarse", B=2, seed=23, batch_seed=41)
    rng = jax.random.PRNGKey(141)
    ref = _jax_step(w, jax_fl.make_coarse_grid_loss_fn(
        w["jmodel"], w["j_assets"], w["j_meshes"], n_hypotheses=n_hyp, so3_grid_size=GRID), rng)
    k_noise, k_grid = jax.random.split(rng)
    draws = jax_noise_draws(k_noise, 2)
    draws["gidx"] = t(jax.random.randint(k_grid, (2, n_hyp - 1), 0, GRID)).long()
    out = _port_step(w, make_coarse_grid_loss_fn(
        w["model"], w["assets"], w["meshes"], n_hypotheses=n_hyp, so3_grid_size=GRID), draws)
    return w, ref, out


RUNS = ["refiner_run", "grid_run"]


@pytest.mark.parametrize("run", RUNS)
def test_loss_and_metrics_match_jax(run, request):
    """The loss to 1e-5 relative and every metric of the loss function
    (per-iteration losses; accuracy and top-1 of the grid loss) equal to
    JAX's to 1e-5."""
    _, (loss_ref, metrics_ref, _, _), (loss, metrics, _, _) = request.getfixturevalue(run)
    np.testing.assert_allclose(loss, loss_ref, rtol=1e-5)
    assert sorted(metrics) == sorted(metrics_ref)
    for k in metrics:
        np.testing.assert_allclose(metrics[k], metrics_ref[k], rtol=1e-5, atol=1e-6, err_msg=k)
    assert loss > 1e-3


@pytest.mark.parametrize("run", RUNS)
def test_gradients_match_jax(run, request):
    """The gradient of the loss with respect to every parameter: max
    |port - JAX| <= GRAD_REL x the tensor's largest |JAX| entry."""
    w, (_, _, grads_ref, stats_ref), (_, _, grads, _) = request.getfixturevalue(run)
    ref = pose_predictor_state_dict({"params": grads_ref, "batch_stats": stats_ref})
    assert sorted(grads) == sorted(k for k in ref if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked")))
    worst = {}
    for name, g in grads.items():
        scale = ref[name].abs().max().item()
        assert scale > 0, name
        worst[name] = (g - ref[name]).abs().max().item() / scale
    assert max(worst.values()) <= GRAD_REL, sorted(worst.items(), key=lambda kv: -kv[1])[:5]


@pytest.mark.parametrize("run", RUNS)
def test_batchnorm_running_statistics_match_jax(run, request):
    """After the step's train-mode forward (two iterations carried through
    for the refiner) the running means and variances equal Flax's to 1e-5:
    the variance is moved towards the biased batch variance, as Flax does
    (`nn.BatchNorm2d` would use the unbiased one, n / (n - 1) larger: 1.3%
    at the last stage's 2x3 map and B = 4)."""
    w, (_, _, grads_ref, stats_ref), (_, _, _, buffers) = request.getfixturevalue(run)
    ref = pose_predictor_state_dict({"params": grads_ref, "batch_stats": stats_ref})
    before = pose_predictor_state_dict(w["variables"])
    n_moved = 0
    for name, b in buffers.items():
        if name.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(b.numpy(), ref[name].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
        n_moved += not torch.allclose(b, before[name])
    assert n_moved == len([k for k in buffers if k.endswith(("running_mean", "running_var"))])


def test_last_stage_variance_is_the_biased_one(refiner_run):
    """The last block's second BatchNorm sees a 2x3 map: n = B x 6 = 24
    values a channel a call, two calls. Its running variance is Flax's to
    1e-5; the unbiased update of `nn.BatchNorm2d` would put it n / (n - 1)
    further along (4.3% of the move), off by more than 1e-4 on most
    channels."""
    w, (_, _, grads_ref, stats_ref), (_, _, _, buffers) = refiner_run
    name = "backbone.blocks.7.bn2.running_var"
    ref = pose_predictor_state_dict({"params": grads_ref, "batch_stats": stats_ref})[name]
    before = pose_predictor_state_dict(w["variables"])[name]
    got = buffers[name]
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5)
    n = 4 * 2 * 3
    unbiased = 0.81 * before + (got - 0.81 * before) * n / (n - 1)
    assert ((unbiased - ref).abs() > 1e-4 * ref.abs()).float().mean() > 0.9


def test_multiview_coarse_loss_matches_jax():
    """The reference's multiview coarse loss (sphere-26 x 4 in-plane
    views, 2 hypotheses, forced positive) on JAX's draws: the loss and the
    accuracy to 1e-5."""
    n_hyp = 2
    w = _world("coarse", B=2, seed=25)
    rng = jax.random.PRNGKey(26)
    jloss = jax_fl.make_coarse_loss_fn(w["jmodel"], w["j_assets"], w["j_meshes"],
                                       n_hypotheses=n_hyp)
    b = w["batch"]
    jbatch = jax_fl.PoseTrainingBatch(**{k: jnp.asarray(v) for k, v in b.items()})
    loss_ref, (metrics_ref, _) = jax.jit(lambda v: jloss(v, jbatch, rng))(w["variables"])
    k_noise, k_perm, k_inc, k_slot = jax.random.split(rng, 4)
    draws = jax_noise_draws(k_noise, 2)
    draws["perm"] = t(jax.vmap(lambda k: jax.random.permutation(k, 104)[:n_hyp])(
        jax.random.split(k_perm, 2))).long()
    draws["include"] = t(jax.random.uniform(k_inc, (2,)) < 0.7)
    draws["slot"] = t(jax.random.randint(k_slot, (2,), 0, n_hyp)).long()
    with torch.no_grad():
        loss, metrics = make_coarse_loss_fn(w["model"], w["assets"], w["meshes"],
                                            n_hypotheses=n_hyp)(_torch_batch(b), draws)
    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=1e-5)
    np.testing.assert_allclose(metrics["coarse_acc"].item(), float(metrics_ref["coarse_acc"]))


def test_bfloat16_refiner_loss_close_to_jax_and_to_float32(refiner_run):
    """`compute_dtype="bfloat16"`: the backbone under `torch.autocast` and
    the crop's products in bfloat16, the heads in float32. The port's loss
    lies within 2% of JAX's bfloat16 loss and of its own float32 loss
    (bfloat16 keeps 8 bits: the features carry ~0.4% noise through 17
    layers, and the loss averages it over points and samples), and the
    parameters keep float32 gradients."""
    w, (loss32_ref, _, _, _), (loss32, _, _, _) = refiner_run
    rng = jax.random.PRNGKey(REFINER_KEY)
    jmodel = JaxPosePredictor(dataclasses.replace(w["jmodel"].cfg, compute_dtype="bfloat16"))
    b = w["batch"]
    jbatch = jax_fl.PoseTrainingBatch(**{k: jnp.asarray(v) for k, v in b.items()})
    jloss = jax_fl.make_refiner_loss_fn(jmodel, w["j_assets"], w["j_meshes"], n_iterations=2)
    loss_ref = float(jax.jit(lambda v: jloss(v, jbatch, rng)[0])(w["variables"]))

    model = PosePredictor(dataclasses.replace(w["model"].cfg, compute_dtype="bfloat16"))
    model.load_state_dict(pose_predictor_state_dict(w["variables"]))
    loss, _ = make_refiner_loss_fn(model, w["assets"], w["meshes"], n_iterations=2)(
        _torch_batch(b), jax_noise_draws(rng, 4))
    loss.backward()
    assert np.isfinite(loss.item()) and loss.dtype == torch.float32
    assert all(p.grad.dtype == torch.float32 for p in model.parameters())
    np.testing.assert_allclose(loss.item(), loss_ref, rtol=2e-2)
    np.testing.assert_allclose(loss.item(), loss32, rtol=2e-2)
    np.testing.assert_allclose(loss_ref, loss32_ref, rtol=2e-2)
    assert loss.item() != loss32


def test_iterations_do_not_train_each_other(refiner_run):
    """Iteration 2's gradient is the same whether its input pose is
    iteration 1's output as computed or a copy cut from the graph: the
    input pose is detached (JAX: `stop_gradient`), so iteration 2 does not
    train iteration 1, and no gradient reaches the input pose."""
    w = refiner_run[0]
    model = PosePredictor(w["model"].cfg)
    model.load_state_dict(pose_predictor_state_dict(w["variables"]))
    model.train()
    b = _torch_batch(w["batch"])
    inst = w["meshes"].select(b.obj_ids)
    TCO0 = b.TCO_gt.clone().requires_grad_(True)
    o1 = model._iteration(b.images, b.K, b.obj_ids, TCO0, w["assets"], inst)
    assert o1.TCO_output.requires_grad and not o1.TCO_input.requires_grad
    params = list(model.parameters())
    grads = []
    for T in (o1.TCO_output, o1.TCO_output.detach().clone()):
        o2 = model._iteration(b.images, b.K, b.obj_ids, T, w["assets"], inst)
        loss = (o2.TCO_output - b.TCO_gt).abs().sum()
        grads.append(torch.autograd.grad(loss, params, retain_graph=True, allow_unused=True))
    for g_attached, g_cut in zip(*grads):
        assert torch.equal(g_attached, g_cut)
    (o1.TCO_output.sum()).backward()
    assert TCO0.grad is None
