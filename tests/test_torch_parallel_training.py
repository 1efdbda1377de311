"""Data-parallel training in the port, on two spawned gloo ranks: the
synchronized BatchNorm, the train step with a mesh, and
`run_pose_training --dp`, against one rank on the whole batch and against
JAX (see `tests/test_torch_parallel.py` for the spawning and why this
module imports no JAX at module level).

Tolerances, and why:
- BatchNorm: outputs and input gradients within 1e-6 of their largest
  value of a float64 run on the whole batch, the parameters' gradients and
  the running statistics within 1e-5 relative; JAX's `BatchNorm(axis_name=)`
  under `shard_map` within 1e-5 of the port (Flax takes E[x^2] - E[x]^2, the
  port merges the ranks' means and variances exactly);
- the train step: the loss 1e-5 relative, every gradient within
  `GRAD_REL` (1e-4) of its tensor's largest entry, against the port's
  one-rank step and JAX's one-device step on the whole batch
  (`tests/test_torch_training_grads.py`'s seeds, on which no ReLU decides
  differently); BatchNorm statistics 1e-5 relative. Parameters after the
  Adam step are not compared (a first step is about lr x sign(g));
- the CLI: the 2-rank run's logged loss and gradient norm are the 1-rank
  run's to 1e-5 relative.
"""

import copy
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from happypose_tpu_torch.models.backbones import BatchNorm2d
from happypose_tpu_torch.models.pose_predictor import PosePredictor
from happypose_tpu_torch.parallel import make_mesh
from happypose_tpu_torch.scripts import run_pose_training
from happypose_tpu_torch.training import TrainState, make_optimizer, make_train_step
from happypose_tpu_torch.training.forward_loss import PoseTrainingBatch, make_refiner_loss_fn
from happypose_tpu_torch.training.trainer import split_batch_for_mesh
from test_torch_parallel import spawn

WORLD = 2
GRAD_REL = 1e-4
CLI_ARGS = ["--data", "synth", "--epochs", "1", "--epoch-size", "8", "--batch-size", "4",
            "--image-size", "48", "64", "--render-size", "24", "32", "--n-iterations", "2",
            "--device", "cpu"]


def _bn_run(x, weight, bias, g, group=None, dtype=torch.float32):
    """Train-mode BatchNorm of x with upstream gradient g: output, the
    gradients of x, weight and bias, the running statistics."""
    bn = BatchNorm2d(x.shape[1], eps=1e-5, momentum=0.1).to(dtype)
    with torch.no_grad():
        bn.weight.copy_(weight)
        bn.bias.copy_(bias)
    bn.group = group
    x = x.to(dtype).requires_grad_(True)
    y = bn.train()(x)
    (y * g.to(dtype)).sum().backward()
    return dict(y=y.detach(), dx=x.grad, dw=bn.weight.grad, db=bn.bias.grad,
                mean=bn.running_mean.clone(), var=bn.running_var.clone())


def _rank_body(rank, world, inputs):
    out = {}
    mesh = make_mesh((world,), ("dp",), device_type="cpu")
    group = mesh.get_group("dp")

    # the synchronized BatchNorm on this rank's block
    bn = inputs["bn"]
    blk = lambda k: split_batch_for_mesh(torch.from_numpy(bn[k]), mesh)  # noqa: E731
    out["bn"] = _bn_run(blk("x"), torch.from_numpy(bn["w"]), torch.from_numpy(bn["b"]),
                        blk("g"), group=group)

    # the train step on this rank's block of the batch and of the draws
    st = inputs["step"]
    model = PosePredictor(dataclasses.replace(st["cfg"], bn_axis_name="dp"))
    model.load_state_dict(st["state_dict"])
    loss_fn = make_refiner_loss_fn(model, st["assets"], st["meshes"], n_iterations=2)
    state = TrainState(model, make_optimizer(model.parameters(), clip_grad_norm=None))
    step = make_train_step(loss_fn, mesh=mesh, axis="dp")
    metrics = step(state, split_batch_for_mesh(st["batch"], mesh),
                   split_batch_for_mesh(st["draws"], mesh))
    out["step"] = dict(metrics=metrics,
                       grads={n: p.grad.clone() for n, p in model.named_parameters()},
                       buffers={n: b.clone() for n, b in model.named_buffers()})

    # the CLI: every rank trains, only rank 0 writes (its own run directory
    # here, so that a write by rank 1 would show)
    run_pose_training.main(["--run-dir", os.path.join(inputs["cli_dir"], f"rank{rank}"),
                            "--dp"] + CLI_ARGS)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax

    from happypose_tpu.training import forward_loss as jax_fl
    from happypose_tpu_torch.utils.weights_from_jax import pose_predictor_state_dict
    from test_torch_training import jax_noise_draws
    from test_torch_training_grads import REFINER_KEY, _jax_step, _torch_batch, _world

    rs = np.random.RandomState(5)
    bn = dict(x=(rs.randn(8, 6, 5, 7) * 1.5 + 0.7).astype(np.float32),
              w=rs.uniform(0.5, 1.5, 6).astype(np.float32),
              b=rs.randn(6).astype(np.float32),
              g=rs.randn(8, 6, 5, 7).astype(np.float32))

    w = _world("refiner", B=4, seed=21, batch_seed=37)
    rng = jax.random.PRNGKey(REFINER_KEY)
    jax_ref = _jax_step(w, jax_fl.make_refiner_loss_fn(
        w["jmodel"], w["j_assets"], w["j_meshes"], n_iterations=2), rng)
    draws = jax_noise_draws(rng, 4)
    batch = _torch_batch(w["batch"])
    state_dict = copy.deepcopy(w["model"].state_dict())

    # the port's step on one rank, on the whole batch
    model = w["model"]
    state = TrainState(model, make_optimizer(model.parameters(), clip_grad_norm=None))
    one = make_train_step(make_refiner_loss_fn(model, w["assets"], w["meshes"], n_iterations=2))
    metrics = one(state, batch, draws)
    one_rank = dict(metrics=metrics,
                    grads={n: p.grad.clone() for n, p in model.named_parameters()},
                    buffers={n: b.clone() for n, b in model.named_buffers()})

    cli_dir = str(tmp_path_factory.mktemp("cli"))
    run_pose_training.main(["--run-dir", os.path.join(cli_dir, "one")] + CLI_ARGS)
    inputs = dict(bn=bn, cli_dir=cli_dir, step=dict(
        cfg=model.cfg, state_dict=state_dict, assets=w["assets"], meshes=w["meshes"],
        batch=PoseTrainingBatch(*batch), draws=draws))
    ranks = spawn(_rank_body, WORLD, str(tmp_path_factory.mktemp("world")), inputs)
    jax_stats = pose_predictor_state_dict({"params": jax_ref[2], "batch_stats": jax_ref[3]})
    return dict(ranks=ranks, bn=bn, jax_ref=jax_ref, jax_sd=jax_stats, one_rank=one_rank,
                cli_dir=cli_dir)


def _cat(ranks):
    return {k: torch.cat([r["bn"][k] for r in ranks]) for k in ("y", "dx")} | {
        k: sum(r["bn"][k] for r in ranks) for k in ("dw", "db")} | {
        k: ranks[0]["bn"][k] for k in ("mean", "var")}


def _jax_bn(bn):
    """Flax's `BatchNorm(axis_name="dp")` under `shard_map` over two
    virtual devices: output, the gradients of the summed `y * g` and the
    new running statistics, in the port's NCHW layout."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    mesh = Mesh(np.array(jax.devices("cpu")[:WORLD]), ("dp",))
    layer = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5, axis_name="dp")
    C = bn["x"].shape[1]
    params = {"scale": jnp.asarray(bn["w"]), "bias": jnp.asarray(bn["b"])}
    stats = {"mean": jnp.zeros(C), "var": jnp.ones(C)}

    def local(x, p):
        y, upd = layer.apply({"params": p, "batch_stats": stats}, x, mutable=["batch_stats"])
        return y, upd["batch_stats"]

    fwd = jax.shard_map(local, mesh=mesh, in_specs=(P("dp"), P()), out_specs=(P("dp"), P()))
    x = jnp.asarray(bn["x"].transpose(0, 2, 3, 1))
    g = jnp.asarray(bn["g"].transpose(0, 2, 3, 1))
    y, new_stats = fwd(x, params)
    dx, dp = jax.grad(lambda x, p: jnp.sum(fwd(x, p)[0] * g), argnums=(0, 1))(x, params)
    nchw = lambda a: torch.from_numpy(np.asarray(a).transpose(0, 3, 1, 2))  # noqa: E731
    return dict(y=nchw(y), dx=nchw(dx), dw=torch.from_numpy(np.asarray(dp["scale"])),
                db=torch.from_numpy(np.asarray(dp["bias"])),
                mean=torch.from_numpy(np.asarray(new_stats["mean"])),
                var=torch.from_numpy(np.asarray(new_stats["var"])))


def _rel(a, b):
    return ((a.double() - b.double()).abs().max() / b.double().abs().max()).item()


def test_synced_batchnorm_matches_float64_and_jax(runs):
    """Two ranks of 4 images each normalize with the statistics of all 8:
    output, input gradient (through the statistics of the other rank's
    images), the parameters' gradients summed over the ranks and the
    running statistics (Flax's update: 0.9 ra + 0.1 x the biased variance)
    equal a float64 run on the whole batch and JAX's synced BatchNorm."""
    bn = runs["bn"]
    got = _cat(runs["ranks"])
    ref64 = _bn_run(*(torch.from_numpy(bn[k]) for k in ("x", "w", "b", "g")), dtype=torch.float64)
    jax_out = _jax_bn(bn)
    for k in ("y", "dx"):
        assert _rel(got[k], ref64[k]) < 1e-6, k
    for k in ("dw", "db", "mean", "var"):
        assert _rel(got[k], ref64[k]) < 1e-5, k
    for k in got:
        assert _rel(got[k], jax_out[k]) < 1e-5, k
    np.testing.assert_array_equal(runs["ranks"][0]["bn"]["mean"], runs["ranks"][1]["bn"]["mean"])


def test_two_rank_step_equals_one_rank_step_and_jax(runs):
    """The refiner step (WideResNet18, 2 iterations, B = 4 split 2 + 2,
    JAX's draws split the same way): the averaged loss and metrics, every
    averaged gradient and the synced BatchNorm statistics equal the port's
    step on the whole batch on one rank and JAX's one-device step."""
    loss_ref, metrics_ref, _, _ = runs["jax_ref"]
    one = runs["one_rank"]
    jax_sd = runs["jax_sd"]
    for r in runs["ranks"]:
        m = r["step"]["metrics"]
        np.testing.assert_allclose(m["loss"], one["metrics"]["loss"], rtol=1e-5)
        np.testing.assert_allclose(m["loss"], loss_ref, rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm"], one["metrics"]["grad_norm"], rtol=1e-5)
        for k, v in metrics_ref.items():
            np.testing.assert_allclose(m[k], v, rtol=1e-5, atol=1e-6, err_msg=k)
        worst_one = max(_rel(g, one["grads"][n]) for n, g in r["step"]["grads"].items())
        worst_jax = max(_rel(g, jax_sd[n]) for n, g in r["step"]["grads"].items())
        assert worst_one <= GRAD_REL and worst_jax <= GRAD_REL, (worst_one, worst_jax)
        for n, b in r["step"]["buffers"].items():
            if n.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(b.numpy(), one["buffers"][n].numpy(), rtol=1e-5,
                                           atol=1e-6, err_msg=n)
                np.testing.assert_allclose(b.numpy(), jax_sd[n].numpy(), rtol=1e-5, atol=1e-6,
                                           err_msg=n)
    g0, g1 = (r["step"]["grads"] for r in runs["ranks"])
    assert all(torch.equal(g0[n], g1[n]) for n in g0)


def test_run_pose_training_dp_two_ranks(runs):
    """`run_pose_training --dp` on two ranks (a global batch of 4: 2 a
    rank) logs the 1-rank run's loss and gradient norm on the same seeds;
    only rank 0 writes its run directory."""
    d = runs["cli_dir"]
    assert not os.path.exists(os.path.join(d, "rank1"))
    logs = [json.loads(open(os.path.join(d, name, "log.txt")).read()) for name in ("rank0", "one")]
    for k in ("loss", "grad_norm", "loss_TCO_iter1", "loss_TCO_iter2"):
        np.testing.assert_allclose(logs[0][k], logs[1][k], rtol=1e-5, err_msg=k)
    assert logs[0]["epoch"] == 0 and logs[0]["skipped_nonfinite"] == 0.0
    for f in ("state_dict.pt", "optimizer.pt", "config.json", "epoch.json"):
        assert os.path.exists(os.path.join(d, "rank0", f)), f
