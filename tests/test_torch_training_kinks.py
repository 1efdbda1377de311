"""Why the gradient parity of `test_torch_training_grads.py` holds on some
seeded batches and not on others: the witness.

On most batches the port's gradient and JAX's differ by 1-20% of a tensor's
largest entry while the loss agrees to 1e-5. The cause is a kink of the
network: a ReLU input (every BatchNorm output of the pre-activation
WideResNet) within float32 rounding of 0, or a near-tie of the stem's
max-pool, decides the other way in the two frameworks, and the gradient
jumps. Each test here runs JAX's own loss function (jitted once a role,
with every BatchNorm output of the step kept) and the port's on the same
batch, then a second port pass in which each ReLU and the max-pool decide
as JAX did (a shift cut from the graph moves the few pre-activations whose
sign differs to JAX's value; the pool takes JAX's argmax). It holds that:

- every sign that differs lies within 1e-4 of 0 (rounding, not a fault);
- where no decision differs, the gradients agree to `GRAD_REL` unpinned;
- pinned, they agree to `GRAD_REL` on every batch.

So nothing but those decisions separates the two gradients, on every
seed the parity test once chose among. The refiner runs one iteration here
(a single Flax call, no `nn.scan`; iteration 2 adds only the rounding of
its input pose), the grid loss its one call on B x 4 hypotheses.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from happypose_tpu.training import forward_loss as jax_fl
from happypose_tpu_torch.models.backbones import BatchNorm2d
from happypose_tpu_torch.training.forward_loss import (
    make_coarse_grid_loss_fn, make_refiner_loss_fn,
)
from happypose_tpu_torch.utils.weights_from_jax import pose_predictor_state_dict
from test_torch_models import mesh_dbs
from test_torch_training import jax_noise_draws, t
from test_torch_training_grads import GRAD_REL, GRID, REFINER_KEY, _batch, _torch_batch, _world

torch.set_num_threads(2)

# A sign that differs between the frameworks must be this close to 0: the
# largest measured on the CPU is 2.7e-5 (float32 convolutions summed in
# other orders over up to 9 x 512 terms). Measured on the CPU over the 22
# batches: 0-4 differing signs a batch, gradients 1e-5 to 0.11 apart
# unpinned and at most 5.1e-5 pinned.
KINK_ATOL = 1e-4
N_HYP = 4


class _Capturing:
    """Stands in for the Flax model inside JAX's loss function: the same
    `apply`, which also returns every BatchNorm output, in call order,
    under `batch_stats["_acts"]` (the loss hands `batch_stats` back)."""

    def __init__(self, model):
        self.model = model

    def apply(self, variables, *args, **kw):
        acts = []

        def keep(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            if isinstance(context.module, fnn.BatchNorm) and context.method_name == "__call__":
                acts.append(out)
            return out

        with fnn.intercept_methods(keep):
            out, state = self.model.apply(variables, *args, **kw)
        return out, {**state, "batch_stats": {**state["batch_stats"], "_acts": tuple(acts)}}


def _jax_step_fn(w, loss_fn):
    """Jitted once: (params, stats, batch arrays) -> loss, gradients, the
    BatchNorm outputs (NHWC)."""

    rng = jax.random.PRNGKey(w["rng"])

    @jax.jit
    def step(params, stats, batch):
        def f(p):
            loss, (_, new_stats) = loss_fn({"params": p, "batch_stats": stats},
                                           jax_fl.PoseTrainingBatch(**batch), rng)
            return loss, new_stats["_acts"]
        (loss, acts), grads = jax.value_and_grad(f, has_aux=True)(params)
        return loss, grads, acts

    return step


def _pin(model, jax_acts):
    """Forward hooks that make the port's ReLUs and max-pool decide as JAX's
    did: returns the hook handles and a record of the signs that differed
    (count, largest |JAX value| among them)."""
    queue = [torch.from_numpy(np.asarray(a)).permute(0, 3, 1, 2) for a in jax_acts]
    stem = queue[0]
    record = []

    def bn_hook(mod, args, out):
        ref = queue.pop(0)
        assert ref.shape == out.shape
        flip = (out > 0) != (ref > 0)
        record.append((int(flip.sum()), float(ref[flip].abs().max()) if flip.any() else 0.0))
        return out + torch.where(flip, ref - out, 0).detach()

    def pool_hook(mod, args, out):
        _, idx = F.max_pool2d(torch.relu(stem), 3, 2, 1, return_indices=True)
        x = args[0]
        return x.flatten(2).gather(2, idx.flatten(2)).view_as(out)

    handles = [m.register_forward_hook(bn_hook) for m in model.modules()
               if isinstance(m, BatchNorm2d)]
    handles += [m.register_forward_hook(pool_hook) for m in model.modules()
                if isinstance(m, torch.nn.MaxPool2d)]
    return handles, record


def _grads(model, loss_fn, batch, draws):
    model.zero_grad(set_to_none=True)
    loss, _ = loss_fn(batch, draws)
    loss.backward()
    return {n: p.grad.clone() for n, p in model.named_parameters()}


def _worst(grads, ref):
    return max((g - ref[n]).abs().max().item() / ref[n].abs().max().item()
               for n, g in grads.items())


@pytest.fixture(scope="module")
def refiner_witness():
    w = _world("refiner", B=4, seed=21, batch_seed=37)
    w["rng"] = REFINER_KEY
    step = _jax_step_fn(w, jax_fl.make_refiner_loss_fn(
        _Capturing(w["jmodel"]), w["j_assets"], w["j_meshes"], n_iterations=1))
    loss_fn = make_refiner_loss_fn(w["model"], w["assets"], w["meshes"], n_iterations=1)
    draws = jax_noise_draws(jax.random.PRNGKey(REFINER_KEY), 4)
    return w, step, loss_fn, draws, 4


@pytest.fixture(scope="module")
def grid_witness():
    w = _world("coarse", B=2, seed=23, batch_seed=41)
    w["rng"] = 141
    step = _jax_step_fn(w, jax_fl.make_coarse_grid_loss_fn(
        _Capturing(w["jmodel"]), w["j_assets"], w["j_meshes"], n_hypotheses=N_HYP,
        so3_grid_size=GRID))
    k_noise, k_grid = jax.random.split(jax.random.PRNGKey(141))
    draws = jax_noise_draws(k_noise, 2)
    draws["gidx"] = t(jax.random.randint(k_grid, (2, N_HYP - 1), 0, GRID)).long()
    loss_fn = make_coarse_grid_loss_fn(w["model"], w["assets"], w["meshes"],
                                       n_hypotheses=N_HYP, so3_grid_size=GRID)
    return w, step, loss_fn, draws, 2


def _witness(fixture, seed):
    w, step, loss_fn, draws, B = fixture
    b = _batch(mesh_dbs()[0], B, seed)
    loss_ref, grads_ref, acts = step(w["variables"]["params"], w["variables"]["batch_stats"],
                                     {k: jnp.asarray(v) for k, v in b.items()})
    ref = pose_predictor_state_dict({"params": jax.tree.map(np.asarray, grads_ref),
                                     "batch_stats": w["variables"]["batch_stats"]})
    model = w["model"]
    state = {k: v.clone() for k, v in model.state_dict().items()}
    unpinned = _worst(_grads(model, loss_fn, _torch_batch(b), draws), ref)
    model.load_state_dict(state)
    handles, record = _pin(model, acts)
    try:
        pinned = _worst(_grads(model, loss_fn, _torch_batch(b), draws), ref)
    finally:
        for h in handles:
            h.remove()
        model.load_state_dict(state)
    assert len(record) == len(acts) == 17  # every BatchNorm of WideResNet18, once
    return unpinned, pinned, record


def _check(unpinned, pinned, record):
    n_flips = sum(n for n, _ in record)
    assert max(m for _, m in record) <= KINK_ATOL, record
    assert pinned <= GRAD_REL, (pinned, unpinned, record)
    if n_flips == 0:
        assert unpinned <= GRAD_REL, (unpinned, record)


@pytest.mark.parametrize("seed", range(30, 40))
def test_refiner_gradients_differ_only_at_kinks(refiner_witness, seed):
    """The one-iteration refiner loss on the batches of seeds 30-39."""
    _check(*_witness(refiner_witness, seed))


@pytest.mark.parametrize("seed", range(40, 52))
def test_grid_gradients_differ_only_at_kinks(grid_witness, seed):
    """The coarse grid loss on the batches of seeds 40-51."""
    _check(*_witness(grid_witness, seed))
