"""The train step, on one device or data-parallel over a mesh axis
(PyTorch port of `happypose_tpu/training/trainer.py`).

Data-parallel, as JAX's `shard_map` step with its `pmean`s: each rank
takes its block of the batch and of the step's draws
(`split_batch_for_mesh`), its BatchNorms share the statistics of the
whole batch (`BatchNorm2d.group`, bound for the step), and after the
backward pass the gradients (in one flattened buffer a dtype), the loss
and the metrics are averaged over the axis's group. Clip and Adam step
then run identically on every rank. Explicit all-reduces stand in for
`DistributedDataParallel`: a loss function calls the model several times
in one graph, and this form is the one that mirrors `pmean`.

optax's semantics, written out where PyTorch's differ:
- the clip is `optax.clip_by_global_norm`: g * max / max(norm, max), not
  `clip_grad_norm_`'s max / (norm + 1e-6);
- Adam / AdamW is optax's update, written in `torch._foreach_*` operations
  on the parameters' device (`Optimizer.apply`): the moments, bias
  corrections from each parameter's step, eps outside the square root,
  decoupled weight decay scaled by the rate. A `torch.optim.Adam` / `AdamW`
  holds the hyperparameters and the state (`exp_avg`, `exp_avg_sq`,
  `step`) so that checkpoints keep its layout; its own `step()` is not
  called;
- the rate is read from the schedule at the count of applied updates, a
  tensor on the device;
- a step whose loss or unclipped gradient norm is not finite changes
  nothing: as JAX's `jnp.where(ok, new, old)`, the parameters, the
  BatchNorm buffers (written by the forward), Adam's moments and steps and
  the schedule's count keep their old values where `ok` is false, and the
  count stays.

The step reads nothing to the host: `ok` is a device value, and so are
the metrics until the public step reads them all in one transfer. On a
CUDA tensor the public step (`TrainStep`) is one CUDA graph replay a call
(`utils/cuda_graphs.py`, a training cache), the counterpart of JAX's
`jax.jit(_step)` / `jax.jit(shard_map(_step))`; on a CPU tensor it runs
the same body plainly. `TrainStep.eager` is that body outside any graph,
the graph's plain version.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from happypose_tpu_torch.models.backbones import BatchNorm2d
from happypose_tpu_torch.parallel.mesh import shard_leading
from happypose_tpu_torch.training.forward_loss import Draws, LossFn
from happypose_tpu_torch.utils.cuda_graphs import GraphCache, storage_of
from happypose_tpu_torch.utils.profiling import annotate



def make_lr_schedule(
    base_lr: float,
    n_warmup_steps: int,
    total_steps: int,
    decay_steps: Sequence[int] = (),
    decay_factor: float = 0.1,
) -> Callable:
    """Linear warmup + step decay: the rate of update `step` (0-based). A
    float of an int (computed in float64); a tensor of the tensor's dtype
    (float32 of an integer count) on its device, with no host read, as
    JAX's schedule computes it on a traced count."""
    del total_steps  # the JAX schedule takes it too, and reads it nowhere

    def schedule(step):
        if not isinstance(step, torch.Tensor):
            return float(schedule(torch.tensor(step, dtype=torch.float64)))
        warm = torch.clamp((step + 1) / max(n_warmup_steps, 1), max=1.0)
        decay = torch.ones_like(warm)
        for s in decay_steps:
            decay = torch.where(step >= s, decay * decay_factor, decay)
        return base_lr * warm * decay

    return schedule


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every entry (`optax.global_norm`)."""
    return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(t) for t in tensors]))


@torch.no_grad()
def _select_(ok: torch.Tensor, new: Sequence[torch.Tensor], old: Sequence[torch.Tensor],
             out: Sequence[torch.Tensor]) -> None:
    """out = where(ok, new, old), in place, for each triple (JAX's select
    of a skipped step)."""
    for n, o, t in zip(new, old, out):
        t.copy_(torch.where(ok, n, o))


@dataclass
class Optimizer:
    """Adam or AdamW behind the global-norm clip, at the schedule's rate.
    `adam` holds the parameters, the hyperparameters and the per-parameter
    state; the update is `apply`'s."""

    adam: torch.optim.Optimizer
    schedule: Callable
    clip_grad_norm: Optional[float]
    _count: torch.Tensor = field(default=None, repr=False)  # applied updates, on the device

    @property
    def count(self) -> int:
        """The applied updates (a host read of the device count)."""
        return 0 if self._count is None else int(self._count)

    @count.setter
    def count(self, value: int) -> None:
        self.init_state()
        self._count.fill_(int(value))

    def _params(self) -> List[nn.Parameter]:
        return [p for g in self.adam.param_groups for p in g["params"]]

    @torch.no_grad()
    def init_state(self) -> None:
        """Adam's zero moments and step 0 for every parameter without them
        (optax's `init`), and each state tensor and the count on its
        parameter's device; idempotent. The train step calls it before its
        key is made, so that a capture never allocates the state."""
        params = self._params()
        device = params[0].device
        if self._count is None:
            self._count = torch.zeros((), dtype=torch.int64, device=device)
        elif self._count.device != device:
            self._count = self._count.to(device)
        for p in params:
            st = self.adam.state[p]
            if not st:
                st.update(step=torch.zeros((), dtype=torch.float32, device=p.device),
                          exp_avg=torch.zeros_like(p), exp_avg_sq=torch.zeros_like(p))
            for k, v in st.items():
                if v.device != p.device:
                    st[k] = v.to(p.device)

    def state_tensors(self) -> List[torch.Tensor]:
        """The tensors `apply` updates besides the parameters: the count and
        every state tensor, in a fixed order."""
        self.init_state()
        return [self._count] + [v for p in self._params() for v in self.adam.state[p].values()]

    @torch.no_grad()
    def apply(self, grad_norm: torch.Tensor, ok: Optional[torch.Tensor] = None) -> None:
        """Clip the parameters' `.grad` by `grad_norm` (their global norm)
        and take one step of optax's Adam / AdamW on the device. With `ok`
        (a device bool) the new parameters, moments, steps and count are
        kept only where it holds."""
        self.init_state()
        group = self.adam.param_groups[0]
        b1, b2 = group["betas"]
        eps = group["eps"]
        wd = group["weight_decay"] if isinstance(self.adam, torch.optim.AdamW) else 0.0
        params = [p for p in self._params() if p.grad is not None]
        grads = [p.grad for p in params]
        state = [self.adam.state[p] for p in params]
        steps = [st["step"] for st in state]
        mu = [st["exp_avg"] for st in state]
        nu = [st["exp_avg_sq"] for st in state]
        if self.clip_grad_norm is not None:
            scale = self.clip_grad_norm / torch.clamp(grad_norm, min=self.clip_grad_norm)
            torch._foreach_mul_(grads, scale)
        lr = self.schedule(self._count)
        new_steps = torch._foreach_add(steps, 1.0)
        new_mu = torch._foreach_mul(mu, b1)
        torch._foreach_add_(new_mu, grads, alpha=1.0 - b1)
        new_nu = torch._foreach_mul(nu, b2)
        torch._foreach_addcmul_(new_nu, grads, grads, value=1.0 - b2)
        # bias corrections 1 - b^t of each parameter's step t
        bc1 = torch._foreach_pow(b1, new_steps)
        bc2 = torch._foreach_pow(b2, new_steps)
        for bc in (bc1, bc2):
            torch._foreach_neg_(bc)
            torch._foreach_add_(bc, 1.0)
        den = torch._foreach_div(new_nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        update = torch._foreach_div(new_mu, bc1)
        torch._foreach_div_(update, den)
        if wd:
            torch._foreach_add_(update, params, alpha=wd)
        torch._foreach_mul_(update, -lr)
        new_params = torch._foreach_add(params, update)
        new = [*new_params, *new_mu, *new_nu, *new_steps, self._count + 1]
        old = params + mu + nu + steps + [self._count]
        if ok is None:
            torch._foreach_copy_(old, new)
        else:
            _select_(ok, new, old, old)

    def state_dict(self) -> dict:
        return {"adam": self.adam.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.adam.load_state_dict(state["adam"])
        self.count = int(state["count"])  # and every step onto its parameter's device


def make_optimizer(
    params: Iterable[nn.Parameter],
    lr: float = 3e-4,
    n_warmup_steps: int = 500,
    total_steps: int = 100_000,
    decay_steps: Sequence[int] = (),
    weight_decay: float = 0.0,
    clip_grad_norm: Optional[float] = 10.0,
) -> Optimizer:
    """Adam (+ optional decoupled weight decay + gradient clipping), warmed up."""
    sched = make_lr_schedule(lr, n_warmup_steps, total_steps, decay_steps)
    params = list(params)
    adam = (
        torch.optim.AdamW(params, lr=sched(0), weight_decay=weight_decay)
        if weight_decay > 0 else torch.optim.Adam(params, lr=sched(0))
    )
    return Optimizer(adam, sched, clip_grad_norm)


@dataclass
class TrainState:
    """The model (parameters and BatchNorm statistics), its optimizer, and
    the count of steps taken, applied or skipped."""

    model: nn.Module
    optimizer: Optimizer
    step: int = 0


@contextlib.contextmanager
def _synced_batchnorm(model: nn.Module, group, axis: str) -> Iterator[None]:
    """Bind `group` to the BatchNorms of `model` named for `axis` while the
    step runs (the axis exists only inside JAX's shard_map too)."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm2d) and m.axis_name == axis]
    for m in bns:
        m.group = group
    try:
        yield
    finally:
        for m in bns:
            m.group = None


@torch.no_grad()
def _all_reduce_mean(tensors: List[torch.Tensor], group, size: int) -> None:
    """Average `tensors` over `group` in place: one flattened buffer and one
    `all_reduce` a dtype."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        flat /= size
        views = flat.split([t.numel() for t in ts])
        torch._foreach_copy_(ts, [v.view_as(t) for v, t in zip(views, ts)])


def _read(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The metrics as floats, in one host read."""
    with annotate("train.read"):
        values = torch.stack([v.detach().float() for v in metrics.values()]).tolist()
    return dict(zip(metrics, values))


class TrainStep:
    """`step(state, batch, draws) -> metrics` (floats): forward, backward,
    clip and update in place, or skip a non-finite step; one update a
    call. Metrics are the loss function's, `loss`, `grad_norm` (0 for a
    skipped step) and `skipped_nonfinite`.

    On CUDA tensors a call replays the graph of its key, captured by the
    key's first call (whose warm-up is that call's update); on CPU
    tensors it runs the body plainly (`GraphCache`). The key holds the
    loss function (its static choices, such as the refiner's iterations,
    are made when it is built), the model, the optimizer, the storage of
    the parameters, buffers and optimizer state, the precision and cuDNN
    flags and the specs of `batch` and `draws`. A data-parallel step on
    the card captures its NCCL collectives. `eager` is the body outside
    any graph. A call runs under the span `train.step`, the metrics' host
    read under `train.read`."""

    def __init__(self, loss_fn: LossFn, mesh: Optional[DeviceMesh] = None, axis: str = "dp"):
        self.loss_fn, self.mesh, self.axis = loss_fn, mesh, axis
        self.group = self.size = None
        if mesh is not None:
            self.group = mesh.get_group(axis)
            self.size = mesh.size(mesh.mesh_dim_names.index(axis))
        self.graphs = GraphCache("train", training=True)

    def body(self, state: TrainState, batch: Any, draws: Draws) -> Dict[str, torch.Tensor]:
        """One step on the device: the metrics as device tensors; no host
        read, so that a capture can hold it."""
        model, opt = state.model, state.optimizer
        with torch.no_grad():
            buffers = list(model.buffers())
            saved = [b.clone() for b in buffers]
        opt.adam.zero_grad(set_to_none=True)
        with (_synced_batchnorm(model, self.group, self.axis) if self.mesh is not None
              else contextlib.nullcontext()):
            loss, metrics = self.loss_fn(batch, draws)
            loss.backward()
        with torch.no_grad():
            grads = [p.grad for p in model.parameters() if p.grad is not None]
            loss = loss.detach()
            metrics = {k: v.detach().float() for k, v in metrics.items()}
            if self.mesh is not None:
                _all_reduce_mean(grads, self.group, self.size)
                keys = sorted(metrics)
                avg = torch.stack([loss] + [metrics[k] for k in keys])
                _all_reduce_mean([avg], self.group, self.size)
                loss, metrics = avg[0], dict(zip(keys, avg[1:]))
            grad_norm = global_norm(grads)
            ok = torch.isfinite(loss) & torch.isfinite(grad_norm)
            opt.apply(grad_norm, ok)
            _select_(ok, buffers, saved, buffers)
            metrics["loss"] = torch.where(ok, loss, torch.zeros_like(loss))
            metrics["grad_norm"] = torch.where(ok, grad_norm, torch.zeros_like(grad_norm))
            metrics["skipped_nonfinite"] = (~ok).float()
        return metrics

    def eager(self, state: TrainState, batch: Any, draws: Draws) -> Dict[str, float]:
        """The step outside any graph (the graph's plain version)."""
        state.optimizer.init_state()
        out = self.body(state, batch, draws)
        state.step += 1
        return _read(out)

    def __call__(self, state: TrainState, batch: Any, draws: Draws) -> Dict[str, float]:
        with annotate("train.step"):
            opt = state.optimizer
            key = ("train_step", storage_of(state.model),
                   tuple(t.data_ptr() for t in opt.state_tensors()))
            out = self.graphs(key, lambda b, d: self.body(state, b, d), (batch, draws),
                              captured=(self.loss_fn, state.model, opt))
            state.step += 1
            return _read(out)


def make_train_step(loss_fn: LossFn, mesh: Optional[DeviceMesh] = None,
                    axis: str = "dp") -> TrainStep:
    """The train step of `loss_fn` (`TrainStep`): `step(state, batch,
    draws) -> metrics` (floats).

    With `mesh`, `batch` and `draws` are this rank's blocks
    (`split_batch_for_mesh`), the model's BatchNorms named for `axis` sync
    over its group, and gradients, loss and metrics are averaged over it, so
    every rank takes the same step: the step on the whole batch."""
    return TrainStep(loss_fn, mesh, axis)


def split_batch_for_mesh(batch: Any, mesh: DeviceMesh, axis: str = "dp") -> Any:
    """This rank's contiguous block of the leading axis of every tensor of
    `batch` (a `PoseTrainingBatch`, the step's draws); the leading size
    must divide by the axis size."""
    return shard_leading(batch, mesh, axis)
