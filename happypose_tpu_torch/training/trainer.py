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
- Adam / AdamW are `torch.optim`'s, which equal optax's defaults (eps 1e-8
  outside the square root, decoupled weight decay scaled by the rate);
- the rate is read from the schedule at the count of applied updates;
- a step whose loss or unclipped gradient norm is not finite changes
  nothing: no update, the count stays, and the BatchNorm running statistics
  (written by the forward) are put back.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from happypose_tpu_torch.models.backbones import BatchNorm2d
from happypose_tpu_torch.parallel.mesh import shard_leading
from happypose_tpu_torch.training.forward_loss import Draws, LossFn, PoseTrainingBatch


def make_lr_schedule(
    base_lr: float,
    n_warmup_steps: int,
    total_steps: int,
    decay_steps: Sequence[int] = (),
    decay_factor: float = 0.1,
) -> Callable[[int], float]:
    """Linear warmup + step decay: the rate of update `step` (0-based)."""
    del total_steps  # the JAX schedule takes it too, and reads it nowhere

    def schedule(step: int) -> float:
        warm = min((step + 1) / max(n_warmup_steps, 1), 1.0)
        decay = 1.0
        for s in decay_steps:
            if step >= s:
                decay *= decay_factor
        return base_lr * warm * decay

    return schedule


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every entry (`optax.global_norm`)."""
    return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(t) for t in tensors]))


@dataclass
class Optimizer:
    """Adam or AdamW behind the global-norm clip, at the schedule's rate."""

    adam: torch.optim.Optimizer
    schedule: Callable[[int], float]
    clip_grad_norm: Optional[float]
    count: int = 0  # applied updates

    def apply(self, grad_norm: torch.Tensor) -> None:
        """Clip the parameters' `.grad` by `grad_norm` (their global norm)
        and take one step."""
        params = [p for g in self.adam.param_groups for p in g["params"] if p.grad is not None]
        if self.clip_grad_norm is not None:
            scale = self.clip_grad_norm / torch.clamp(grad_norm, min=self.clip_grad_norm)
            for p in params:
                p.grad.mul_(scale)
        for g in self.adam.param_groups:
            g["lr"] = self.schedule(self.count)
        self.adam.step()
        self.count += 1

    def state_dict(self) -> dict:
        return {"adam": self.adam.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.adam.load_state_dict(state["adam"])
        self.count = int(state["count"])


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


@torch.no_grad()
def _snapshot(tensors: Iterable[torch.Tensor]) -> Callable[[], None]:
    """Copies of `tensors` (one `_foreach_copy_` a dtype, not one copy a
    tensor); returns the function that writes them back."""
    groups: Dict[torch.dtype, List[torch.Tensor]] = {}
    for x in tensors:
        groups.setdefault(x.dtype, []).append(x)
    saved = {d: [torch.empty_like(x) for x in xs] for d, xs in groups.items()}
    for d, xs in groups.items():
        torch._foreach_copy_(saved[d], xs)

    @torch.no_grad()
    def restore() -> None:
        for d, xs in groups.items():
            torch._foreach_copy_(xs, saved[d])

    return restore


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


def make_train_step(loss_fn: LossFn, mesh: Optional[DeviceMesh] = None, axis: str = "dp"):
    """`step(state, batch, draws) -> metrics` (floats): forward, backward,
    clip and update in place, or skip a non-finite step. Metrics are the
    loss function's, `loss`, `grad_norm` (0 for a skipped step) and
    `skipped_nonfinite`.

    With `mesh`, `batch` and `draws` are this rank's blocks
    (`split_batch_for_mesh`), the model's BatchNorms named for `axis` sync
    over its group, and gradients, loss and metrics are averaged over it, so
    every rank takes the same step: the step on the whole batch."""
    group = size = None
    if mesh is not None:
        group, size = mesh.get_group(axis), mesh.size(mesh.mesh_dim_names.index(axis))

    def step(state: TrainState, batch: PoseTrainingBatch, draws: Draws) -> Dict[str, float]:
        model, opt = state.model, state.optimizer
        restore_buffers = _snapshot(model.buffers())
        opt.adam.zero_grad(set_to_none=True)
        with (_synced_batchnorm(model, group, axis) if mesh is not None
              else contextlib.nullcontext()):
            loss, metrics = loss_fn(batch, draws)
            loss.backward()
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        if mesh is not None:
            _all_reduce_mean(grads, group, size)
            keys = sorted(metrics)
            avg = torch.stack([loss.detach()] + [metrics[k].detach().float() for k in keys])
            _all_reduce_mean([avg], group, size)
            loss, metrics = avg[0], dict(zip(keys, avg[1:]))
        grad_norm = global_norm(grads)
        ok = bool(torch.isfinite(loss) & torch.isfinite(grad_norm))
        if ok:
            opt.apply(grad_norm)
        else:
            restore_buffers()
        state.step += 1
        out = {k: v.item() for k, v in metrics.items()}
        out["loss"] = loss.item() if ok else 0.0
        out["grad_norm"] = grad_norm.item() if ok else 0.0
        out["skipped_nonfinite"] = 0.0 if ok else 1.0
        return out

    return step


def split_batch_for_mesh(batch: Any, mesh: DeviceMesh, axis: str = "dp") -> Any:
    """This rank's contiguous block of the leading axis of every tensor of
    `batch` (a `PoseTrainingBatch`, the step's draws); the leading size
    must divide by the axis size."""
    return shard_leading(batch, mesh, axis)
