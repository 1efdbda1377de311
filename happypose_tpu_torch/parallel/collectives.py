"""Collectives: metric reduction, model sync, prediction gather, sharded
batched apply (PyTorch port of `happypose_tpu/parallel/collectives.py`;
the reference's `distributed.py:46-132` and `tensor_collection.py:166-187`).

Each JAX collective becomes the rank-local computation plus a collective
over a process group: `pmean` an `all_reduce` average, the hypothesis-axis
`shard_map` an `all_gather` of the ranks' blocks, `broadcast_one_to_all` a
`broadcast` from rank 0, `process_allgather` an `all_gather` stacked along
a new leading axis.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from happypose_tpu_torch.parallel.mesh import _axis, shard_leading, tree_map


def reduce_dict(
    metrics: Dict[str, Any], mesh: Optional[DeviceMesh] = None, axis: str = "dp",
) -> Dict[str, torch.Tensor]:
    """The average of every metric across the mesh axis's group (the whole
    world without a mesh), in one `all_reduce` of the stacked values: float32
    tensors on the device of the first tensor value (of the backend's
    device where all are floats). Every rank passes the same keys; a single
    process without a group gets its metrics back."""
    if mesh is None and not dist.is_initialized():
        return dict(metrics)
    group, size = (None, dist.get_world_size()) if mesh is None else _axis(mesh, axis)[:2]
    keys = sorted(metrics)
    first = next((v for v in metrics.values() if isinstance(v, torch.Tensor)), None)
    dev = first.device if first is not None else _collective_device(group)
    stacked = torch.stack([torch.as_tensor(metrics[k], dtype=torch.float32, device=dev).reshape(())
                           for k in keys])
    dist.all_reduce(stacked, group=group)
    stacked /= size
    return dict(zip(keys, stacked.unbind(0)))


def _collective_device(group) -> torch.device:
    """The device a collective of `group`'s backend reads: the current GPU
    under NCCL, the CPU under gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def sync_model(variables: Any) -> Any:
    """Rank 0's tensors on every rank (a module's `state_dict`, or any tree
    of tensors); the identity in a single process. The reference syncs
    through a shared file and a barrier; this broadcasts."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return variables

    def bcast(x):
        x = x.contiguous()
        dist.broadcast(x, src=0)
        return x

    return tree_map(bcast, variables)


def gather_predictions(tree: Any) -> Any:
    """Every rank's fixed-shape tensors stacked along a new leading axis of
    size world (`process_allgather`); the tree unchanged in a single
    process."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return tree
    world = dist.get_world_size()

    def gather(x):
        x = x.contiguous()
        out = x.new_empty((world,) + tuple(x.shape))
        dist.all_gather(list(out.unbind(0)), x)
        return out

    return tree_map(gather, tree)


def sharded_batch_apply(fn: Callable, mesh: DeviceMesh, axis: str = "dp") -> Callable:
    """Wrap `fn(batch) -> out` so that each rank applies it to its block of
    the leading axis of the whole batch it is given, and every rank gets
    the blocks back in rank order (`all_gather`). The leading size must
    divide by the axis size; `out` is a tensor or a tree of them, each with
    the block's leading size."""
    group, size, _ = _axis(mesh, axis)

    def apply(batch):
        out = fn(shard_leading(batch, mesh, axis))

        def gather(x):
            x = x.contiguous()
            full = x.new_empty((size,) + tuple(x.shape))
            dist.all_gather(list(full.unbind(0)), x, group=group)
            return full.reshape((size * x.shape[0],) + tuple(x.shape[1:]))

        return tree_map(gather, out)

    return apply
