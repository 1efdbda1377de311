"""Device meshes and placement (PyTorch port of
`happypose_tpu/parallel/mesh.py`).

JAX runs one program over a `Mesh` of devices; PyTorch runs one process
per device. A mesh here is a `torch.distributed.DeviceMesh` over the
process group, one rank a device, and an axis's process group
(`mesh.get_group(name)`) carries its collectives:

- `replicate` broadcasts from the axis's first rank;
- `shard_leading` keeps the rank's contiguous block of every leading axis;
- `shard_objects` keeps the rank's block of a mesh database's objects, and
  its `select` fills the rows the rank owns, zeros the rest and sums over
  the axis: one `all_reduce` gives every rank the selected instances (in
  JAX, XLA inserts that gather when `select` runs under jit).

Trees are tensors in dicts, lists, tuples (named or not) and dataclasses.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from happypose_tpu_torch.parallel.distributed import backend_for, init_distributed_mode


def tree_map(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    """`fn` on every tensor of `tree`; other leaves are kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name)) for f in dataclasses.fields(tree)
            if f.init})
    if isinstance(tree, dict):
        return type(tree)((k, tree_map(fn, v)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return tree


def tree_leaves(tree: Any) -> list:
    """The tensors of `tree`, in `tree_map`'s order."""
    out = []
    tree_map(out.append, tree)
    return out


def make_mesh(
    axis_sizes: Optional[Tuple[int, ...]] = None,
    axis_names: Tuple[str, ...] = ("dp",),
    device_type: str = "cuda",
) -> DeviceMesh:
    """A mesh over every rank of the process group (default: 1-D "dp").

    Joins the group of the environment first (`init_distributed_mode`);
    with none, it makes a group of one rank in this process (a `HashStore`,
    the backend of `device_type`), so `make_mesh()` on one card works as
    JAX's does on one device."""
    if not dist.is_initialized():
        init_distributed_mode(device_type=device_type)
    if not dist.is_initialized():
        dist.init_process_group(backend_for(device_type), store=dist.HashStore(),
                                rank=0, world_size=1)
    world = dist.get_world_size()
    axis_sizes = (world,) if axis_sizes is None else tuple(axis_sizes)
    if math.prod(axis_sizes) != world:
        raise ValueError(f"a mesh of {axis_sizes} needs {math.prod(axis_sizes)} ranks; "
                         f"the process group has {world}")
    return init_device_mesh(device_type, axis_sizes, mesh_dim_names=tuple(axis_names))


def _axis(mesh: DeviceMesh, axis: Optional[str]):
    """(group, size, local rank) of `axis` (the mesh's first when None)."""
    axis = axis or mesh.mesh_dim_names[0]
    return mesh.get_group(axis), mesh.size(mesh.mesh_dim_names.index(axis)), \
        mesh.get_local_rank(axis)


def replicate(tree: Any, mesh: DeviceMesh, axis: Optional[str] = None) -> Any:
    """Every tensor of `tree` as the axis's first rank holds it (broadcast,
    in place; a copy of a tensor that is not contiguous)."""
    group, size, _ = _axis(mesh, axis)
    if size == 1:
        return tree
    src = dist.get_global_rank(group, 0)

    def bcast(x):
        x = x.contiguous()
        dist.broadcast(x, src=src, group=group)
        return x

    return tree_map(bcast, tree)


def _block(x: torch.Tensor, size: int, rank: int) -> torch.Tensor:
    if x.shape[0] % size:
        raise ValueError(f"leading axis {x.shape[0]} does not divide by the axis size {size}")
    n = x.shape[0] // size
    return x[rank * n:(rank + 1) * n]


def shard_leading(tree: Any, mesh: DeviceMesh, axis: str = "dp") -> Any:
    """The rank's contiguous block of every tensor's leading axis (tensors
    of rank 0 are kept whole). The leading size must divide by the axis
    size, as in JAX."""
    _, size, rank = _axis(mesh, axis)
    return tree_map(lambda x: x if x.ndim == 0 else _block(x, size, rank), tree)


@dataclasses.dataclass
class ShardedObjects:
    """A mesh database (`RenderAssets` / `BatchedMeshes`) of which this rank
    holds objects `[start, start + n_local)` in `local`.

    `select(obj_ids)` returns the instance rows of every field, the same on
    every rank: the rank writes the rows it owns, zeros the others, and one
    `all_reduce(SUM)` over the axis's group fills them all. Every rank must
    call it with the same ids. The reduction runs over the distinct ids
    only, so a field's rows cross the group once an object, in one float32
    buffer: floats and booleans come back exactly, integers (face indices,
    ids) below 2**24."""

    local: Any
    start: int
    group: Any

    def select(self, obj_ids: torch.Tensor):
        uniq, inv = torch.unique(obj_ids, return_inverse=True)
        rel = uniq - self.start
        n_local = tree_leaves(self.local)[0].shape[0]
        own = (rel >= 0) & (rel < n_local)
        idx = torch.where(own, rel, torch.zeros_like(rel))
        flat = [x[idx] for x in tree_leaves(self.local)]
        # one buffer for every field: a single collective a select
        dtype = torch.float32
        packed = torch.cat([torch.where(own.view(-1, *[1] * (f.ndim - 1)), f,
                                        torch.zeros_like(f)).to(dtype).reshape(len(uniq), -1)
                            for f in flat], dim=1)
        dist.all_reduce(packed, group=self.group)
        out, off = [], 0
        for f in flat:
            n = f[0].numel()
            out.append(packed[:, off:off + n].reshape(f.shape).to(f.dtype)[inv])
            off += n
        it = iter(out)
        return tree_map(lambda _: next(it), self.local)


def shard_objects(db_tree: Any, mesh: DeviceMesh, axis: str = "dp") -> ShardedObjects:
    """This rank's block of a mesh database's leading object axis.

    The object count must divide by the axis size
    (`pad_objects_to_multiple` first); the padding objects are never
    selected."""
    group, size, rank = _axis(mesh, axis)
    n = tree_leaves(db_tree)[0].shape[0]
    local = tree_map(lambda x: _block(x, size, rank), db_tree)
    return ShardedObjects(local=local, start=rank * (n // size), group=group)


def pad_objects_to_multiple(db_tree: Any, multiple: int) -> Any:
    """Zero-pad every tensor's leading object axis to a multiple of
    `multiple` (sharding prep)."""

    def pad(x):
        extra = -x.shape[0] % multiple
        if x.ndim == 0 or extra == 0:
            return x
        return torch.cat([x, x.new_zeros((extra,) + x.shape[1:])])

    return tree_map(pad, db_tree)
