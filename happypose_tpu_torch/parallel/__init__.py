"""Parallelism on `torch.distributed`: process groups, device meshes, the
collectives, hypothesis-axis and object-axis sharding (PyTorch port of
`happypose_tpu/parallel/`)."""

from happypose_tpu_torch.parallel.mesh import make_mesh, replicate, shard_leading
from happypose_tpu_torch.parallel.collectives import (
    reduce_dict,
    sync_model,
    gather_predictions,
    sharded_batch_apply,
)

__all__ = [
    "make_mesh",
    "replicate",
    "shard_leading",
    "reduce_dict",
    "sync_model",
    "gather_predictions",
    "sharded_batch_apply",
]
