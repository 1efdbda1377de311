"""The process group and rank helpers (PyTorch port of
`happypose_tpu/parallel/distributed.py`; the reference's
`happypose/toolbox/utils/distributed.py:89-153`).

One process per GPU, as the reference runs: `init_distributed_mode` joins
the group that `MASTER_ADDR` / `MASTER_PORT` / `WORLD_SIZE` / `RANK` name
(what `torchrun` sets). The backend follows the device: NCCL for `cuda`,
gloo for `cpu`, and a failure raises; nothing switches backend or device.
A single process (no `WORLD_SIZE`, or 1) joins nothing, as JAX's does, and
the rank helpers then read rank 0 of a world of 1.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from happypose_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def backend_for(device_type: str) -> str:
    """The collective backend of a device type: NCCL for `cuda`, gloo for `cpu`."""
    if device_type not in BACKENDS:
        raise ValueError(f"no collective backend for device type {device_type!r}")
    return BACKENDS[device_type]


def init_distributed_mode(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device_type: str = "cuda",
) -> None:
    """Join the process group (idempotent; one process: a no-op).

    `coordinator_address` ("host:port") defaults to `MASTER_ADDR` /
    `MASTER_PORT`, `num_processes` to `WORLD_SIZE`, `process_id` to `RANK`.
    On `cuda` each process takes the GPU `LOCAL_RANK` (else its rank)."""
    if dist.is_initialized():
        return
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '12345')}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if num_processes is None or num_processes <= 1:
        logger.info("single-process run; distributed init skipped")
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("a run of several processes needs a coordinator address and a rank "
                         "(MASTER_ADDR / MASTER_PORT and RANK)")
    backend = backend_for(device_type)
    if device_type == "cuda":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", process_id)))
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    logger.info(f"joined process group ({backend}): rank {process_id}/{num_processes}")


def get_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    return get_rank() == 0
