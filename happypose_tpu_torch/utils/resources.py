"""Memory telemetry (PyTorch port of `happypose_tpu/utils/resources.py`):
the device's memory from PyTorch's caching allocator
(`torch.cuda.memory_stats`, `torch.cuda.mem_get_info`), the process's
resident set from /proc, as the JAX package reads it.

`get_device_memory` asks the card by default; where there is none it fails
with PyTorch's own error. A CPU device reports nothing and gives zeros, as
JAX's CPU backend does.
"""

from __future__ import annotations

from typing import Dict

import torch

GIB = 1024**3


def get_device_memory(device="cuda") -> Dict[str, float]:
    """GiB allocated now and at the peak (since the last
    `torch.cuda.reset_peak_memory_stats`), and the card's total."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"bytes_in_use_gib": 0.0, "peak_bytes_in_use_gib": 0.0, "bytes_limit_gib": 0.0}
    stats = torch.cuda.memory_stats(device)
    _, total = torch.cuda.mem_get_info(device)
    return {
        "bytes_in_use_gib": stats.get("allocated_bytes.all.current", 0) / GIB,
        "peak_bytes_in_use_gib": stats.get("allocated_bytes.all.peak", 0) / GIB,
        "bytes_limit_gib": total / GIB,
    }


def get_total_memory() -> float:
    """This process's resident set in GiB (0 where /proc has none)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return float(line.split()[1]) / (1024**2)
    except OSError:
        pass
    return 0.0


def log_memory(logger, prefix: str = "", device="cuda") -> None:
    dev = get_device_memory(device)
    logger.info(
        f"{prefix}device={dev['bytes_in_use_gib']:.2f}GiB "
        f"(peak {dev['peak_bytes_in_use_gib']:.2f}) host_rss="
        f"{get_total_memory():.2f}GiB"
    )
