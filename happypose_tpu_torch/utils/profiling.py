"""Profiling hooks (PyTorch port of `happypose_tpu/utils/profiling.py`):
`device_trace` captures a `torch.profiler` trace of the host and, where
PyTorch was built with CUDA, the card; `annotate` names a span in it."""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Iterator, Optional, Union

import torch

from happypose_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


@contextlib.contextmanager
def device_trace(log_dir: Optional[Union[str, Path]]) -> Iterator[None]:
    """Capture a trace into `log_dir/trace.json` (Chrome / Perfetto
    format); a no-op when `log_dir` is None.

        with device_trace(run_dir / "trace" if args.profile else None):
            train_epoch(...)
    """
    if log_dir is None:
        yield
        return
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    logger.info(f"capturing a torch.profiler trace to {log_dir}")
    with torch.profiler.profile(activities=torch.profiler.supported_activities()) as prof:
        yield
    prof.export_chrome_trace(str(log_dir / "trace.json"))
    logger.info(f"trace written: {log_dir / 'trace.json'}")


def annotate(name: str):
    """Named span context for trace readability (e.g. 'render', 'coarse')."""
    return torch.profiler.record_function(name)
