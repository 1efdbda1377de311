"""Profiling hooks (PyTorch port of `happypose_tpu/utils/profiling.py`):
`device_trace` captures a `torch.profiler` trace of the host and, where
PyTorch was built with CUDA, the card; `annotate` and `stage` name spans
in it; `count` keeps the program's counters.

The profiler being active is the only switch. Without one, `annotate` and
`stage` return a shared no-op context after one flag check, and no CUDA
event is made; `count` always adds to one dict and does no device work.

- `annotate(name)`: a span while a profiler is active. Spans live in the
  profiler's host timeline, on the clock of its device trace, and nest:
  the frame or the training step is the outermost. Names are dotted, one a
  layer boundary (`obs.upload`, `detector.forward`, `estimator.frame`,
  `predictor.net`, `graphs.replay`, `train.step`, ...). A span is recorded
  as an operator's event (`_RecordFunctionFast`), not as the user
  annotation of `record_function`: the profiler mirrors a user annotation
  on the device's timeline as an interval over the kernels launched inside
  it, which a reader of the trace would take for device work.
- `stage(name)`: `annotate(name)` plus a pair of timing CUDA events around
  the stage's device work, which survives a CUDA graph's capture. While a
  `GraphCache` captures, the pair is recorded into the graph and kept with
  the captured entry; each replay made while a profiler is active hands the
  entry's pairs to be read. On an eager path the pair is recorded only
  while a profiler is active (and CUDA is initialized). Pairs are read
  lazily, at the next call into a `GraphCache` or by `flush()`, into the
  counters `stage.<name>.device_ms` and `stage.<name>.calls`, which so
  cover exactly the calls made while a profiler was active.
- `count(name, n)`, `counters()`: the program's counters, such as the
  `GraphCache` counters `graphs.<cache>.captures`, `.capture_s` and
  `.replays`.
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple, Union

import torch
import torch.autograd.profiler as _autograd_profiler

from happypose_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_NOOP = contextlib.nullcontext()
_counters: Dict[str, float] = {}
# (stage name, start event, end event) of the calls still to be read
_Pair = Tuple[str, "torch.cuda.Event", "torch.cuda.Event"]
_pending: List[_Pair] = []
# the pairs recorded into the graph being captured, while a capture runs
_capture_pairs: Optional[List[_Pair]] = None


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
    """A span named `name` in the active profiler's trace (a shared no-op
    context when no profiler is active)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NOOP
    return torch._C._profiler._RecordFunctionFast(name)


def stage(name: str):
    """`annotate(name)` and the stage's device time (module docstring); a
    shared no-op context with no profiler active and no capture running."""
    if _capture_pairs is None and not _autograd_profiler._is_profiler_enabled:
        return _NOOP
    return _Stage(name)


class _Stage:
    def __init__(self, name: str):
        self.name = name
        self.span = annotate(name)
        self.start = self.end = None

    def __enter__(self):
        self.span.__enter__()
        if _capture_pairs is not None or torch.cuda.is_initialized():
            # external: recorded as event nodes of a graph being captured
            self.start = torch.cuda.Event(enable_timing=True, external=True)
            self.end = torch.cuda.Event(enable_timing=True, external=True)
            self.start.record()
        return self

    def __exit__(self, *exc):
        if self.start is not None:
            self.end.record()
            pair = (self.name, self.start, self.end)
            (_capture_pairs if _capture_pairs is not None else _pending).append(pair)
        return self.span.__exit__(*exc)


@contextlib.contextmanager
def capturing_stages() -> Iterator[List[_Pair]]:
    """Around a graph's capture: yields the list that the stages recorded
    into the graph go to. (A `GraphCache` called inside another's call runs
    its function plainly, so captures do not nest.)"""
    global _capture_pairs
    _capture_pairs = pairs = []
    try:
        yield pairs
    finally:
        _capture_pairs = None


def replayed(pairs: List[_Pair]) -> None:
    """After a replay of a graph that holds `pairs`: they are read later
    when a profiler is active, and never otherwise."""
    if pairs and _autograd_profiler._is_profiler_enabled:
        _pending.extend(pairs)


def flush() -> None:
    """Read the stage pairs still pending into the counters. Each read waits
    for its end event, which a caller that has read its results has
    already passed; nothing is pending outside a profiled stretch."""
    if not _pending:
        return
    pairs = _pending[:]
    del _pending[:]
    for name, start, end in pairs:
        end.synchronize()
        count(f"stage.{name}.device_ms", start.elapsed_time(end))
        count(f"stage.{name}.calls")


def count(name: str, n: float = 1) -> None:
    """Add `n` to the counter `name`."""
    _counters[name] = _counters.get(name, 0) + n


def counters() -> Dict[str, float]:
    """A copy of every counter of the process."""
    return dict(_counters)
