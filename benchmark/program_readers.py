"""What the metric files read from the program itself: its counters
(`happypose_tpu_torch.utils.profiling.counters()`, the stage device times
and the `GraphCache` counters) and its spans in the traced stretch's host
intervals (`annotate` and `stage` names). Each reader returns None where
the program keeps no such counter or span (a program without them, or a
cell whose path does not pass them)."""

from __future__ import annotations

from typing import Dict, Optional, Sequence


def program_counters() -> Optional[Dict[str, float]]:
    """The program's counters once its pending stage times are read, or
    None where the program keeps none."""
    try:
        from happypose_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not (hasattr(profiling, "counters") and hasattr(profiling, "flush")):
        return None
    profiling.flush()
    return profiling.counters()


def stage_ms_per_unit(run, stage: str) -> Optional[float]:
    """Device ms of the program's stage `stage` (the replays and calls made
    in the traced stretch) over the units (poses) of the stretch's records;
    None where the stage ran in none of them (`stage.<stage>.calls`)."""
    counters = program_counters() or {}
    ms = counters.get(f"stage.{stage}.device_ms")
    units = sum(r.units for r in run.stretch.records)
    if ms is None or not units or not counters.get(f"stage.{stage}.calls"):
        return None
    return ms / units


def capture_s(run) -> Optional[float]:
    """Seconds of every graph capture of the process (`graphs.*.capture_s`):
    set-up's, and any made in the window."""
    counters = program_counters() or {}
    values = [v for k, v in counters.items() if k.startswith("graphs.") and k.endswith(".capture_s")]
    return sum(values) if values else None


def idle_under(stretch, prefixes: Sequence[str]) -> Optional[float]:
    """Seconds of the stretch's device-idle gaps whose midpoint falls inside
    a host span whose name starts with one of `prefixes` (the gaps tested at
    their midpoints, as `Stretch.idle_gaps` does), or None where no such
    span or no device interval was recorded."""
    # the gaps as `Stretch.idle_gaps` (benchmark/trace.py) defines them:
    # between the busy intervals' union, and from the window's ends
    spans = sorted((s, e) for n, s, e in stretch.host if n.startswith(tuple(prefixes)))
    if not spans or not stretch.device:
        return None
    lo, hi = stretch.window
    gaps, at = [], lo
    for s, e in stretch.busy_intervals():
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if hi > at:
        gaps.append((at, hi))
    total = 0.0
    for s, e in gaps:
        mid = (s + e) / 2
        if any(a <= mid <= b for a, b in spans):
            total += e - s
    return total


def idle_ms_per_item(run, prefixes: Sequence[str]) -> Optional[float]:
    """`idle_under` in ms over the stretch's records (frames, steps)."""
    s = run.stretch
    seconds = idle_under(s, prefixes)
    return 1e3 * seconds / len(s.records) if seconds is not None and s.records else None


def idle_share(run, prefixes: Sequence[str]) -> Optional[float]:
    """`idle_under` as a share (%) of the traced stretch's time: the
    profiler's cost falls on both sides, so it cancels in part."""
    s = run.stretch
    seconds = idle_under(s, prefixes)
    return 100.0 * seconds / s.window_s if seconds is not None and s.window_s > 0 else None
