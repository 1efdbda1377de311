"""What the metric files (`metrics/<name>.py`) read, shared by the metrics
that read the same quantity in different cells."""

from __future__ import annotations

def mfu(run):
    """% of the card's float32 peak: the stretch's records' model FLOPs
    over its seconds."""
    s = run.stretch
    flops = sum(r.model_flops for r in s.records)
    if not flops or s.window_s <= 0:
        return None
    return 100.0 * flops / (s.window_s * run.peaks["float32_flops_per_s"])


def device_idle(run):
    """% of the stretch with no kernel or copy on the card (the union of
    the device's intervals)."""
    s = run.stretch
    if s.window_s <= 0 or not s.device:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)


def kernels_per_unit(run):
    """The device's kernels and copies in the stretch over the units (poses,
    samples) its records returned."""
    s = run.stretch
    units = sum(r.units for r in s.records)
    return len(s.device) / units if units and s.device else None


def raster_roofline(run, kernels, flop_per_test):
    """% of the rasterizer's kernels' device time that its least time is:
    the larger of its bytes over the card's bandwidth and `flop_per_test`
    flops a pixel test over the float32 peak (the runner counts both from
    the stretch's renders)."""
    s = run.stretch
    seconds = s.device_seconds(kernels)
    if seconds <= 0:
        return None
    n_bytes, tests = run.runner.raster_work(s.records)
    least = max(n_bytes / run.peaks["hbm_bytes_per_s"],
                flop_per_test * tests / run.peaks["float32_flops_per_s"])
    return 100.0 * least / seconds
