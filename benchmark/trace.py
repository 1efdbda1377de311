"""The traced stretch of a `--trace 1` run: `torch.profiler` over a bounded
number of the window's items, reduced in memory (nothing is written to
disk) to the device's intervals, the host's, and the sums the per-layer
readers and the result's `breakdown` need.
"""

from __future__ import annotations

import contextlib
import heapq
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

WINDOW = "benchmark.stretch"
TOP = 10

Interval = Tuple[str, float, float]  # name, start, end (seconds on the profiler's clock)


@dataclass
class Stretch:
    """What the traced items did on the device and the host."""

    window: Tuple[float, float]
    device: List[Interval]
    host: List[Interval]
    records: list = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device's kernels and copies, inside the window."""
        lo, hi = self.window
        spans = sorted((max(s, lo), min(e, hi)) for _, s, e in self.device if e > lo and s < hi)
        out: List[Tuple[float, float]] = []
        for s, e in spans:
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], e))
            else:
                out.append((s, e))
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def device_seconds(self, names) -> float:
        """Seconds of the device's operations whose name holds one of `names`."""
        return sum(e - s for n, s, e in self.device if any(k in n for k in names))

    def device_ops(self) -> List[list]:
        """The device operations that took most time, summed by name."""
        total: Dict[str, float] = defaultdict(float)
        for n, s, e in self.device:
            total[n] += e - s
        return [[n, t] for n, t in sorted(total.items(), key=lambda kv: -kv[1])[:TOP]]

    def idle_gaps(self) -> List[list]:
        """The device's idle time, summed by what the host was doing in the
        middle of each gap (its innermost operation there)."""
        lo, hi = self.window
        gaps, at = [], lo
        for s, e in self.busy_intervals():
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if hi > at:
            gaps.append((at, hi))
        # sweep the gaps' midpoints in order, with the host operations begun
        # so far in a heap by duration; one that has ended is dropped when it
        # comes to the top, so the top is the innermost one still running
        host = sorted((h for h in self.host if h[0] != WINDOW), key=lambda h: h[1])
        total: Dict[str, float] = defaultdict(float)
        active: list = []
        i = 0
        for s, e in sorted(gaps, key=lambda g: g[0] + g[1]):
            mid = (s + e) / 2
            while i < len(host) and host[i][1] <= mid:
                heapq.heappush(active, (host[i][2] - host[i][1], i))
                i += 1
            while active and host[active[0][1]][2] < mid:
                heapq.heappop(active)
            total[host[active[0][1]][0] if active else "host: none"] += e - s
        return [[n, t] for n, t in sorted(total.items(), key=lambda kv: -kv[1])[:TOP]]


@contextlib.contextmanager
def traced(enabled: bool):
    """Profile the block when `enabled`; yields a list that holds the
    `Stretch` once the block has ended."""
    out: list = []
    if not enabled:
        yield out
        return
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            yield out
    device, host, window = [], [], None
    for ev in prof.events():
        iv = (ev.name, ev.time_range.start * 1e-6, ev.time_range.end * 1e-6)
        if ev.name == WINDOW:  # the stretch's span, on the host's timeline and the device's
            if ev.device_type != DeviceType.CUDA:
                window = iv[1:]
        elif ev.device_type == DeviceType.CUDA:
            device.append(iv)
        else:
            host.append(iv)
    if window is None:
        raise RuntimeError("the profiler recorded no stretch window")
    out.append(Stretch(window=window, device=device, host=host))
