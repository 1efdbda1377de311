"""Runs one cell once: finds its files by name, makes its world from the
seed, warms it up, measures a closed loop for the window, checks what the
timed path produced against the plain reference, and returns the result.

Everything a cell is made of is a file the harness finds by name:
- `cells/<cell>.json`: the configuration, the traffic mix and overrides of
  its parameters, the runner, the limits of the comparison, the size of
  the traced stretch and the sample the comparison takes;
- `configs/<config>.json`: the configuration as it is run;
- `mixes/<mix>.json`: the traffic's parameters, read by `traffic.py`;
- `runners/<runner>.py`: the code that builds the program and the
  reference, runs one item of the traffic and compares;
- `metrics/<metric>.py`: a reader of one metric (`read(run)`, None when
  there is nothing to read).
`BENCHMARK.json` names the cells and metrics and gives each metric its
unit and the cells whose traced run reports it.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "happypose_tpu")


def read_json(path: Path) -> Dict:
    return json.loads(path.read_text())


def benchmark_spec(root: Path = ROOT) -> Dict:
    return read_json(root / "BENCHMARK.json")


def load_cell(name: str, overrides: Optional[Dict] = None) -> Dict:
    """The cell's file with its configuration and mix resolved; `overrides`
    ({"config": {...}, "mix": {...}, "cell": {...}}) replace single keys,
    for tests at a cut size."""
    overrides = overrides or {}
    cell = {**read_json(HERE / "cells" / f"{name}.json"), **overrides.get("cell", {})}
    cell["name"] = name
    cell["config_spec"] = {**read_json(HERE / "configs" / f"{cell['config']}.json"),
                           **overrides.get("config", {})}
    cell["mix_spec"] = {**read_json(HERE / "mixes" / f"{cell['traffic']}.json"),
                        **cell.get("mix", {}), **overrides.get("mix", {})}
    return cell


def load_runner(name: str):
    return importlib.import_module(f"benchmark.runners.{name}")


def load_metric(name: str):
    """The reader module of `metrics/<name>.py` (a name may hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


@dataclass
class Record:
    """One item of the window: its host-clock span, the units it returned
    (poses, samples), and what the runner keeps to check it."""

    start: float
    end: float
    units: int
    ok: bool
    keep: object = None
    model_flops: float = 0.0


@dataclass
class Run:
    """What the metric readers read."""

    cell: Dict
    setup_s: float
    window_start: float
    records: List[Record]
    runner: object = None
    stretch: object = None
    peaks: Dict = field(default_factory=dict)

    def rate(self) -> Optional[float]:
        """Units of all items completed in the window over the time from
        the window's start to the end of the last one."""
        if not self.records:
            return None
        return sum(r.units for r in self.records) / (self.records[-1].end - self.window_start)

    def latency_ms(self, q: float) -> Optional[float]:
        if not self.records:
            return None
        return float(np.percentile([1e3 * (r.end - r.start) for r in self.records], q))


def _items(traffic):
    """The traffic's items in order, round again when they run out."""
    yield from traffic["items"]
    print("benchmark: the traffic ran out; it starts again", file=sys.stderr)
    while True:
        yield from traffic["items"]


def _fifths(records: List[Record], t0: float, seconds: float) -> List[float]:
    """Units a second of the items that ended in each fifth of the window."""
    units = [0] * 5
    for r in records:
        units[min(4, int(5 * (r.end - t0) / seconds))] += r.units
    return [round(u * 5 / seconds, 2) for u in units]


def _device_info(device, chips: int) -> Dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def run_cell(name: str, seed: int, seconds: float, trace: bool, t_process: float,
             device: str = "cuda", overrides: Optional[Dict] = None,
             control: bool = False) -> Dict:
    """One run of a cell; returns the result's fields (`checks` last)."""
    import torch

    from benchmark import trace as tracing

    spec = benchmark_spec()
    cell = load_cell(name, overrides)
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    drv = load_runner(cell["runner"]).Runner(cell, seed, dev)
    drv.warm()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    setup_s = t0 - t_process
    close = t0 + seconds
    records: List[Record] = []
    raised = 0
    n_traced = cell["trace_items"] if trace else 0
    items = _items(drv.traffic)
    with tracing.traced(trace) as stretch_out:
        while time.perf_counter() < close and (not trace or len(records) + raised < n_traced):
            item = next(items)
            start = time.perf_counter()
            try:
                rec = drv.run(item)
            except Exception:  # a failed item is counted, the window goes on
                traceback.print_exc()
                raised += 1
                continue
            rec.start, rec.end = start, time.perf_counter()
            if rec.end > close and not trace:
                break
            records.append(rec)
    device_info = _device_info(dev, cell["chips"])
    if records and not trace:
        print(f"benchmark: units/s by fifth of the window {_fifths(records, t0, seconds)}",
              file=sys.stderr)
    drv.release()
    run = Run(cell=cell, setup_s=setup_s, window_start=t0, records=records, runner=drv,
              peaks=read_json(HERE / "peaks.json"))
    metrics: Dict[str, Dict] = {}
    breakdown = None
    if trace:
        run.stretch = stretch_out[0]
        run.stretch.records = records
        device_info["busy_s"] = run.stretch.busy_s
        device_info["window_s"] = run.stretch.window_s
        breakdown = {"device_ops": run.stretch.device_ops(),
                     "idle_gaps": run.stretch.idle_gaps()}
        wanted = [m for m in spec["per_layer"] if name in m.get("workloads", [name])]
    else:
        wanted = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    for m in wanted:
        value = load_metric(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    def sample_rng():  # the sample the comparison takes, drawn from the seed
        return np.random.default_rng([seed % (1 << 63), 7])

    checks = drv.check(records, sample_rng())
    if control:  # the readings the limits are set from: the control's and the faults'
        checks = {"program": checks, **{name: drv.check(records, sample_rng(), control=name)
                                        for name in drv.CONTROLS}}
        correct = None
    else:
        correct = bool(records) and all(
            math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct, "attempted": len(records) + raised,
              "failed": raised + sum(not r.ok for r in records),
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result
