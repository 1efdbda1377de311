"""The harness: files found by name, the contract's shape of
`BENCHMARK.json` and of the result line, the traffic's determinism, the
trace's reduction, and that a cell, configuration, mix or metric is added
by adding files."""

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from benchmark import harness, traffic
from benchmark.tests import cut
from benchmark.trace import Stretch

ROOT = harness.ROOT
SPEC = harness.benchmark_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CONTRACT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_spec_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in SPEC[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])


def test_every_cell_resolves_to_its_files():
    for w in SPEC["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell["config"] == w["config"] and cell["traffic"] == w["traffic"]
        assert cell["chips"] == w["chips"]
        harness.load_runner(cell["runner"]).Runner
        assert set(cell["limits"]) and all(v > 0 for v in cell["limits"].values())
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        mod = harness.load_metric(m["name"])
        assert mod.SOURCE == m["source"]
        if m in SPEC["per_layer"]:
            assert (mod.LAYER, mod.MOVES, mod.WORKLOADS) == (m["layer"], m["moves"],
                                                             m["workloads"])


def test_every_cell_reports_setup_another_e2e_and_a_layer():
    for w in SPEC["workloads"]:
        e2e = [m["name"] for m in SPEC["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        layer = [m for m in SPEC["per_layer"] if w["name"] in m["workloads"]]
        assert "setup_s" in e2e and len(e2e) >= 2 and layer


def _tree_hashes(root: Path):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_add_a_cell_config_mix_and_metric(tmp_path):
    """A configuration, a mix, a cell and a metric put beside the others as
    new files are found by name; no file that was there changes."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _tree_hashes(tmp_path)
    b = tmp_path / "benchmark"
    cfg = json.loads((b / "configs" / "megapose-rgb.json").read_text())
    (b / "configs" / "megapose-rgb-small.json").write_text(json.dumps({**cfg, "n_points": 500}))
    mix = json.loads((b / "mixes" / "bop-frames.json").read_text())
    (b / "mixes" / "crowded-frames.json").write_text(json.dumps({**mix, "detections": [12, 16]}))
    cell = json.loads((b / "cells" / "megapose-bop.json").read_text())
    (b / "cells" / "megapose-crowded.json").write_text(json.dumps(
        {**cell, "config": "megapose-rgb-small", "traffic": "crowded-frames"}))
    (b / "metrics" / "frames_per_s.serve.py").write_text(
        'SOURCE = "host_clock"\n\n\ndef read(run):\n    return len(run.records)\n')
    after = _tree_hashes(tmp_path)
    assert all(after[k] == v for k, v in before.items())
    code = (
        "from benchmark import harness, traffic\n"
        "c = harness.load_cell('megapose-crowded')\n"
        "t = traffic.generate(c['mix_spec'], 5, c['config_spec']['objects']['count'])\n"
        "m = harness.load_metric('frames_per_s.serve')\n"
        "print(c['config_spec']['n_points'], sorted({len(i['obj_ids']) for i in t['items']}),"
        " m.read(type('R', (), {'records': [1, 2]})()))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, env={**os.environ, "PYTHONPATH": str(tmp_path)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["500", "[12,", "16]", "2"]


@pytest.mark.parametrize("mix", ["bop-frames", "track-sessions"])
def test_traffic_repeats_for_a_seed_and_differs_across_seeds(mix):
    spec = harness.read_json(harness.HERE / "mixes" / f"{mix}.json")

    def flat(seed):
        t = traffic.generate(spec, seed, 21)
        return [np.concatenate([np.ravel(v).astype(np.float64) for k, v in sorted(i.items())
                                if v is not None]) for i in t["items"]]

    a, b, c = flat(2**31 + 11), flat(2**31 + 11), flat(2**31 + 12)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))


def test_training_draws_repeat_for_a_seed_and_differ_across_seeds():
    """The training cell draws each step's scenes on the device from the seed."""
    import torch

    drv = harness.load_runner("megapose_train")
    cell = harness.load_cell("megapose-train", cut.OVERRIDES["megapose-train"])

    def first_draws(seed):
        scene, noise = drv.Runner(cell, seed, torch.device("cpu")).draws()
        return torch.cat([scene["R"].flatten(), scene["bg"].flatten(), noise["euler"].flatten()])

    a, b, c = first_draws(2**31 + 11), first_draws(2**31 + 11), first_draws(2**31 + 12)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_traffic_serves_every_seed_the_same_sizes():
    spec = {**harness.read_json(harness.HERE / "mixes" / "bop-frames.json"), "frames": 64}
    sizes = [sorted(len(i["obj_ids"]) for i in traffic.generate(spec, s, 21)["items"])
             for s in (1, 2**33)]
    assert sizes[0] == sizes[1]


def test_stretch_reduction():
    s = Stretch(window=(0.0, 10.0),
                device=[("k1", 1.0, 3.0), ("k2", 2.0, 4.0), ("k1", 6.0, 7.0)],
                host=[("frame", 0.0, 10.0), ("sync", 4.0, 6.0), ("launch", 7.5, 9.0)])
    assert s.busy_s == pytest.approx(4.0)
    assert s.device_ops()[0] == ["k1", 3.0]
    gaps = dict(map(tuple, s.idle_gaps()))
    assert gaps == {"frame": pytest.approx(1.0), "sync": pytest.approx(2.0),
                    "launch": pytest.approx(3.0)}


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_has_the_contract_keys(trace):
    """`correct`, `attempted`, `failed`, `metrics`, `device` (and `breakdown`
    when traced), then last `checks`: each compared number beside its limit,
    which the benchmark's contract asks for on the result's line as well as
    on standard error."""
    r = cut.run("megapose-track", seconds=6.0, trace=trace)  # a window that outlasts a busy host
    assert list(r)[:5] == CONTRACT_KEYS and list(r)[-1] == "checks"
    assert set(r) - set(CONTRACT_KEYS) - {"checks"} == ({"breakdown"} if trace else set())
    assert r["correct"] is True and r["attempted"] > 0 and r["failed"] == 0
    wanted = {m["name"] for m in SPEC["per_layer" if trace else "end_to_end"]
              if "megapose-track" in m.get("workloads", ["megapose-track"])}
    if trace:  # the CPU has no device trace: the readers find nothing to read
        assert set(r["metrics"]) <= wanted
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(r["metrics"]) == wanted
        assert all(set(v) == {"value", "unit"} for v in r["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(r["device"])
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}


def test_no_card_no_result(tmp_path):
    """Without a CUDA card the command prints no result and exits non-zero."""
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "megapose-bop",
                          "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout == ""


def test_without_the_program_no_result(tmp_path):
    """A checkout of only BENCHMARK.json and the benchmark's files fails."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    code = ("import time, sys\nfrom benchmark import harness\n"
            "harness.run_cell('megapose-track', 1, 1.0, False, time.perf_counter(), device='cpu')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, env={**os.environ, "PYTHONPATH": str(tmp_path)})
    assert out.returncode != 0 and out.stdout == ""
