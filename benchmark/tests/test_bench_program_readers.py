"""The readers of the program's own spans and counters
(`benchmark/program_readers.py`): device-idle time under a span on a
synthetic stretch whose answer is known, the stage and capture counters
over the stretch's units, and None where the program keeps none; and the
`GraphCache` counters over a cut cell's window, which captures nothing
once set-up has warmed its keys."""

import types

import pytest
import torch

from benchmark import harness, program_readers
from benchmark.tests import cut
from benchmark.trace import Stretch

SPEC = harness.benchmark_spec()


def _stretch():
    # busy [1, 3], [6, 7], [9, 9.5] in a window [0, 10]: idle [0, 1] (mid 0.5),
    # [3, 6] (mid 4.5), [7, 9] (mid 8), [9.5, 10] (mid 9.75)
    return Stretch(window=(0.0, 10.0),
                   device=[("k", 1.0, 2.0), ("k", 1.5, 3.0), ("k", 6.0, 7.0), ("k", 9.0, 9.5)],
                   host=[("detector.forward", 0.0, 1.2), ("detector.postprocess", 4.0, 5.0),
                         ("aten::mul", 4.4, 4.6), ("estimator.refine", 7.5, 9.9),
                         ("predictor.net", 7.9, 8.1), ("estimator.frame", 9.6, 9.9)])


def test_idle_under_a_span_counts_gaps_by_their_midpoint():
    s = _stretch()
    # [0, 1] (0.5 in detector.forward) and [3, 6] (4.5 in detector.postprocess)
    assert program_readers.idle_under(s, ["detector."]) == pytest.approx(4.0)
    # [7, 9]: mid 8 inside estimator.refine (and its child); [9.5, 10]: mid 9.75
    assert program_readers.idle_under(s, ["estimator.refine"]) == pytest.approx(2.5)
    assert program_readers.idle_under(s, ["estimator."]) == pytest.approx(2.5)
    assert program_readers.idle_under(s, ["train."]) is None
    s.records = [object()] * 4
    run = types.SimpleNamespace(stretch=s)
    assert program_readers.idle_ms_per_item(run, ["detector."]) == pytest.approx(1e3)
    assert program_readers.idle_share(run, ["estimator.refine"]) == pytest.approx(25.0)
    assert program_readers.idle_share(run, ["train."]) is None
    no_device = Stretch(window=s.window, device=[], host=s.host)
    assert program_readers.idle_under(no_device, ["detector."]) is None


def test_counters_over_the_stretch(monkeypatch):
    counters = {"stage.estimator.coarse.device_ms": 600.0, "stage.estimator.coarse.calls": 2,
                "graphs.pipeline.capture_s": 20.5, "graphs.stage.capture_s": 1.5,
                "graphs.pipeline.replays": 3}
    monkeypatch.setattr(program_readers, "program_counters", lambda: counters)
    run = types.SimpleNamespace(stretch=types.SimpleNamespace(
        records=[types.SimpleNamespace(units=u) for u in (1, 3)]))
    assert program_readers.stage_ms_per_unit(run, "estimator.coarse") == pytest.approx(150.0)
    assert program_readers.stage_ms_per_unit(run, "estimator.refine") is None
    counters["stage.estimator.coarse.calls"] = 0  # no replay in the stretch
    assert program_readers.stage_ms_per_unit(run, "estimator.coarse") is None
    assert program_readers.capture_s(run) == pytest.approx(22.0)
    monkeypatch.setattr(program_readers, "program_counters", lambda: None)
    assert program_readers.capture_s(run) is None
    assert program_readers.stage_ms_per_unit(run, "estimator.coarse") is None


def test_a_program_without_counters_reads_none(monkeypatch):
    from happypose_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "counters")
    assert program_readers.program_counters() is None


def test_program_metrics_name_their_files():
    """Every metric that reads the program is in BENCHMARK.json with the
    reader's constants, and lists cells that report what it moves."""
    names = ["coarse_ms.serve", "refine_ms.serve", "capture_s.serve", "detect_wait_ms.detect",
             "capture_s.detect", "refine_wait_ms.track", "step_wait_ms.train", "capture_s.train",
             "score_ms.serve", "refine_wait_share.track"]
    per_layer = {m["name"]: m for m in SPEC["per_layer"]}
    for n in names:
        mod = harness.load_metric(n)
        m = per_layer[n]
        assert (mod.SOURCE, mod.LAYER, mod.MOVES, mod.WORKLOADS) == (
            m["source"], m["layer"], m["moves"], m["workloads"])


@pytest.mark.parametrize("cell", ["megapose-bop", "cosypose-bop", "megapose-train"])
def test_a_window_captures_nothing(cell):
    """A cell cut to the CPU's size: after its set-up (`warm`), the window's
    items replay the graphs that set-up captured and capture none
    (`graphs.<cache>.captures` unchanged, `.replays` grown). On the CPU a
    cache's capture is a key's first call, under the same key."""
    from happypose_tpu_torch.utils import profiling

    c = harness.load_cell(cell, cut.OVERRIDES[cell])
    drv = harness.load_runner(c["runner"]).Runner(c, 3000000017, torch.device("cpu"))
    drv.warm()
    before = profiling.counters()
    for item in drv.traffic["items"][:3]:
        drv.run(item)
    after = profiling.counters()
    drv.release()

    def grown(what):
        return {k: after[k] - before.get(k, 0) for k in after
                if k.startswith("graphs.") and k.endswith(what)}

    assert set(grown(".captures").values()) == {0}
    assert sum(grown(".replays").values()) >= 3
