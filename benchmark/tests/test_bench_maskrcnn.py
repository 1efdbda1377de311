"""The Mask R-CNN cell (`maskrcnn-bop`) cut to the CPU: every width of the
configuration as it is, the frame 96x128 and the counts of proposals,
pairs and detections small. Set-up warms the detector's graph; three items
replay it and capture nothing; the detector's stage spans are recorded;
the program agrees with the reference and the control and the planted
fault read far above it; the counts of the frame and the kernels. On the
card, the cell at its own size with a traced stretch (marked `cuda`).
"""

import time
import types

import numpy as np
import pytest
import torch

from benchmark import harness, maskrcnn_counts

CELL = "maskrcnn-bop"
CUT = {
    "config": {"image_size": [96, 128], "rpn_post_nms_top_n": 100, "box_pair_budget": 512,
               "detections_per_img": 10},
    "mix": {"image_size": [96, 128], "images": 2, "frames": 6, "detections": [1, 2]},
    "cell": {"sample": 2, "trace_items": 2},
}
SPEC = harness.benchmark_spec()


def _run(control=False, trace=False, seconds=2.0):
    return harness.run_cell(CELL, 12345678901, seconds, trace, time.perf_counter(),
                            device="cpu", overrides=CUT, control=control)


def test_the_cell_agrees_and_reports():
    """Every gap within 1e-5: the RPN's and the rows' from the same float32
    convolutions, the heads' from RoIAlign's taps summed in another order
    (1.5e-6 of the spread through the 12,544-wide box head)."""
    r = _run()
    assert r["correct"] is True and r["failed"] == 0, r["checks"]
    for name, c in r["checks"].items():
        assert c["value"] <= 1e-5, (name, c)
    assert set(r["metrics"]) == {"frame_ms_p95.detect", "setup_s"}


def test_control_and_fault_read_far_above_the_program():
    """The control (TF32, emulated here by rounding the convolutions'
    inputs) and the planted fault (every RoI read from P2) each read a
    number ten times the program's and above 1e-4."""
    r = _run(control=True)
    prog = r["checks"].pop("program")
    assert set(r["checks"]) == {"tf32", "level_up"}
    for name, ctrl in r["checks"].items():
        assert any(c["value"] > max(10 * prog[k]["value"], 1e-4) for k, c in ctrl.items()), \
            (name, ctrl, prog)


def test_a_window_captures_nothing_and_the_stages_have_spans():
    """After set-up, three items replay the detector's key and capture
    none; under a profiler the detector's stages are spans inside its
    forward."""
    from torch.profiler import profile

    from happypose_tpu_torch.utils import profiling

    c = harness.load_cell(CELL, CUT)
    drv = harness.load_runner(c["runner"]).Runner(c, 3000000017, torch.device("cpu"))
    drv.warm()
    before = profiling.counters()
    with profile() as prof:
        for item in drv.traffic["items"][:3]:
            drv.run(item)
    after = profiling.counters()
    drv.release()
    assert after["graphs.detector.captures"] == before["graphs.detector.captures"]
    assert after["graphs.detector.replays"] == before["graphs.detector.replays"] + 3
    names = {e.name for e in prof.events()}
    assert {"detector.rpn", "detector.box", "detector.mask", "detector.forward"} <= names


def test_metrics_name_their_files():
    per_layer = {m["name"]: m for m in SPEC["per_layer"]}
    names = ["rpn_ms.maskrcnn", "box_ms.maskrcnn", "mask_ms.maskrcnn", "detect_wait_ms.maskrcnn",
             "capture_s.maskrcnn", "device_idle.maskrcnn", "mfu.maskrcnn",
             "nms_roofline.maskrcnn", "roi_align_roofline.maskrcnn"]
    for n in names:
        mod, m = harness.load_metric(n), per_layer[n]
        assert (mod.SOURCE, mod.LAYER, mod.MOVES, mod.WORKLOADS) == (
            m["source"], m["layer"], m["moves"], m["workloads"]) == (
            mod.SOURCE, mod.LAYER, mod.MOVES, [CELL])


def test_stage_readers_read_the_counters(monkeypatch):
    from benchmark import program_readers

    counters = {"stage.detector.rpn.device_ms": 6.0, "stage.detector.rpn.calls": 3}
    monkeypatch.setattr(program_readers, "program_counters", lambda: counters)
    run = types.SimpleNamespace(stretch=types.SimpleNamespace(
        records=[types.SimpleNamespace(units=1)] * 3))
    assert harness.load_metric("rpn_ms.maskrcnn").read(run) == pytest.approx(2.0)
    assert harness.load_metric("mask_ms.maskrcnn").read(run) is None


def test_frame_macs_at_the_published_size():
    """A 480x640 frame at the published settings: ~123 GMAC, two thirds in the
    parts FCOS does not have."""
    cfg = harness.load_cell(CELL)["config_spec"]
    macs = maskrcnn_counts.frame_macs(cfg, 480, 640)
    g = {k: v / 1e9 for k, v in macs.items()}
    assert 24 < g["trunk"] < 26.5 and 16.5 < g["fpn"] < 18
    assert 14.5 < g["rpn"] < 15.5 and 13.5 < g["box"] < 14.5 and 51 < g["mask"] < 53
    assert maskrcnn_counts.level_sizes(480, 640)[-1] == (8, 10)


def test_roi_bytes_count_each_touched_value_once():
    """Two equal RoIs read the same values: the reads count once."""
    rois = np.asarray([[8.0, 8.0, 40.0, 40.0]], np.float32)
    one = maskrcnn_counts.roi_align_work([(24, 32)], [0.25], 2, rois, np.zeros(1, int), 7, 2)
    two = maskrcnn_counts.roi_align_work([(24, 32)], [0.25], 2, np.repeat(rois, 2, 0),
                                         np.zeros(2, int), 7, 2)
    out = 4 * 2 * 49
    assert two[0] - one[0] == out and two[1] == 2 * one[1]
    # RoI 8..40 at 1/4: 2..10, bins of 8/7: sample rows 2.57..9.43 -> rows 2..10
    assert one[0] == out + 4 * 2 * 9 * 9
    assert maskrcnn_counts.nms_bytes(64) == 21 * 64 + 8 * 64


def test_a_trace_reads_every_metric_on_the_cpu_stretch():
    """A traced cut run: the readers that need no card read; those of the
    device's intervals, kernels and CUDA events read nothing and raise
    nothing."""
    r = _run(trace=True)
    assert {"capture_s.maskrcnn", "mfu.maskrcnn"} <= set(r["metrics"])
    assert not {"nms_roofline.maskrcnn", "rpn_ms.maskrcnn", "detect_wait_ms.maskrcnn"} \
        & set(r["metrics"])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_the_cell_on_the_card(card):
    """At its own size with a traced stretch of 5 frames (the window long
    enough for the profiler's start): correct, every per-layer metric read,
    no roofline share over 100%."""
    r = harness.run_cell(CELL, 2**31 + 11, 20.0, True, time.perf_counter(), device="cuda",
                         overrides={"cell": {"trace_items": 5}})
    assert r["correct"] is True, r["checks"]
    wanted = {m["name"] for m in SPEC["per_layer"] if CELL in m["workloads"]}
    assert wanted <= set(r["metrics"]), wanted - set(r["metrics"])
    for name in ("nms_roofline.maskrcnn", "roi_align_roofline.maskrcnn"):
        assert 0 < r["metrics"][name]["value"] <= 100, r["metrics"][name]
    print({k: v["value"] for k, v in r["metrics"].items()})
