"""The port's own measurement (`utils/profiling.py`): spans under their
names and nesting in a `torch.profiler` trace, nothing recorded and no
CUDA event made without a profiler, the stage pairs read into counters
only for calls made while a profiler was active, and the `GraphCache`
counters, on the CPU (the card's test is `test_torch_profiling_card.py`)."""

import dataclasses
import json
import time

import numpy as np
import pytest
import torch
from torch import nn

from happypose_tpu_torch import bench
from happypose_tpu_torch.inference.types import DetectionBatch, ObservationBatch
from happypose_tpu_torch.meshes.database import MeshDataBase
from happypose_tpu_torch.meshes.io import make_box_mesh, make_uv_sphere
from happypose_tpu_torch.models.detector import DetectorConfig
from happypose_tpu_torch.training.synth_data import make_synth_batch, sample_synth_scenes
from happypose_tpu_torch.training.trainer import TrainState, make_optimizer, make_train_step
from happypose_tpu_torch.utils import load_model as lm
from happypose_tpu_torch.utils import profiling
from happypose_tpu_torch.utils.cuda_graphs import GraphCache

K = np.asarray([[80.0, 0, 32], [0, 80.0, 24], [0, 0, 1]], np.float32)
BOXES = np.asarray([[10, 8, 30, 30], [34, 14, 58, 40]], np.float32)


@pytest.fixture(scope="module")
def world():
    db = MeshDataBase({"sphere": make_uv_sphere(radius=0.05, n_lat=8, n_lon=10),
                       "box": make_box_mesh((0.04, 0.03, 0.05))})
    spec = lm.NAMED_MODELS["megapose-RGB"]
    cut = {"backbone": "wide_resnet18", "render_size": (24, 32)}
    spec = dataclasses.replace(
        spec, refiner_cfg=dataclasses.replace(spec.refiner_cfg, **cut),
        coarse_cfg=dataclasses.replace(spec.coarse_cfg, **cut),
        inference_cfg=dataclasses.replace(spec.inference_cfg, SO3_grid_size=8, bsz_images=8,
                                          bsz_objects=4, n_refiner_iterations=1,
                                          n_pose_hypotheses=2))
    est = lm.load_named_model(spec, db, n_points=64, device="cpu")
    detector = lm.load_detector(DetectorConfig(n_classes=2, n_prototypes=8, fpn_channels=32,
                                               head_depth=1), device="cpu", image_size=(48, 64))
    rgb = np.random.RandomState(0).rand(48, 64, 3).astype(np.float32)
    return {"db": db, "est": est, "detector": detector, "rgb": rgb}


def _frame(world):
    obs = ObservationBatch.from_numpy(world["rgb"], K, device="cpu")
    return obs, DetectionBatch.from_numpy(BOXES, np.asarray([0, 1]), device="cpu")


def _spans(prof):
    """(name, parent's name) of every dotted span of the trace."""
    return {(e.name, e.cpu_parent.name if e.cpu_parent else None)
            for e in prof.events() if "." in e.name and not e.name.startswith("aten::")}


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return _spans(prof)


def test_serving_spans_nest_under_their_layers(world):
    """The frame (`estimator.frame`) holds the cache's call, which holds the
    stages, which hold the predictor's iterations; uploads and the detector
    have their own spans. The first call of a key is `graphs.capture`, a
    later one `graphs.replay` (on the CPU both run the function plainly)."""
    est, detector = world["est"], world["detector"]
    first = _profiled(lambda: est.run_inference_pipeline_jit(*_frame(world)))
    later = _profiled(lambda: est.run_inference_pipeline_jit(*_frame(world)))
    stages = {("estimator.coarse", "graphs.capture"), ("estimator.refine", "graphs.capture"),
              ("estimator.score", "graphs.capture")}
    assert {("obs.upload", None), ("estimator.frame", None),
            ("graphs.capture", "estimator.frame")} | stages <= first
    assert ("graphs.replay", "estimator.frame") in later and ("graphs.capture", None) not in later
    assert {(s, "graphs.replay") for s, _ in stages} <= later
    for layer in ("estimator.coarse", "estimator.refine", "estimator.score"):
        assert {(f"predictor.{p}", layer) for p in ("crop", "render", "net", "update")} <= first
    obs, _ = _frame(world)
    detect = _profiled(lambda: detector.get_detections(obs, detection_th=0.0, max_detections=4))
    assert {("detector.forward", None), ("graphs.capture", "detector.forward"),
            ("detector.postprocess", None), ("obs.upload", "detector.postprocess")} <= detect


@pytest.mark.parametrize("module, name", [
    (torch._C._profiler, "_RecordFunctionFast"),
    (torch.autograd.profiler, "_is_profiler_enabled"),
])
def test_the_private_profiler_api_is_there(module, name):
    """`annotate` and `stage` rest on two private names of PyTorch: the
    operator event a span is recorded as, and the flag that says whether a
    profiler is active. A PyTorch that renames either fails here, by name,
    and not by spans that silently go missing."""
    assert hasattr(module, name), (
        f"{module.__name__}.{name} is gone from PyTorch {torch.__version__}: "
        "happypose_tpu_torch.utils.profiling needs another way to record spans")
    if name == "_is_profiler_enabled":
        assert getattr(module, name) is False
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            assert getattr(module, name) is True
        assert getattr(module, name) is False


def test_spans_are_operator_events(world, tmp_path):
    """A span is an operator's event in the trace, not a user annotation:
    the profiler mirrors user annotations on the device's timeline, where a
    reader would count them as device work."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        world["est"].run_inference_pipeline_jit(*_frame(world))
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    cats = {e.get("cat") for e in events if e.get("name") in ("estimator.frame", "obs.upload",
                                                              "estimator.coarse", "graphs.replay")}
    assert cats == {"cpu_op"}


def test_training_spans_nest_under_the_step(world):
    """`train.batch` holds the synthetic batch's cache call; `train.step`
    holds the step's, and `train.read` the metrics' host read."""
    assets = world["db"].render_assets(device="cpu")
    draws = sample_synth_scenes(torch.Generator().manual_seed(0), 2, 2, resolution=(16, 24))
    model = nn.Linear(3, 2)
    state = TrainState(model, make_optimizer(model.parameters(), n_warmup_steps=1))

    def loss_fn(batch, _):
        loss = model(batch.images.mean((2, 3))).square().mean()
        return loss, {"loss_sq": loss.detach()}

    step = make_train_step(loss_fn)

    def run():
        step(state, make_synth_batch(assets, torch.from_numpy(K), draws), {})

    run()
    spans = _profiled(run)
    assert {("train.batch", None), ("graphs.replay", "train.batch"), ("train.step", None),
            ("graphs.replay", "train.step"), ("train.read", "train.step")} <= spans


def test_no_profiler_no_record_and_no_event(world, monkeypatch):
    """Without a profiler, `annotate` and `stage` return one shared no-op
    context: a whole frame, a detection and a stage record no profiler
    event and make no CUDA event, and no stage counter moves. The per-call
    cost of either, against `record_function`'s, is printed."""
    made = []
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", lambda *a: made.append(a))
    monkeypatch.setattr(torch.profiler, "record_function", lambda *a: made.append(a))
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **k: made.append(k))
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    before = profiling.counters()
    assert profiling.annotate("a.b") is profiling.stage("c.d") is profiling.annotate("e.f")
    world["est"].run_inference_pipeline_jit(*_frame(world))
    world["est"].forward_refiner(*_eager_inputs(world), 1)
    world["detector"].get_detections(_frame(world)[0], detection_th=0.0, max_detections=4)
    assert made == []
    assert {k: v for k, v in profiling.counters().items() if k.startswith("stage.")} == \
        {k: v for k, v in before.items() if k.startswith("stage.")}
    monkeypatch.undo()

    def per_call_ns(ctx, n=20000):
        t0 = time.perf_counter()
        for _ in range(n):
            with ctx("estimator.refine"):
                pass
        return (time.perf_counter() - t0) / n * 1e9

    costs = {f.__name__: per_call_ns(f) for f in (profiling.annotate, profiling.stage,
                                                  torch.profiler.record_function)}
    print(f"per call, no profiler: {costs}")
    assert max(costs["annotate"], costs["stage"]) < costs["record_function"] / 3


def _eager_inputs(world):
    obs, det = _frame(world)
    est = world["est"]
    init = est.make_TCO_init(obs, det)
    return obs, init


class _FakeEvent:
    """A CUDA event's timing with a host counter for a clock: a pair reads
    the number of records made between its two."""

    clock = 0

    def __init__(self, **_):
        self.at = None

    def record(self):
        _FakeEvent.clock += 1
        self.at = _FakeEvent.clock

    def synchronize(self):
        assert self.at is not None

    def elapsed_time(self, end):
        return float(end.at - self.at)


def test_stage_pairs_count_only_under_a_profiler(monkeypatch):
    """Eager: a pair is made and read only while a profiler is active.
    Captured: the pairs go with the capture whether or not a profiler is
    active, and a replay hands them to be read only under one; `flush`
    adds each pair's milliseconds and one call."""
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)

    def delta(before):
        now = profiling.counters()
        return {k: now[k] - before.get(k, 0) for k in now if k.startswith("stage.probe")
                and now[k] != before.get(k, 0)}

    before = profiling.counters()
    with profiling.stage("probe.eager"):
        pass
    profiling.flush()
    assert delta(before) == {}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(2):
            with profiling.stage("probe.eager"):
                _FakeEvent().record()  # one record inside: the pair reads 2
    profiling.flush()
    assert delta(before) == {"stage.probe.eager.device_ms": 4.0, "stage.probe.eager.calls": 2}

    before = profiling.counters()
    with profiling.capturing_stages() as pairs:
        with profiling.stage("probe.captured"):
            pass
    assert [p[0] for p in pairs] == ["probe.captured"]
    profiling.replayed(pairs)
    profiling.flush()
    assert delta(before) == {}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.replayed(pairs)
    profiling.flush()
    assert delta(before) == {"stage.probe.captured.device_ms": 1.0,
                             "stage.probe.captured.calls": 1}


def test_graph_cache_counts_by_name():
    """A CPU cache counts its captures (a key's first call), their seconds
    (0 on the CPU: `capture_seconds` reads the same records) and its
    replays, under its name."""
    cache = GraphCache("probe_counts")
    before = profiling.counters()
    x = torch.arange(4.0)
    for y in (x, x + 1, torch.arange(3.0), x):
        cache("k", lambda t: t * 2, (y,))
    now = profiling.counters()
    assert {k: now[k] - before.get(k, 0) for k in now if k.startswith("graphs.probe_counts.")} \
        == {"graphs.probe_counts.captures": 2, "graphs.probe_counts.replays": 2,
            "graphs.probe_counts.capture_s": sum(cache.capture_seconds)}


def test_busy_share_takes_the_union_of_intervals():
    """`bench.busy_share` counts a stretch in which kernels overlap once,
    so its share cannot pass 1."""
    assert bench._union_s([(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.8)]) == 4.0
    assert bench._union_s([]) == 0.0
