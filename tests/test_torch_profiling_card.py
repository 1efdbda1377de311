"""The stage times of a captured frame on the card (marked `cuda`; it skips
without one). It imports neither JAX nor the JAX package, so that it runs
where only the port is installed:

    python -m pytest --noconftest tests/test_torch_profiling_card.py -m cuda
"""

import dataclasses

import numpy as np
import pytest
import torch

from happypose_tpu_torch.inference.types import DetectionBatch, ObservationBatch
from happypose_tpu_torch.meshes.database import MeshDataBase
from happypose_tpu_torch.meshes.io import make_box_mesh, make_uv_sphere
from happypose_tpu_torch.utils import load_model as lm
from happypose_tpu_torch.utils import profiling

STAGES = ("estimator.coarse", "estimator.refine", "estimator.score")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _stage_delta(before):
    now = profiling.counters()
    return {k: now[k] - before.get(k, 0) for k in now
            if k.startswith("stage.") and now[k] != before.get(k, 0)}


@pytest.mark.cuda
def test_stage_times_survive_the_frame_graph(card):
    """megapose-RGB cut to ResNet34 at 48x64 renders, an SO(3) grid of 72,
    top-2 and two iterations, on 120x160 frames with two boxes: the frame
    is captured on one frame and replayed on another under the profiler.
    Each stage reads a positive device time once, their sum is no more than
    the call's device interval in the trace (the replay with its input
    copies and clones), the coarse stage leads, and an untraced replay adds
    nothing; the two replays count as replays and capture nothing. The
    eager refiner under the profiler reads its own time."""
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    db = MeshDataBase({"sphere": make_uv_sphere(radius=0.05, n_lat=12, n_lon=16),
                       "box": make_box_mesh((0.04, 0.03, 0.05))})
    spec = lm.NAMED_MODELS["megapose-RGB"]
    cut = {"render_size": (48, 64)}
    spec = dataclasses.replace(
        spec, refiner_cfg=dataclasses.replace(spec.refiner_cfg, **cut),
        coarse_cfg=dataclasses.replace(spec.coarse_cfg, **cut),
        inference_cfg=dataclasses.replace(spec.inference_cfg, SO3_grid_size=72, bsz_images=72,
                                          bsz_objects=4, n_refiner_iterations=2,
                                          n_pose_hypotheses=2))
    est = lm.load_named_model(spec, db, n_points=200, device=card)
    rs = np.random.RandomState(0)
    K = np.asarray([[200.0, 0, 80], [0, 200.0, 60], [0, 0, 1]], np.float32)
    boxes = np.asarray([[30, 20, 80, 70], [90, 40, 140, 100]], np.float32)
    frames = [(ObservationBatch.from_numpy(rs.rand(120, 160, 3).astype(np.float32), K, device=card),
               DetectionBatch.from_numpy(boxes + shift, np.asarray([0, 1]), device=card))
              for shift in (0.0, 6.0)]
    est.run_inference_pipeline_jit(*frames[0])
    graphs = before = profiling.counters()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        est.run_inference_pipeline_jit(*frames[1])
        torch.cuda.synchronize()
    profiling.flush()
    delta = _stage_delta(before)
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    interval_ms = (max(e.time_range.end for e in device)
                   - min(e.time_range.start for e in device)) / 1e3
    ms = {s: delta.get(f"stage.{s}.device_ms", 0.0) for s in STAGES}
    print(f"stage ms {ms}, the call's device interval {interval_ms:.3f} ms, "
          f"{len(device)} device events")
    assert {delta.get(f"stage.{s}.calls") for s in STAGES} == {1}
    assert all(v > 0 for v in ms.values())
    assert sum(ms.values()) <= interval_ms
    assert max(ms, key=ms.get) == "estimator.coarse"

    before = profiling.counters()
    est.run_inference_pipeline_jit(*frames[1])
    torch.cuda.synchronize()
    profiling.flush()
    assert _stage_delta(before) == {}
    now = profiling.counters()
    grown = {k: now[k] - graphs.get(k, 0) for k in now
             if k.startswith("graphs.pipeline.") and now[k] != graphs.get(k, 0)}
    assert grown == {"graphs.pipeline.replays": 2}  # two replays, no capture

    res = est.run_inference_pipeline(*frames[1])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        est.forward_refiner(frames[1][0], res["iteration=2"], 1)
    profiling.flush()
    eager = _stage_delta(before)
    print(f"eager stages {eager}")
    assert eager["stage.estimator.refine.calls"] == 1
    assert eager["stage.estimator.refine.device_ms"] > 0
