"""A cut frame, and a tracked frame's refiner chunk, captured and replayed
on the card (marked `cuda`; they skip without one). It imports neither JAX
nor the JAX package, so that it runs where only the port is installed:

    python -m pytest --noconftest tests/test_torch_cuda_graphs_card.py -m cuda
"""

import dataclasses

import numpy as np
import pytest
import torch

from happypose_tpu_torch.bench import busy_share, frame_launches
from happypose_tpu_torch.inference.types import DetectionBatch, ObservationBatch
from happypose_tpu_torch.meshes.database import MeshDataBase
from happypose_tpu_torch.meshes.io import make_box_mesh, make_uv_sphere
from happypose_tpu_torch.ops import rasterizer_fused as rf
from happypose_tpu_torch.utils import load_model as lm
from happypose_tpu_torch.utils import profiling


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _cut_estimator(card, **inference):
    """megapose-RGB cut to WideResNet18 and 48x64 renders, with `inference`
    replacing keys of its inference configuration, on a sphere and a box."""
    db = MeshDataBase({"sphere": make_uv_sphere(radius=0.05, n_lat=12, n_lon=16),
                       "box": make_box_mesh((0.04, 0.03, 0.05))})
    spec = lm.NAMED_MODELS["megapose-RGB"]
    cut = {"backbone": "wide_resnet18", "render_size": (48, 64)}
    spec = dataclasses.replace(
        spec, refiner_cfg=dataclasses.replace(spec.refiner_cfg, **cut),
        coarse_cfg=dataclasses.replace(spec.coarse_cfg, **cut),
        inference_cfg=dataclasses.replace(spec.inference_cfg, **inference))
    return lm.load_named_model(spec, db, n_points=200, device=card)


def _frames(card, boxes, obj_ids):
    """Two seeded 120x160 frames, the second's boxes shifted by 6 px."""
    rs = np.random.RandomState(0)
    K = np.asarray([[200.0, 0, 80], [0, 200.0, 60], [0, 0, 1]], np.float32)
    return [(ObservationBatch.from_numpy(rs.rand(120, 160, 3).astype(np.float32), K, device=card),
             DetectionBatch.from_numpy(boxes + shift, obj_ids, device=card))
            for shift in (0.0, 6.0)]


def _graph_counts(cache: str):
    counters = profiling.counters()
    return {w: counters.get(f"graphs.{cache}.{w}", 0) for w in ("captures", "replays")}


@pytest.mark.cuda
def test_cut_frame_captures_on_the_card(card):
    """megapose-RGB cut to WideResNet18, 48x64 renders, an SO(3) grid of 8,
    top-2 and one iteration, on 120x160 frames with two seeded boxes: the
    graph is captured on one frame (the wrapper launches the frame twice:
    the warm-up and the capture) and replayed on another, which makes no
    new entry, runs `frame_launches` rasterizing kernels on the device and
    equals the eager pipeline on that frame (TF32 off) bit for bit. The
    frame's capture and replay run the refiner's chunk inside the frame's
    graph: they capture and replay no stage graph."""
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    est = _cut_estimator(card, SO3_grid_size=8, bsz_images=8, bsz_objects=2,
                         n_refiner_iterations=1, n_pose_hypotheses=2)
    frames = _frames(card, np.asarray([[30, 20, 80, 70], [90, 40, 140, 100]], np.float32),
                     np.asarray([0, 1]))
    n_frame = frame_launches(est.cfg, 2, est.SO3_grid.shape[0])
    n0, stage0 = rf.launches, _graph_counts("stage")
    est.run_inference_pipeline_jit(*frames[0])
    assert rf.launches - n0 == 2 * n_frame
    replayed = []
    profile = busy_share(lambda: replayed.append(est.run_inference_pipeline_jit(*frames[1])))
    assert profile["raster_kernels"] == n_frame
    assert len(est._pipeline_jit_cache) == 1
    assert _graph_counts("stage") == stage0
    graphed, eager = replayed[0], est.run_inference_pipeline(*frames[1])
    assert sorted(graphed) == sorted(eager)
    for k in eager:
        for f in dataclasses.fields(eager[k]):
            torch.testing.assert_close(getattr(graphed[k], f.name), getattr(eager[k], f.name),
                                       rtol=0, atol=0)


@pytest.mark.cuda
def test_forward_refiner_replays_its_stage_graph(card):
    """A tracked frame: `forward_refiner` on K = 3 estimates (one chunk of
    `bsz_objects` 4), one iteration. The first call captures the chunk's
    stage graph (the wrapper counts its warm-up and capture, one launch
    each); a call on another frame is one replay, with no capture and no
    launch counted by the wrapper, one rasterizing kernel on the device,
    and poses equal to the model's eager iteration (TF32 off) bit for bit."""
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    est = _cut_estimator(card, bsz_objects=4)
    boxes = np.asarray([[30, 20, 80, 70], [90, 40, 140, 100], [60, 60, 110, 110]], np.float32)
    frames = _frames(card, boxes, np.asarray([0, 1, 0]))
    inits = [est.make_TCO_init(obs, det) for obs, det in frames]
    counts, n0 = _graph_counts("stage"), rf.launches
    est.forward_refiner(frames[0][0], inits[0], 1)
    assert rf.launches - n0 == 2
    assert _graph_counts("stage") == {"captures": counts["captures"] + 1,
                                      "replays": counts["replays"]}
    out = []
    profile = busy_share(lambda: out.append(est.forward_refiner(frames[1][0], inits[1], 1)[0]))
    assert profile["raster_kernels"] == 1 and rf.launches - n0 == 2
    assert _graph_counts("stage") == {"captures": counts["captures"] + 1,
                                      "replays": counts["replays"] + 1}
    obs, init = frames[1][0], inits[1]
    with torch.inference_mode():
        ref = est.refiner_model(obs.rgb[init.batch_im_ids], init.K, init.obj_ids, init.poses,
                                est.assets, est.meshes.select(init.obj_ids),
                                n_iterations=1).TCO_output[-1]
    assert not torch.equal(ref, init.poses)
    torch.testing.assert_close(out[0].poses, ref, rtol=0, atol=0)
