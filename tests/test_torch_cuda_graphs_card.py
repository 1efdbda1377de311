"""A cut frame captured and replayed on the card (marked `cuda`; it skips
without one). It imports neither JAX nor the JAX package, so that it runs
where only the port is installed:

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


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cut_frame_captures_on_the_card(card):
    """megapose-RGB cut to WideResNet18, 48x64 renders, an SO(3) grid of 8,
    top-2 and one iteration, on 120x160 frames with two seeded boxes: the
    graph is captured on one frame (the wrapper launches the frame twice:
    the warm-up and the capture) and replayed on another, which makes no
    new entry, runs `frame_launches` rasterizing kernels on the device and
    equals the eager pipeline on that frame (TF32 off) bit for bit."""
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    db = MeshDataBase({"sphere": make_uv_sphere(radius=0.05, n_lat=12, n_lon=16),
                       "box": make_box_mesh((0.04, 0.03, 0.05))})
    spec = lm.NAMED_MODELS["megapose-RGB"]
    cut = {"backbone": "wide_resnet18", "render_size": (48, 64)}
    spec = dataclasses.replace(
        spec, refiner_cfg=dataclasses.replace(spec.refiner_cfg, **cut),
        coarse_cfg=dataclasses.replace(spec.coarse_cfg, **cut),
        inference_cfg=dataclasses.replace(spec.inference_cfg, SO3_grid_size=8, bsz_images=8,
                                          bsz_objects=2, n_refiner_iterations=1,
                                          n_pose_hypotheses=2))
    est = lm.load_named_model(spec, db, n_points=200, device=card)
    rs = np.random.RandomState(0)
    K = np.asarray([[200.0, 0, 80], [0, 200.0, 60], [0, 0, 1]], np.float32)
    boxes = np.asarray([[30, 20, 80, 70], [90, 40, 140, 100]], np.float32)
    frames = [(ObservationBatch.from_numpy(rs.rand(120, 160, 3).astype(np.float32), K, device=card),
               DetectionBatch.from_numpy(boxes + shift, np.asarray([0, 1]), device=card))
              for shift in (0.0, 6.0)]
    n_frame = frame_launches(est.cfg, 2, est.SO3_grid.shape[0])
    n0 = rf.launches
    est.run_inference_pipeline_jit(*frames[0])
    assert rf.launches - n0 == 2 * n_frame
    replayed = []
    profile = busy_share(lambda: replayed.append(est.run_inference_pipeline_jit(*frames[1])))
    assert profile["raster_kernels"] == n_frame
    assert len(est._pipeline_jit_cache) == 1
    graphed, eager = replayed[0], est.run_inference_pipeline(*frames[1])
    assert sorted(graphed) == sorted(eager)
    for k in eager:
        for f in dataclasses.fields(eager[k]):
            torch.testing.assert_close(getattr(graphed[k], f.name), getattr(eager[k], f.name),
                                       rtol=0, atol=0)
