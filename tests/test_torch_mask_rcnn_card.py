"""Mask R-CNN's two kernels on the card against their plain versions, at
the shapes of a 480x640 frame, and the detector's forward as one CUDA
graph (marked `cuda`; they skip without one). It imports neither JAX nor
the JAX package, so that it runs where only the port is installed:

    python -m pytest --noconftest tests/test_torch_mask_rcnn_card.py -m cuda

The kernels repeat their plain versions' float32 operations (built with
`--fmad=false`): NMS keeps the same candidates index for index, RoIAlign
agrees to float32 rounding (1e-6 of the features' largest value; the
reading is printed). Each test prints the kernel's time (CUDA events, the
median of 10 calls after a warm-up) and the plain version's (one call, on
the CPU).
"""

import time


import numpy as np
import pytest
import torch

from happypose_tpu_torch.inference.types import ObservationBatch
from happypose_tpu_torch.models import mask_rcnn as mr
from happypose_tpu_torch.ops import multiscale_roi_align as mra
from happypose_tpu_torch.ops import nms as nms_ops
from happypose_tpu_torch.utils import load_model as lm
from happypose_tpu_torch.utils import profiling


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _kernel_ms(fn):
    fn()
    times = []
    for _ in range(10):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[5]


def _plain_ms(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, 1e3 * (time.perf_counter() - t0)


def _clustered_boxes(rs, n, H=480, W=640):
    """Boxes around a few dozen centres (as an RPN's), sizes 4-400 px."""
    centres = rs.rand(40, 2) * [W, H]
    c = centres[rs.randint(0, 40, n)] + rs.randn(n, 2) * 12
    wh = np.exp(rs.rand(n, 2) * 4.6) * 4
    return np.concatenate([c - wh / 2, c + wh / 2], 1).astype(np.float32)


# (candidates, groups, budget, threshold): the RPN's level-aware NMS of a
# 480x640 frame (1000 + 1000 + 1000 + 900 + 240 candidates) and the box
# stage's class-aware NMS of its pair budget
NMS_SHAPES = [(4140, 5, 1000, 0.7), (4096, 21, 100, 0.5), (4096, 1, 100, 0.5)]


@pytest.mark.cuda
@pytest.mark.parametrize("n, n_groups, max_out, thr", NMS_SHAPES)
def test_nms_kernel_is_its_plain_version(card, n, n_groups, max_out, thr):
    rs = np.random.RandomState(n + n_groups)
    boxes = torch.from_numpy(_clustered_boxes(rs, 2 * n)).view(2, n, 4)
    scores = torch.from_numpy(rs.rand(2, n).astype(np.float32))
    groups = torch.from_numpy(rs.randint(0, n_groups, (2, n)))
    valid = torch.from_numpy(rs.rand(2, n) > 0.05)
    before = nms_ops.launches
    keep, kv = nms_ops.nms(boxes.to(card), scores.to(card), groups.to(card), valid.to(card),
                           thr, max_out)
    torch.cuda.synchronize()
    assert nms_ops.launches == before + 1
    (want, want_v), plain_ms = _plain_ms(
        lambda: nms_ops.nms_reference(boxes, scores, groups, valid, thr, max_out))
    assert torch.equal(kv.cpu(), want_v)
    assert torch.equal(keep.cpu()[want_v], want[want_v])
    args = [t[:1].to(card) for t in (boxes, scores, groups, valid)]
    ms = _kernel_ms(lambda: nms_ops.nms(*args, thr, max_out))
    print(f"nms n={n} groups={n_groups}: kept {int(want_v[0].sum())} of {max_out}; "
          f"one image {ms:.4f} ms on the card (sort and gathers included); "
          f"plain version {plain_ms:.1f} ms for two")


@pytest.mark.cuda
@pytest.mark.parametrize("size, n_rois", [(7, 1000), (14, 100)])
def test_roi_align_kernel_is_its_plain_version(card, size, n_rois):
    rs = np.random.RandomState(size)
    feats = [torch.from_numpy(rs.randn(1, 256, h, w).astype(np.float32))
             for h, w in ((120, 160), (60, 80), (30, 40), (15, 20))]
    xy = rs.rand(n_rois, 2) * [680, 520] - 20
    wh = np.exp(rs.rand(n_rois, 2) * 6.5)
    boxes = torch.from_numpy(np.concatenate([xy, xy + wh], 1).astype(np.float32))[None]
    scales = [mra.level_scale(f.shape[-2], 480) for f in feats]
    levels = mra.level_of(boxes, 2, 5)
    assert set(levels.flatten().tolist()) == {0, 1, 2, 3}
    before = mra.launches
    out = mra.multiscale_roi_align([f.to(card) for f in feats], scales, boxes.to(card),
                                   levels.to(card), size, 2)
    torch.cuda.synchronize()
    assert mra.launches == before + 1
    want, plain_ms = _plain_ms(
        lambda: mra.roi_align_reference(feats, scales, boxes, levels, size, 2))
    gap = float((out.cpu() - want).abs().max())
    top = max(float(f.abs().max()) for f in feats)
    args = ([f.to(card) for f in feats], scales, boxes.to(card), levels.to(card), size, 2)
    ms = _kernel_ms(lambda: mra.multiscale_roi_align(*args))
    print(f"roi_align {size}x{size} x {n_rois}: largest gap {gap} of {top}; "
          f"{ms:.4f} ms on the card; plain version {plain_ms:.1f} ms")
    assert gap <= 1e-6 * top


@pytest.mark.cuda
def test_a_frame_is_one_detector_replay(card):
    """Mask R-CNN at its published settings on a 480x640 frame: the first
    call captures the detector's graph, the second replays it with no
    capture; the two return the same detections and masks."""
    det = lm.load_detector(mr.MaskRCNNConfig(box_score_thresh=0.0), device=card,
                           image_size=(480, 640), seed=5)
    rgb = np.random.RandomState(0).rand(480, 640, 3).astype(np.float32)
    K = np.asarray([[600.0, 0, 320], [0, 600.0, 240], [0, 0, 1]], np.float32)
    obs = ObservationBatch.from_numpy(rgb, K, device=card)
    counters = profiling.counters()
    first, a = det.get_detections(obs, detection_th=0.0)
    mid = profiling.counters()
    second, b = det.get_detections(obs, detection_th=0.0)
    last = profiling.counters()

    def grown(c0, c1, what):
        return c1.get(f"graphs.detector.{what}", 0) - c0.get(f"graphs.detector.{what}", 0)

    assert grown(counters, mid, "captures") == 1
    assert grown(mid, last, "captures") == 0 and grown(mid, last, "replays") == 1
    assert first.n_rows == second.n_rows > 0
    assert a["masks"].shape == (first.n_rows, 480, 640) and a["masks"].any()
    assert torch.equal(first.boxes, second.boxes) and np.array_equal(a["masks"], b["masks"])
