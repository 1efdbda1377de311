"""FCOS's NMS on the card (marked `cuda`; it skips without one): the
detector's post-processing runs `ops.nms`'s kernels inside the detector's
CUDA graph. It imports neither JAX nor the JAX package, so that it runs
where only the port is installed:

    python -m pytest --noconftest tests/test_torch_detector_card.py -m cuda
"""

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from happypose_tpu_torch.inference.types import ObservationBatch
from happypose_tpu_torch.models import detector as td
from happypose_tpu_torch.ops import nms as nms_ops
from happypose_tpu_torch.utils import load_model as lm
from happypose_tpu_torch.utils import profiling


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_fcos_nms_runs_on_the_card_inside_the_detector_graph(card, monkeypatch):
    """The full-width FCOS detector (ResNet50-FPN) at 240x320, B = 2, seeded:
    its NMS (256 candidates, labels as groups, budget 32) on the card keeps
    `nms_reference`'s indices in every slot; a second frame is one replay
    whose device trace holds both NMS kernels and no device-to-host copy
    (the copies are the read-back's, after the replay)."""
    det = lm.load_detector(td.DetectorConfig(n_classes=21), seed=0, device=card)
    x = torch.from_numpy(np.random.RandomState(0).rand(2, 3, *det.image_size)
                         .astype(np.float32)).to(card)
    calls = []

    def recorded(*args):
        calls.append((args, nms_ops.nms(*args)))
        return calls[-1][1]

    with monkeypatch.context() as m, torch.inference_mode():
        m.setattr(td, "nms", recorded)
        td.detector_postprocess(det.model(x))
    (boxes, scores, labels, valid, thr, max_out), (keep, kv) = calls[0]
    assert scores.shape == (2, 256) and max_out == 32 and bool(valid.all())
    want, want_v = nms_ops.nms_reference(boxes.cpu(), scores.cpu(), labels.cpu(), valid.cpu(),
                                         thr, max_out)
    assert torch.equal(kv.cpu(), want_v) and torch.equal(keep.cpu(), want)
    assert 0 < int(want_v.sum()) <= 2 * max_out

    obs = ObservationBatch(rgb=x, K=torch.eye(3, device=card).expand(2, 3, 3))
    first, _ = det.get_detections(obs, detection_th=0.0)
    launches, before = nms_ops.launches, profiling.counters()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        det._detect(x, 0.5, 32)  # what the span `detector.forward` holds
        torch.cuda.synchronize()
    after = profiling.counters()
    assert after.get("graphs.detector.replays", 0) == before.get("graphs.detector.replays", 0) + 1
    assert after["graphs.detector.captures"] == before["graphs.detector.captures"]
    assert nms_ops.launches == launches  # a replay runs no Python
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert sum("nms_mask_kernel" in n for n in names) == 1
    assert sum("nms_scan_kernel" in n for n in names) == 1
    assert not [n for n in names if "DtoH" in n], [n for n in names if "Memcpy" in n]
    second, _ = det.get_detections(obs, detection_th=0.0)
    assert first.n_rows == second.n_rows > 0 and torch.equal(first.boxes, second.boxes)
    print(f"fcos nms: kept {int(want_v.sum())} of 2 x {max_out}; one replay traced "
          f"{len(names)} device events, none a device-to-host copy")
