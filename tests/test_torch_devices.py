"""The port's entry points run on the card unless the caller asks for the
CPU: their `device` defaults are "cuda" (read from the signatures, so no
card is needed), nothing in the port picks the CPU because no card is
present, and the kernel wrappers count a launch only where they launch."""

import inspect
import re
from pathlib import Path

import pytest
import torch

import happypose_tpu_torch
from happypose_tpu_torch.inference.types import DetectionBatch, ObservationBatch
from happypose_tpu_torch.meshes.database import MeshDataBase
from happypose_tpu_torch.ops import rasterizer_fused as rf
from happypose_tpu_torch.utils.load_model import load_detector, load_named_model

ENTRY_POINTS = {
    "load_named_model": load_named_model,
    "load_detector": load_detector,
    "ObservationBatch.from_numpy": ObservationBatch.from_numpy,
    "DetectionBatch.from_numpy": DetectionBatch.from_numpy,
    "MeshDataBase.batched": MeshDataBase.batched,
    "MeshDataBase.render_assets": MeshDataBase.render_assets,
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(name):
    default = inspect.signature(ENTRY_POINTS[name]).parameters["device"].default
    assert torch.device(default) == torch.device("cuda")


def test_port_never_falls_back_to_the_cpu():
    """No module decides its device from `torch.cuda.is_available()`, and no
    `device` parameter defaults to the CPU."""
    root = Path(happypose_tpu_torch.__file__).parent
    for path in sorted(root.rglob("*.py")):
        text = path.read_text()
        assert "is_available" not in text, path
        assert not re.search(r"device\s*(:[^=,)]+)?=\s*[\"']cpu[\"']\s*[,)]", text), path


@pytest.mark.parametrize("wrapper", ["raster_fused", "bin_faces"])
def test_cpu_tensors_count_no_launch(wrapper):
    """On CPU tensors the wrappers run the plain versions and the launch
    count stays where it was."""
    A = torch.zeros(2, rf.CHUNK, 3, rf.N_ROWS)
    A[:, :, 2, rf.N_AFF + 2:] = torch.tensor([3.0, 2.0, 40.0, 9.0])  # bbox of every face
    bbox = torch.tensor([3.0, 2.0, 40.0, 9.0]).expand(2, 1, 4).contiguous()
    before = rf.launches
    out = getattr(rf, wrapper)(A, bbox, (16, 64))
    assert rf.launches == before
    if wrapper == "raster_fused":
        assert out.shape == (2, rf.N_OUT, 16, 64) and out.device.type == "cpu"
    else:
        count, lists = out
        # u 2..41 reaches both tile columns, v 1..10 both tile rows
        assert count.tolist() == [[rf.CHUNK] * 4] * 2
        assert lists.tolist() == list(range(rf.CHUNK)) * 8


def _bench_variants():
    from happypose_tpu_torch.scripts import bench_raster

    return sorted(bench_raster.STEPS)


@pytest.mark.parametrize("step", _bench_variants())
def test_bench_variant_applies_to_the_kernel_source(step):
    """Each variant that `scripts/bench_raster.py --steps` builds is the
    committed kernel source with a few lines replaced: every replacement
    still finds its lines, once, and changes the source."""
    from happypose_tpu_torch.scripts import bench_raster

    source = (Path(happypose_tpu_torch.__file__).parent / "csrc" / "raster_fused.cu").read_text()
    assert bench_raster.variant_source(step) != source
