"""The port stands alone: importing every module of `happypose_tpu_torch`
loads neither JAX, Flax nor the JAX package."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import happypose_tpu_torch

ROOT = Path(happypose_tpu_torch.__file__).resolve().parents[1]


def test_port_imports_no_jax():
    modules = sorted(
        m.name for m in pkgutil.walk_packages(
            happypose_tpu_torch.__path__, prefix="happypose_tpu_torch."
        )
    )
    for name in ("ops.rasterizer_fused", "utils.weights_from_jax", "models.detector",
                 "inference.detector", "datasets.augmentations",
                 "lib3d.rotations", "lib3d.symmetries", "lib3d.distances", "ops.segment_ops",
                 "ops.rasterizer", "ops.roi_align", "models.pose_predictor",
                 "inference.icp_refiner", "inference.teaser_refiner", "inference.types",
                 "inference.pose_estimator", "evaluation.meters", "evaluation.bop19",
                 "utils.load_model"):
        assert f"happypose_tpu_torch.{name}" in modules
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'happypose_tpu'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
