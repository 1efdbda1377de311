"""The port stands alone: importing every module of `happypose_tpu_torch`
loads neither JAX, Flax, msgpack nor the JAX package."""

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
                 "utils.load_model", "utils.png", "utils.timer", "utils.logging", "utils.config",
                 "csrc.fastply", "meshes.io", "meshes.database", "datasets.bop",
                 "datasets.object_datasets", "datasets.samplers", "datasets.datasets_cfg",
                 "ops.scene_renderer", "evaluation.bop_export", "evaluation.coco_export",
                 "evaluation.detection_meters", "evaluation.prediction_runner",
                 "scripts.run_eval", "scripts.run_full_eval", "scripts.run_detection_eval",
                 "scripts.run_inference_on_example", "visualization.plotter",
                 "visualization.gltf_export", "training.losses", "training.forward_loss",
                 "training.synth_data", "training.trainer", "utils.checkpoint",
                 "utils.profiling", "utils.random", "scripts.run_pose_training",
                 "scripts.eval_refiner_checkpoint", "scripts.eval_coarse_checkpoint",
                 "scripts.plot_training_log", "scripts.supervise", "utils.prefetch",
                 "datasets.pose_dataset", "datasets.scene_synth", "datasets.scene_record",
                 "datasets.web_scene_dataset", "datasets.streaming_pose_dataset",
                 "training.detector_loss", "scripts.record_synthetic_dataset",
                 "scripts.run_detector_training", "multiview.ransac",
                 "multiview.bundle_adjustment", "multiview.scene_predictor", "utils.colmap_io",
                 "scripts.run_multiview_eval", "scripts.run_custom_scenario",
                 "models.backbones", "utils.resources", "datasets.deepim_modelnet",
                 "scripts.preprocess_object_dataset", "scripts.download",
                 "scripts.run_accuracy_demo", "parallel", "parallel.distributed",
                 "parallel.mesh", "parallel.collectives", "lib3d", "meshes", "datasets",
                 "inference", "evaluation", "utils.flax_msgpack",
                 "utils.cuda_graphs", "models.mask_rcnn", "ops.nms",
                 "ops.multiscale_roi_align"):
        assert f"happypose_tpu_torch.{name}" in modules
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'msgpack', 'happypose_tpu'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_reads_and_writes_png_without_pil():
    """PNG files go through `utils/png.py`. PIL is named in three places
    only, each an import inside the function that needs it: a texture that
    is not a PNG, a `.jpg` frame, and the rectangles and text of
    `draw_boxes`. Reading and writing a BOP directory and the example's
    overlay load no PIL at all."""
    root = Path(happypose_tpu_torch.__file__).parent
    users = {}
    for path in sorted(root.rglob("*.py")):
        lines = [l for l in path.read_text().splitlines()
                 if l.strip().startswith(("import PIL", "from PIL"))]
        if lines:
            users[str(path.relative_to(root))] = lines
    assert sorted(users) == ["datasets/bop.py", "meshes/io.py", "visualization/plotter.py"]
    assert all(len(v) == 1 and v[0].startswith("    ") for v in users.values()), users
    code = (
        "import sys, tempfile, numpy as np\n"
        "from pathlib import Path\n"
        "from happypose_tpu_torch.datasets import bop\n"
        "from happypose_tpu_torch.meshes import io\n"
        "from happypose_tpu_torch.meshes.database import MeshDataBase\n"
        "from happypose_tpu_torch.visualization import make_contour_overlay\n"
        "from happypose_tpu_torch.utils.png import write_png\n"
        "root = Path(tempfile.mkdtemp())\n"
        "m = io.make_uv_sphere(with_uv=True); m.texture = io.make_procedural_texture(32, 0)\n"
        "bop.write_bop_models(root / 'models', MeshDataBase({'obj_000001': m}))\n"
        "obs = bop.SceneObservation(rgb=np.zeros((8, 8, 3), np.uint8), K=np.eye(3, dtype=np.float32),\n"
        "                           depth=np.ones((8, 8), np.float32))\n"
        "bop.write_bop_scene(root / 'test', 0, [obs])\n"
        "assert bop.BOPObjectDataset(root / 'models').mesh_db.meshes['obj_000001'].texture is not None\n"
        "assert bop.BOPSceneDataset(root / 'test', load_depth=True)[0].depth.max() == 1.0\n"
        "write_png(root / 'o.png', make_contour_overlay(obs.rgb, np.ones((8, 8), bool)))\n"
        "sys.exit(1 if 'PIL' in sys.modules else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
