"""The port's entry points run on the card unless the caller asks for the
CPU: their `device` defaults are "cuda" (read from the signatures, so no
card is needed), nothing in the port picks the CPU because no card is
present, and the kernel wrappers count a launch only where they launch."""

import ast
import inspect
import re
from pathlib import Path

import pytest
import torch

import happypose_tpu_torch
from happypose_tpu_torch.inference.types import DetectionBatch, ObservationBatch
from happypose_tpu_torch.meshes.database import MeshDataBase
from happypose_tpu_torch.ops import rasterizer_fused as rf
from happypose_tpu_torch.datasets.pose_dataset import PoseDataset
from happypose_tpu_torch.datasets.scene_record import BatchedSceneRecorder
from happypose_tpu_torch.datasets.streaming_pose_dataset import StreamingPoseDataset
from happypose_tpu_torch.multiview.bundle_adjustment import MultiviewRefinement
from happypose_tpu_torch.multiview.scene_predictor import MultiviewScenePredictor
from happypose_tpu_torch.utils.load_model import load_detector, load_named_model
from happypose_tpu_torch.utils.resources import get_device_memory, log_memory

ENTRY_POINTS = {
    "BatchedSceneRecorder": BatchedSceneRecorder,
    "PoseDataset": PoseDataset,
    "StreamingPoseDataset": StreamingPoseDataset,
    "load_named_model": load_named_model,
    "load_detector": load_detector,
    "ObservationBatch.from_numpy": ObservationBatch.from_numpy,
    "DetectionBatch.from_numpy": DetectionBatch.from_numpy,
    "MeshDataBase.batched": MeshDataBase.batched,
    "MeshDataBase.render_assets": MeshDataBase.render_assets,
    "MultiviewScenePredictor": MultiviewScenePredictor,
    "MultiviewRefinement": MultiviewRefinement,
    "get_device_memory": get_device_memory,
    "log_memory": log_memory,
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


# modules whose functions get tensors (or a mesh database) from the caller
# and have no `device` parameter: they work where their inputs live
FOLLOWERS = [
    "inference/icp_refiner.py", "inference/teaser_refiner.py", "evaluation/meters.py",
    "evaluation/bop19.py", "ops/roi_align.py", "ops/rasterizer.py", "ops/segment_ops.py",
    "lib3d/distances.py", "lib3d/rotations.py", "ops/scene_renderer.py",
    "datasets/augmentations.py", "multiview/ransac.py",
]
CREATORS = {"arange", "eye", "full", "zeros", "ones", "rand", "randn", "tensor", "as_tensor",
            "empty", "linspace", "Generator"}


@pytest.mark.parametrize("module", FOLLOWERS)
def test_module_follows_its_inputs_device(module):
    """Every call that makes a new tensor (`torch.arange`, `torch.eye`,
    `torch.rand`, `torch.as_tensor`, ...; the `*_like` forms inherit it)
    or a `torch.Generator` names its device, so nothing lands on the CPU
    because that is PyTorch's default; and no function of the module takes a
    `device` argument it could default."""
    path = Path(happypose_tpu_torch.__file__).parent / module
    tree = ast.parse(path.read_text())
    calls = [
        n for n in ast.walk(tree)
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
        and isinstance(n.func.value, ast.Name) and n.func.value.id == "torch"
        and n.func.attr in CREATORS
    ]
    for call in calls:
        assert any(k.arg == "device" for k in call.keywords), (
            f"{module}:{call.lineno}: torch.{call.func.attr} without device=")
    for fn in (n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)):
        names = [a.arg for a in fn.args.args + fn.args.kwonlyargs]
        assert "device" not in names or fn.name == "default_generator", f"{module}: {fn.name}"


def test_depth_refiners_and_evaluators_take_their_device_from_their_inputs():
    """The refiners' default generator lives on the poses' device; the
    refiners, `PoseErrorMeter`, `Bop19Evaluator` and `vsd_batch` have no
    `device` parameter: they compute where the assets and the mesh database
    they were given live. The pipeline's depth refiner renders through
    `render_batch_fused`, which launches the CUDA kernel for CUDA tensors
    or raises."""
    from happypose_tpu_torch.evaluation import bop19, meters
    from happypose_tpu_torch.inference import icp_refiner, pose_estimator, teaser_refiner

    assert icp_refiner.default_generator(torch.device("cpu")).device == torch.device("cpu")
    for fn in (icp_refiner.ICPRefiner.refine, teaser_refiner.TeaserRefiner.refine,
               icp_refiner.ICPRefiner.__init__, teaser_refiner.TeaserRefiner.__init__,
               meters.PoseErrorMeter.add, bop19.Bop19Evaluator.add_image, bop19.vsd_batch,
               pose_estimator.PoseEstimator.run_depth_refiner):
        assert "device" not in inspect.signature(fn).parameters, fn
    assert list(inspect.signature(icp_refiner.ICPRefiner.refine).parameters)[-1] == "generator"
    source = inspect.getsource(pose_estimator.PoseEstimator.run_depth_refiner)
    assert "render_batch_fused" in source and "render_batch," not in source
    assert bop19.render_batch_fused is rf.render_batch_fused


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


def test_multiview_fails_where_there_is_no_card():
    """The scene predictor places its meshes on its device and bundle
    adjustment its tensors: by default the card, and where there is none
    PyTorch's own error."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    import numpy as np

    from happypose_tpu_torch.meshes.io import make_box_mesh

    meshes = MeshDataBase({"box": make_box_mesh()}).batched(n_points=8, device="cpu")
    with pytest.raises((AssertionError, RuntimeError), match="CUDA|cuda"):
        MultiviewScenePredictor(meshes)
    with pytest.raises((AssertionError, RuntimeError), match="CUDA|cuda"):
        MultiviewRefinement(cand_TCO=np.eye(4)[None], cand_view_idx=np.zeros(1, int),
                            cand_obj_idx=np.zeros(1, int), cand_obj_ids=np.zeros(1, int),
                            K=np.eye(3)[None], meshes=meshes)


def test_parallel_entry_points_default_to_the_card():
    """`make_mesh` and `init_distributed_mode` take `device_type="cuda"`,
    whose backend is NCCL (gloo only for `cpu`, asked for by name); a
    `PoseEstimator` with a mesh and `schur_sharded` bundle adjustment run
    on the card by default (`PoseEstimator` follows its assets, which
    `render_assets` puts on the card; `MultiviewRefinement` takes
    `device="cuda"`)."""
    from happypose_tpu_torch.inference.pose_estimator import PoseEstimator
    from happypose_tpu_torch.parallel.distributed import backend_for, init_distributed_mode
    from happypose_tpu_torch.parallel.mesh import make_mesh

    for fn in (make_mesh, init_distributed_mode):
        assert inspect.signature(fn).parameters["device_type"].default == "cuda"
    assert (backend_for("cuda"), backend_for("cpu")) == ("nccl", "gloo")
    with pytest.raises(ValueError, match="no collective backend"):
        backend_for("mps")
    assert "device" not in inspect.signature(PoseEstimator).parameters
    assert inspect.signature(PoseEstimator).parameters["device_mesh"].default is None
    assert inspect.signature(MultiviewRefinement).parameters["device"].default == "cuda"


def test_make_mesh_fails_where_there_is_no_card():
    """`make_mesh()` makes an NCCL group of one rank: where NCCL or the card
    is missing it raises, and no gloo group stands in (in a subprocess, so
    that no group is left in the test's process)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    import subprocess
    import sys

    code = ("import torch.distributed as dist\n"
            "from happypose_tpu_torch.parallel import make_mesh\n"
            "try:\n"
            "    make_mesh()\n"
            "except Exception as e:\n"
            "    print('RAISED', type(e).__name__, dist.is_initialized() and dist.get_backend())\n")
    env = {k: v for k, v in __import__("os").environ.items()
           if k not in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT")}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, env=env,
                          cwd=Path(happypose_tpu_torch.__file__).resolve().parents[1])
    assert "RAISED" in proc.stdout, proc.stdout + proc.stderr
    assert "gloo" not in proc.stdout, proc.stdout


def test_device_memory_fails_where_there_is_no_card():
    """`get_device_memory()` asks PyTorch for the card: where there is none,
    PyTorch's own error; a CPU device reports nothing (zeros)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises((AssertionError, RuntimeError), match="CUDA|cuda|NVIDIA"):
        get_device_memory()
    assert set(get_device_memory("cpu").values()) == {0.0}


def test_runner_and_timer_default_to_the_card():
    from happypose_tpu_torch.evaluation.prediction_runner import PredictionRunner
    from happypose_tpu_torch.utils.timer import DeviceTimer

    assert PredictionRunner.__dataclass_fields__["device"].default == "cuda"
    assert inspect.signature(DeviceTimer.__init__).parameters["device"].default == "cuda"


CLIS = ["run_eval", "run_full_eval", "run_detection_eval", "run_inference_on_example",
        "run_pose_training", "eval_refiner_checkpoint", "eval_coarse_checkpoint",
        "record_synthetic_dataset", "run_detector_training", "run_multiview_eval",
        "run_custom_scenario", "run_accuracy_demo"]


@pytest.mark.parametrize("script", CLIS)
def test_cli_device_defaults_to_the_card(script):
    """Every CLI has `--device` with the default `cuda`."""
    source = (Path(happypose_tpu_torch.__file__).parent / "scripts" / f"{script}.py").read_text()
    assert re.search(r'add_argument\(\s*"--device",\s*default="cuda"', source), script


@pytest.mark.parametrize("script", ["run_eval", "run_detection_eval", "run_inference_on_example",
                                    "run_pose_training", "eval_refiner_checkpoint",
                                    "eval_coarse_checkpoint", "record_synthetic_dataset",
                                    "run_detector_training", "run_pose_training_from_data",
                                    "run_multiview_eval", "run_custom_scenario",
                                    "run_accuracy_demo"])
def test_cli_without_device_fails_where_there_is_no_card(script, tmp_path):
    """Without `--device cpu` a CLI asks PyTorch for the card: where there
    is none it fails with PyTorch's own error; it does not fall back. (Where
    a card is present the call runs on it instead.)"""
    import importlib

    from happypose_tpu_torch.datasets.bop import SceneObservation, write_bop_models, write_bop_scene
    from happypose_tpu_torch.meshes.io import make_box_mesh
    from happypose_tpu_torch.models.detector import DetectorConfig, FCOSDetector
    from happypose_tpu_torch.utils.load_model import save_run_dir

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    import numpy as np

    write_bop_models(tmp_path / "models", MeshDataBase({"obj_000001": make_box_mesh()}))
    write_bop_scene(tmp_path / "test", 0, [SceneObservation(
        rgb=np.zeros((24, 32, 3), np.uint8), K=np.eye(3, dtype=np.float32), obj_labels=["obj_000001"],
        TWO=np.eye(4, dtype=np.float32)[None], bboxes=np.asarray([[2.0, 2, 20, 20]], np.float32),
        visib_fract=np.ones(1, np.float32))])
    cfg = DetectorConfig(n_classes=1, fpn_channels=8)
    save_run_dir(tmp_path / "det", FCOSDetector(cfg).state_dict(), {"fpn_channels": 8})
    from happypose_tpu_torch.models.pose_predictor import PosePredictor, PosePredictorConfig

    for role in ("refiner", "coarse"):
        pose_cfg = PosePredictorConfig(backbone="wide_resnet18", render_size=(24, 32),
                                       predict_pose_update=role == "refiner",
                                       predict_rendered_views_logits=role == "coarse")
        save_run_dir(tmp_path / role, PosePredictor(pose_cfg).state_dict(),
                     {"backbone": "wide_resnet18", "render_size": [24, 32]})
    common = ["--split-dir", str(tmp_path / "test"), "--models-dir", str(tmp_path / "models"),
              "--out-dir", str(tmp_path / "out")]
    argv = {
        "run_eval": common + ["--so3-grid", "72"],
        "run_detection_eval": common + ["--detector-run", str(tmp_path / "det")],
        "run_inference_on_example": ["--example-dir", str(tmp_path / "ex"), "--make-example"],
        "run_pose_training": ["--run-dir", str(tmp_path / "run")],
        "eval_refiner_checkpoint": ["--run-dir", str(tmp_path / "refiner")],
        "eval_coarse_checkpoint": ["--coarse-dir", str(tmp_path / "coarse"), "--split-dir",
                                   str(tmp_path / "test"), "--models-dir", str(tmp_path / "models")],
        "record_synthetic_dataset": ["--out-dir", str(tmp_path / "rec"), "--n-frames", "1"],
        "run_detector_training": ["--run-dir", str(tmp_path / "det_run"), "--split-dir",
                                  str(tmp_path / "test"), "--models-dir", str(tmp_path / "models")],
        "run_pose_training_from_data": ["--run-dir", str(tmp_path / "run"), "--data",
                                        str(tmp_path / "test"), "--models-dir",
                                        str(tmp_path / "models")],
        "run_multiview_eval": ["--out-dir", str(tmp_path / "mv"), "--models-dir",
                               str(tmp_path / "models"), "--scenes-dir", str(tmp_path / "test")],
        # a scenario directory: models/, candidates.csv, scene_camera.json
        "run_custom_scenario": ["--scenario", str(tmp_path)],
        "run_accuracy_demo": ["--refiner-dir", str(tmp_path / "refiner"), "--coarse-dir",
                              str(tmp_path / "coarse"), "--n-scenes", "1"],
    }[script]
    from happypose_tpu_torch.evaluation.bop_export import save_bop_csv

    save_bop_csv(tmp_path / "candidates.csv", np.eye(4)[None], np.ones(1, int), np.zeros(1, int),
                 np.zeros(1, int), np.ones(1))
    (tmp_path / "scene_camera.json").write_text('{"0": {"cam_K": [1, 0, 0, 0, 1, 0, 0, 0, 1]}}')
    module = script.replace("_from_data", "")
    main = importlib.import_module(f"happypose_tpu_torch.scripts.{module}").main
    with pytest.raises((AssertionError, RuntimeError), match="CUDA|cuda"):
        main(argv)
