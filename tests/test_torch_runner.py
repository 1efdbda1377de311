"""The prediction runner, `run_eval` and the CLIs: the port against JAX on
a BOP directory on disk.

One directory (an icosphere and a box as `obj_000001/2.ply`, 3 frames of
120x160 rendered by the port, with depth) is written by the port and read
by both packages. Both runners get `cosypose-RGB` cut to WideResNet18,
60x80 renders and 2 refiner iterations, with the same perturbed weights
(Flax variables carried over by `weights_from_jax`); JAX renders with its
two-pass `reference` renderer, the port with the kernel's plain version.
Poses agree to 1e-5 for ground-truth and external detections, as in
`tests/test_torch_cosypose.py`; behind the detector, whose boxes agree to
1e-3 px, to 1e-4. The CLIs run with `--device cpu` on run directories of
the port (`config.json` + `state_dict.pt`) at the same cut width.
"""

import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import happypose_tpu.datasets.bop as jbop
import happypose_tpu.evaluation.meters as jmeters
import happypose_tpu.evaluation.prediction_runner as jrunner
import happypose_tpu_torch.datasets.bop as tbop
import happypose_tpu_torch.evaluation.meters as tmeters
import happypose_tpu_torch.evaluation.prediction_runner as trunner
from happypose_tpu.inference.detector import Detector as JaxDetector
from happypose_tpu.models import detector as jd
from happypose_tpu.utils import load_model as jax_load_model
from happypose_tpu_torch.evaluation.bop_export import load_bop_csv
from happypose_tpu_torch.evaluation.coco_export import load_coco_json
from happypose_tpu_torch.inference.types import PoseEstimateBatch
from happypose_tpu_torch.meshes.database import MeshDataBase
from happypose_tpu_torch.meshes.io import Mesh, make_box_mesh
from happypose_tpu_torch.models import detector as td
from happypose_tpu_torch.ops.rasterizer_fused import render_batch_fused
from happypose_tpu_torch.ops.scene_renderer import render_scenes
from happypose_tpu_torch.scripts import (
    run_detection_eval, run_eval, run_full_eval, run_inference_on_example,
)
from happypose_tpu_torch.utils import load_model as lm
from happypose_tpu_torch.utils.weights_from_jax import (
    detector_state_dict, pose_predictor_state_dict,
)
from test_torch_cosypose import _small
from test_torch_models import icosphere, perturb

torch.set_num_threads(2)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

FRAME = (120, 160)
DET_SIZE = (60, 80)  # half the frame: the aspect crop's scale is exact in float32
DET_CFG = dict(n_classes=2, fpn_channels=16)  # what a run directory can state
MAX_DET = 4
POSE_TOL = 1e-5  # metres and rotation-matrix entries, same detections on both sides
DETECTOR_POSE_TOL = 1e-4  # behind the detector: its boxes agree to 1e-3 px only
N_FRAMES = 3


def _write_dataset(root):
    """Icosphere + box as a BOP directory with 3 rendered frames (the box
    alone in the last)."""
    v, f, c = icosphere()
    db = MeshDataBase({"obj_000001": Mesh(vertices=v, faces=f, vertex_colors=c),
                       "obj_000002": make_box_mesh((0.04, 0.03, 0.05))})
    tbop.write_bop_models(root / "models", db)
    H, W = FRAME
    K = np.asarray([[180.0, 0, W / 2], [0, 180.0, H / 2], [0, 0, 1]], np.float32)
    rs = np.random.RandomState(7)
    obj_ids = np.asarray([0, 1, 0, 1, 1])
    scene_ids = np.asarray([0, 0, 1, 1, 2])
    TCO = np.tile(np.eye(4, dtype=np.float32), (5, 1, 1))
    TCO[:, :3, :3] = Rotation.random(5, random_state=rs).as_matrix()
    TCO[:, :3, 3] = [[-0.06, 0.01, 0.6], [0.06, -0.02, 0.55], [0.05, 0.02, 0.5],
                     [-0.07, -0.01, 0.62], [0.0, 0.0, 0.5]]
    assets = db.render_assets(device="cpu")
    args = (assets, torch.from_numpy(obj_ids), torch.from_numpy(scene_ids), torch.from_numpy(TCO),
            torch.from_numpy(np.tile(K, (5, 1, 1))))
    scenes = render_scenes(*args, torch.ones(5, dtype=torch.bool), n_scenes=N_FRAMES, resolution=FRAME)
    inst = render_batch_fused(*args[:2], *args[3:], resolution=FRAME)
    frames = []
    for i in range(N_FRAMES):
        rows = np.nonzero(scene_ids == i)[0]
        boxes = []
        for r in rows:
            ys, xs = np.nonzero(inst.mask[r].numpy())
            boxes.append([xs.min() - 2, ys.min() - 2, xs.max() + 2, ys.max() + 2])
        rgb = rs.rand(H, W, 3).astype(np.float32) * 0.3
        m = scenes.mask[i].numpy()
        rgb[m] = scenes.rgb[i].numpy()[m]
        frames.append(tbop.SceneObservation(
            rgb=(rgb * 255).astype(np.uint8), K=K, depth=scenes.depth[i].numpy(),
            obj_labels=[db.labels[obj_ids[r]] for r in rows], TWO=TCO[rows],
            bboxes=np.asarray(boxes, np.float32), visib_fract=np.ones(len(rows), np.float32),
            scene_id=2, view_id=10 + i,
        ))
    tbop.write_bop_scene(root / "test", 2, frames)
    return frames


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The directory, both packages' datasets, estimators with the same
    weights, detectors with the same weights, external detections."""
    root = tmp_path_factory.mktemp("bop")
    frames = _write_dataset(root)
    jobj, tobj = jbop.BOPObjectDataset(root / "models"), tbop.BOPObjectDataset(root / "models")
    jds, tds = jbop.BOPSceneDataset(root / "test"), tbop.BOPSceneDataset(root / "test")

    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_load_model.NAMED_MODELS, "cosypose-RGB-test",
                   _small(jax_load_model.NAMED_MODELS["cosypose-RGB"], renderer="reference"))
        jax_est = jax_load_model.load_named_model("cosypose-RGB-test", jobj.mesh_db, n_points=200)
    refiner_vars = perturb(jax_est.refiner_vars, seed=21)
    coarse_vars = perturb(jax_est.coarse_vars, seed=22)
    jax_est.refiner_vars = jax.tree.map(jnp.asarray, refiner_vars)
    jax_est.coarse_vars = jax.tree.map(jnp.asarray, coarse_vars)
    state_dicts = {"refiner": pose_predictor_state_dict(refiner_vars),
                   "coarse": pose_predictor_state_dict(coarse_vars)}
    spec = _small(lm.NAMED_MODELS["cosypose-RGB"])
    est = lm.load_named_model(spec, tobj.mesh_db, n_points=200, state_dicts=state_dicts, device="cpu")

    jax_model = jd.FCOSDetector(jd.DetectorConfig(**DET_CFG))
    det_vars = perturb(jax.jit(lambda k, x: jax_model.init(k, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 3, *DET_SIZE))), seed=5)
    jax_detector = JaxDetector(jax_model, det_vars)
    jax_detector.image_size = DET_SIZE
    detector = lm.load_detector(td.DetectorConfig(**DET_CFG), state_dict=detector_state_dict(det_vars),
                                image_size=DET_SIZE, device="cpu")

    rs = np.random.RandomState(3)
    external = {}
    for fr in frames[:2]:  # the last frame has no external detection
        boxes = np.concatenate([fr.bboxes + rs.uniform(-2, 2, fr.bboxes.shape),
                                rs.uniform(5, 100, (3, 4))]).astype(np.float32)
        boxes[:, 2:] = np.maximum(boxes[:, 2:], boxes[:, :2] + 8)
        # five rows for a budget of four, the last three with tied scores
        external[(fr.scene_id, fr.view_id)] = {
            "boxes": boxes, "labels": list(fr.obj_labels) + ["obj_000002", "obj_000001", "obj_000002"],
            "scores": np.asarray([0.9, 0.8, 0.5, 0.5, 0.5], np.float32),
        }
    return dict(root=root, frames=frames, jobj=jobj, tobj=tobj, jds=jds, tds=tds, jax_est=jax_est,
                est=est, spec=spec, state_dicts=state_dicts, jax_detector=jax_detector,
                detector=detector, det_vars=det_vars, external=external)


def _runners(world, detection_type):
    kw = dict(detection_type=detection_type, max_detections=MAX_DET, detection_th=0.0,
              one_instance_per_class=True, external_detections=world["external"])
    return (
        jrunner.PredictionRunner(scene_ds=world["jds"], estimator=world["jax_est"],
                                 mesh_db=world["jobj"].mesh_db, detector=world["jax_detector"], **kw),
        trunner.PredictionRunner(scene_ds=world["tds"], estimator=world["est"],
                                 mesh_db=world["tobj"].mesh_db, detector=world["detector"],
                                 device="cpu", **kw),
    )


@pytest.fixture(scope="module")
def predictions(world):
    out = {}
    for kind in ("gt", "external", "detector"):
        jr, tr = _runners(world, kind)
        out[kind] = (jr.get_predictions()["final"], tr.get_predictions()["final"], jr, tr)
    return out


@pytest.mark.parametrize("kind", ["gt", "external", "detector"])
def test_get_predictions_match_jax(predictions, kind):
    ref, out, _, tr = predictions[kind]
    n_rows = {"gt": [2, 2, 1], "external": [MAX_DET, MAX_DET], "detector": None}[kind]
    assert len(out) == len(ref) == (2 if kind == "external" else N_FRAMES)
    tol = DETECTOR_POSE_TOL if kind == "detector" else POSE_TOL
    for i, (r, t) in enumerate(zip(ref, out)):
        assert (t["scene_id"], t["view_id"]) == (r["scene_id"], r["view_id"]) == (2, 10 + i)
        np.testing.assert_array_equal(t["obj_ids"], r["obj_ids"])
        assert t["poses"].shape == r["poses"].shape and np.isfinite(t["poses"]).all()
        if n_rows:
            assert len(t["poses"]) == n_rows[i]
        else:
            assert 1 <= len(t["poses"]) <= 2  # one instance per class
        np.testing.assert_allclose(t["poses"], r["poses"], atol=tol, rtol=0)
        np.testing.assert_allclose(t["scores"], r["scores"], rtol=1e-4, atol=0)
        assert t["time"] > 0.0
    assert tr.get_predictions()["final"] is out  # cached on the runner


def test_external_detections_are_cut_to_the_best_scored(predictions, world):
    """Five external rows for a budget of four: the two best and, of the
    three tied ones, the first two (a stable sort), in both packages."""
    _, out, jr, tr = predictions["external"]
    obs = world["tds"][0]
    det, jdet = tr._detections_for(obs), jr._detections_for(world["jds"][0])
    assert det.n_rows == jdet.n_rows == 5
    cut = type(det).pad(det, MAX_DET)
    jcut = type(jdet).pad(jdet, MAX_DET)
    np.testing.assert_array_equal(cut.boxes.numpy(), np.asarray(jcut.boxes))
    np.testing.assert_array_equal(cut.boxes.numpy(), world["external"][(2, 10)]["boxes"][:4])
    assert out[0]["obj_ids"].tolist() == [0, 1, 1, 0]
    assert tr._detections_for(world["tds"][2]) is None  # no external detection for that frame


def test_detector_boxes_map_back_to_the_frame(world, predictions):
    _, _, jr, tr = predictions["detector"]
    for i in range(N_FRAMES):
        det, jdet = tr._detections_for(world["tds"][i]), jr._detections_for(world["jds"][i])
        assert det.n_rows == jdet.n_rows >= 1 and det.boxes.device.type == "cpu"
        np.testing.assert_array_equal(det.obj_ids.numpy(), np.asarray(jdet.obj_ids))
        np.testing.assert_allclose(det.boxes.numpy(), np.asarray(jdet.boxes), atol=2e-3, rtol=0)
    K_det = np.asarray([[90.0, 0, 40], [0, 90.0, 30], [0, 0, 1]])
    boxes = trunner.boxes_to_frame(np.asarray([[10.0, 5, 30, 25]]), world["frames"][0].K, K_det)
    np.testing.assert_allclose(boxes, [[20.0, 10, 60, 50]])


def test_gt_detections_respect_visibility_and_labels(world):
    _, tr = _runners(world, "gt")
    obs = dataclasses.replace(world["tds"][0], visib_fract=np.asarray([0.01, 0.9], np.float32))
    assert tr._detections_for(obs).obj_ids.tolist() == [1]
    unknown = dataclasses.replace(obs, obj_labels=["obj_000009", "obj_000009"])
    assert tr._detections_for(unknown) is None
    with pytest.raises(ValueError):
        dataclasses.replace(tr, detection_type="nope")._detections_for(obs)


@pytest.mark.parametrize("kind", ["gt", "external"])
def test_run_eval_summary_matches_jax(predictions, world, kind):
    """`run_eval` with the pose-error meter: counts and recalls equal, error
    means to 1e-5 (BOP19 scoring is held to JAX in test_torch_evaluation.py)."""
    _, _, jr, tr = predictions[kind]
    ref = jrunner.run_eval(jr, jmeters.PoseErrorMeter(
        meshes=world["jax_est"].meshes, is_symmetric=world["jobj"].is_symmetric))
    out = trunner.run_eval(tr, tmeters.PoseErrorMeter(
        meshes=world["est"].meshes, is_symmetric=world["tobj"].is_symmetric))
    assert sorted(out) == sorted(ref)
    assert out["n_gt"] == ref["n_gt"] == (5 if kind == "gt" else 4)
    for k, v in ref.items():
        if k.startswith("eval_seconds"):
            assert out[k] >= 0.0
        elif k.startswith("n_") or "<" in k or k == "5deg_5cm":
            assert out[k] == v, k
        else:
            np.testing.assert_allclose(out[k], v, atol=1e-5 if "deg" not in k else 1e-3, err_msg=k)


class _Recorder:
    """Stands in for an estimator; notes when the pipeline ran (the runner
    calls the graphed pipeline, `run_inference_pipeline_jit`, of an
    estimator without a device mesh)."""

    device_mesh = None
    _pipeline_jit_cache = ()  # no graphs: no frame key is ever added

    def __init__(self, events):
        self.events = events

    def run_inference_pipeline(self, obs, det):
        self.events.append("run")
        n = det.n_rows
        z = torch.zeros(n, dtype=torch.int64)
        return {"final": PoseEstimateBatch(
            poses=torch.eye(4).repeat(n, 1, 1), K=obs.K.expand(n, 3, 3), obj_ids=det.obj_ids,
            batch_im_ids=z, instance_ids=z, hypothesis_ids=z, scores=det.scores,
            coarse_logits=det.scores, pose_logits=det.scores, valid=torch.ones(n, dtype=torch.bool))}

    run_inference_pipeline_jit = run_inference_pipeline


def test_every_time_is_read_after_a_synchronization(world, monkeypatch):
    """The clock is read after the device has finished: around every
    frame's pipeline call and around both totals of `run_eval`; on the card
    `synchronize` is `torch.cuda.synchronize`, on the CPU nothing."""
    events = []
    runner = trunner.PredictionRunner(
        scene_ds=world["tds"], estimator=_Recorder(events), mesh_db=world["tobj"].mesh_db,
        device="cpu", max_frames=2)
    monkeypatch.setattr(trunner.PredictionRunner, "synchronize", lambda self: events.append("sync"))
    real_time = trunner.time.time
    clock = types.SimpleNamespace(time=lambda: events.append("clock") or real_time())
    monkeypatch.setattr(trunner, "time", clock)  # the runner's module only, not the logger's
    trunner.run_eval(runner, tmeters.PoseErrorMeter(meshes=world["est"].meshes))
    frame = ["sync", "clock", "run", "sync", "clock"]
    assert events[:2] == ["sync", "clock"] and events[2:12] == frame * 2
    assert events[12:] == ["sync", "clock", "clock", "sync", "clock"]
    monkeypatch.undo()
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: calls.append(device))
    dataclasses.replace(runner, device="cpu").synchronize()
    assert calls == []
    dataclasses.replace(runner, device="cuda:0").synchronize()
    assert calls == ["cuda:0"]
    assert trunner.PredictionRunner.__dataclass_fields__["device"].default == "cuda"


# -------------------------------------------------------------------- CLIs

@pytest.fixture(scope="module")
def run_dirs(world, tmp_path_factory):
    """Run directories of the port: a MegaPose-flavour pair (coarse
    classifier + refiner, seeded), a refiner alone with a perturbed pose
    head (the CosyPose branch without a coarse model; a run directory's
    config states backbone and render size, so it renders normals), the
    fixture's refiner, and the detector."""
    root = tmp_path_factory.mktemp("runs")
    config = {"backbone": "wide_resnet18", "render_size": [48, 64]}
    for role, coarse in (("refiner", False), ("coarse", True)):
        cfg = lm.PosePredictorConfig(backbone="wide_resnet18", render_size=(48, 64),
                                     predict_pose_update=not coarse,
                                     predict_rendered_views_logits=coarse)
        model = lm.PosePredictor(cfg).init_weights(torch.Generator().manual_seed(3 + coarse))
        lm.save_run_dir(root / "megapose" / role, model.state_dict(), config)
        if not coarse:
            with torch.no_grad():
                model.pose_fc.weight += torch.randn(
                    model.pose_fc.weight.shape, generator=torch.Generator().manual_seed(9)) * 3e-3
            lm.save_run_dir(root / "refiner_only" / role, model.state_dict(), config)
    lm.save_run_dir(root / "cosy" / "refiner", world["state_dicts"]["refiner"],
                    {"backbone": "wide_resnet18", "render_size": list(world["spec"].refiner_cfg.render_size)})
    lm.save_run_dir(root / "detector", detector_state_dict(world["det_vars"]),
                    {"fpn_channels": DET_CFG["fpn_channels"], "image_size": list(DET_SIZE)})
    return root


def _eval_args(world, out_dir, *extra):
    return ["--split-dir", str(world["root"] / "test"), "--models-dir", str(world["root"] / "models"),
            "--out-dir", str(out_dir), "--device", "cpu", *extra]


def test_run_eval_cli(world, run_dirs, tmp_path):
    """MegaPose flavour from run directories, ground-truth detections, BOP19."""
    assert run_eval.main(_eval_args(
        world, tmp_path, "--model", "from-checkpoints", "--checkpoints", str(run_dirs / "megapose"),
        "--so3-grid", "72", "--n-pose-hypotheses", "2", "--n-refiner-iterations", "1",
        "--max-frames", "2", "--bop19", "--vsd-render-size", "60", "80")) == 0
    summary = json.loads((tmp_path / "summary_rank0.json").read_text())
    assert summary["n_gt"] == 4 and 0.0 <= summary["bop19_AR"] <= 1.0
    assert len(summary["frame_seconds"]) == 2 and min(summary["frame_seconds"]) > 0.0
    csv = load_bop_csv(tmp_path / "preds_rank0.csv")
    assert csv["poses"].shape == (4, 4, 4)
    assert sorted(csv["obj_ids"][:2].tolist()) == sorted(csv["obj_ids"][2:].tolist()) == [1, 2]
    assert csv["view_ids"].tolist() == [10, 10, 11, 11] and np.isfinite(csv["poses"]).all()


def test_run_eval_cli_returns_the_runners_poses(world, run_dirs, tmp_path):
    """Refiner-only run directory, external
    detections from a BOP json: the csv holds the poses of `run`, which are
    the in-process runner's for the same detections."""
    dets = [{"scene_id": k[0], "image_id": k[1], "category_id": int(label.split("_")[1]),
             "bbox": [float(b[0]), float(b[1]), float(b[2] - b[0]), float(b[3] - b[1])],
             "score": float(s)}
            for k, d in world["external"].items()
            for b, label, s in zip(d["boxes"], d["labels"], d["scores"])]
    (tmp_path / "dets.json").write_text(json.dumps(dets))
    res = run_eval.run(_eval_args(
        world, tmp_path, "--model", "from-checkpoints", "--checkpoints", str(run_dirs / "refiner_only"),
        "--detections", "external", "--external-detections", str(tmp_path / "dets.json"),
        "--n-refiner-iterations", "2"))
    poses = np.concatenate([r["poses"] for r in res["predictions"]])
    csv = load_bop_csv(tmp_path / "preds_rank0.csv")
    np.testing.assert_allclose(csv["poses"], poses, atol=1e-6)
    assert poses.shape == (10, 4, 4)  # max_detections defaults to 8: nothing is cut
    # the same run in process
    spec = lm.spec_from_checkpoints({"refiner": run_dirs / "refiner_only" / "refiner"})
    assert spec.coarse_cfg is None and spec.refiner_cfg.render_size == (48, 64)
    est = lm.load_named_model(
        dataclasses.replace(spec, inference_cfg=dataclasses.replace(spec.inference_cfg,
                                                                    n_refiner_iterations=2)),
        world["tobj"].mesh_db, checkpoint_dirs={"refiner": run_dirs / "refiner_only" / "refiner"},
        device="cpu")
    runner = trunner.PredictionRunner(
        scene_ds=world["tds"], estimator=est, mesh_db=world["tobj"].mesh_db,
        detection_type="external", external_detections=world["external"], device="cpu")
    mine = np.concatenate([r["poses"] for r in runner.get_predictions()["final"]])
    np.testing.assert_allclose(poses, mine, atol=1e-6)


def test_run_eval_calls_do_not_share_overrides(world, tmp_path, monkeypatch):
    """Overrides are handed to `load_named_model` as a spec; the registry of
    named models stays as it was, so the next call starts from it."""
    seen = []

    class Stop(Exception):
        pass

    def fake_load(spec, mesh_db, **kw):
        seen.append((spec, kw))
        raise Stop

    registry = dict(lm.NAMED_MODELS)
    monkeypatch.setattr(lm, "load_named_model", fake_load)
    for extra in (["--so3-grid", "72", "--n-refiner-iterations", "1", "--n-pose-hypotheses", "2"], []):
        with pytest.raises(Stop):
            run_eval.main(_eval_args(world, tmp_path, "--model", "megapose-RGB", *extra))
    assert lm.NAMED_MODELS == registry
    (first, kw), (second, _) = seen
    assert kw["device"] == "cpu"
    cfg = first.inference_cfg
    assert (cfg.SO3_grid_size, cfg.bsz_images, cfg.n_refiner_iterations, cfg.n_pose_hypotheses) == (72, 72, 1, 2)
    assert second == registry["megapose-RGB"] and second.inference_cfg.SO3_grid_size == 576


def test_run_full_eval_cli(world, run_dirs, tmp_path):
    """Two settings in one process, each a call of `run_eval.main`."""
    (tmp_path / "dets.json").write_text(json.dumps(
        [{"scene_id": 2, "image_id": 10, "category_id": 2, "bbox": [60, 30, 40, 40], "score": 0.5}]))
    registry = dict(lm.NAMED_MODELS)
    assert run_full_eval.main([
        "--datasets", f"{world['root'] / 'test'}:{world['root'] / 'models'}",
        "--detections", "gt", "external", "--external-detections", str(tmp_path / "dets.json"),
        "--model", "from-checkpoints", "--checkpoints", str(run_dirs / "refiner_only"),
        "--n-refiner-iterations", "1", "--out-dir", str(tmp_path / "out"), "--device", "cpu"]) == 0
    assert lm.NAMED_MODELS == registry
    full = json.loads((tmp_path / "out" / "full_summary.json").read_text())
    name = world["root"].name
    assert sorted(full) == [f"{name}/external", f"{name}/gt"]
    assert full[f"{name}/gt"]["n_gt"] == 5 and full[f"{name}/external"]["n_gt"] == 2
    assert (tmp_path / "out" / name / "gt" / "preds_rank0.csv").exists()


def test_run_eval_cli_with_the_detector_in_front(world, run_dirs, tmp_path, predictions):
    res = run_eval.run(_eval_args(
        world, tmp_path, "--model", "from-checkpoints", "--checkpoints", str(run_dirs / "refiner_only"),
        "--detections", "detector", "--detector-run", str(run_dirs / "detector"),
        "--detection-th", "0.0", "--n-refiner-iterations", "1"))
    assert len(res["predictions"]) == N_FRAMES
    assert all(1 <= len(r["poses"]) <= 8 and np.isfinite(r["poses"]).all() for r in res["predictions"])


def test_run_detection_eval_cli(world, run_dirs, tmp_path, predictions):
    """The runner without an estimator: boxes from a detector run directory,
    mAP summary and a COCO json that reads back."""
    assert run_detection_eval.main(_eval_args(
        world, tmp_path, "--detector-run", str(run_dirs / "detector"), "--detection-th", "0.0",
        "--one-instance-per-class", "--max-detections", str(MAX_DET))) == 0
    summary = json.loads((tmp_path / "summary_rank0.json").read_text())
    assert summary["n_gt"] == 5 and summary["n_pred"] >= N_FRAMES
    coco = load_coco_json(tmp_path / "detections_rank0.json")
    assert len(coco) == summary["n_pred"] and {r["category_id"] for r in coco} <= {1, 2}
    # the boxes are the in-process runner's
    _, _, _, tr = predictions["detector"]
    det = tr._detections_for(world["tds"][0])
    first = [r for r in coco if r["image_id"] == 10]
    np.testing.assert_allclose(
        [[r["bbox"][0], r["bbox"][1], r["bbox"][0] + r["bbox"][2], r["bbox"][1] + r["bbox"][3]]
         for r in first], det.boxes.numpy(), atol=1e-3)


def test_run_inference_on_example_cli(run_dirs, tmp_path):
    """The quick start's first command with `--device cpu`, at a cut width."""
    from happypose_tpu_torch.utils.png import read_png

    assert run_inference_on_example.main([
        "--example-dir", str(tmp_path), "--make-example", "--device", "cpu",
        "--model", "from-checkpoints", "--checkpoints", str(run_dirs / "megapose")]) == 0
    records = json.loads((tmp_path / "outputs" / "object_data.json").read_text())
    assert [r["label"] for r in records] == ["obj_000002"]
    assert np.isfinite(np.asarray(records[0]["TWO"])).all()
    overlay = read_png(tmp_path / "outputs" / "all_results.png")
    assert overlay.shape == (240, 320, 3) and overlay.dtype == np.uint8 and overlay.max() > 0
    assert (tmp_path / "outputs" / "scene.glb").read_bytes()[:4] == b"glTF"
    # the example is a BOP directory that both packages read alike
    a = tbop.BOPSceneDataset(tmp_path / "scene", load_depth=True)[0]
    b = jbop.BOPSceneDataset(tmp_path / "scene", load_depth=True)[0]
    np.testing.assert_array_equal(a.rgb, b.rgb)
    np.testing.assert_array_equal(a.depth, b.depth)
    np.testing.assert_array_equal(a.TWO, b.TWO)


def test_run_directories(world, run_dirs, tmp_path):
    """`save_run_dir` / `checkpoint_dirs` / `load_detector(run_dir, n_classes)`:
    the weights that were saved are the weights that run."""
    est = lm.load_named_model(world["spec"], world["tobj"].mesh_db, n_points=50, device="cpu",
                              checkpoint_dirs={"refiner": run_dirs / "cosy" / "refiner"})
    for k, v in world["state_dicts"]["refiner"].items():
        assert torch.equal(est.refiner_model.state_dict()[k], v), k
    detector = lm.load_detector(run_dirs / "detector", 2, device="cpu")
    assert detector.image_size == DET_SIZE and detector.model.cfg.fpn_channels == 16
    for k, v in world["detector"].model.state_dict().items():
        assert torch.equal(detector.model.state_dict()[k], v), k
    with pytest.raises(FileNotFoundError, match="state_dict.pt"):
        lm.load_named_model(world["spec"], world["tobj"].mesh_db, device="cpu",
                            checkpoint_dirs={"refiner": tmp_path})
    with pytest.raises(ValueError, match="n_classes"):
        lm.load_detector(run_dirs / "detector", device="cpu")
    (tmp_path / "config.json").write_text(json.dumps({"bf16": True}))
    assert lm.spec_from_checkpoints({"refiner": tmp_path}).refiner_cfg.compute_dtype == "bfloat16"
    spec = lm.spec_from_checkpoints({"refiner": run_dirs / "megapose" / "refiner",
                                     "coarse": run_dirs / "megapose" / "coarse"})
    assert spec.coarse_cfg.predict_rendered_views_logits and not spec.coarse_cfg.predict_pose_update
    assert spec.refiner_cfg.render_size == (48, 64) and spec.refiner_cfg.backbone == "wide_resnet18"
    assert spec.refiner_cfg.compute_dtype == "float32"
