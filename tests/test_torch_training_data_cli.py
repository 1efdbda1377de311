"""Training from data on disk through the port's CLIs, on the CPU at tiny
sizes: `record_synthetic_dataset` writes a split (BOP + WDS),
`run_pose_training --data` / `--stream` trains on it,
`eval_refiner_checkpoint --split-dir` measures the run on it, and
`run_detector_training` trains a detector whose run directory
`load_detector` serves."""

import json
import threading

import numpy as np
import pytest
import torch

from happypose_tpu_torch.scripts import (
    eval_refiner_checkpoint,
    record_synthetic_dataset,
    run_detector_training,
    run_pose_training,
)

torch.set_num_threads(2)

POSE_ARGS = ["--epochs", "1", "--epoch-size", "4", "--batch-size", "2", "--image-size", "48",
             "64", "--render-size", "24", "32", "--device", "cpu"]


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    out = tmp_path_factory.mktemp("split")
    assert record_synthetic_dataset.main([
        "--out-dir", str(out), "--n-frames", "6", "--resolution", "60", "80",
        "--batch-scenes", "4", "--write-models", "--wds",
        "--shard-size", "3", "--builtin-set", "textured", "--device", "cpu"]) == 0
    return out


def _log(run_dir):
    return [json.loads(x) for x in (run_dir / "log.txt").read_text().splitlines()]


@pytest.mark.parametrize("mode", ["split", "stream", "coarse"])
def test_run_pose_training_from_disk(split, mode, tmp_path):
    extra = {"split": ["--eval-every", "1"], "stream": ["--stream", "--stream-chunk", "3"],
             "coarse": ["--model-type", "coarse", "--coarse-hypotheses", "2"]}[mode]
    before = threading.active_count()
    run = tmp_path / "run"
    rc = run_pose_training.main(["--run-dir", str(run), "--data", str(split), "--models-dir",
                                 str(split / "models")] + POSE_ARGS + extra)
    assert rc == 0 and threading.active_count() == before  # the stream's thread ended
    (line,) = _log(run)
    assert np.isfinite(line["loss"]) and line["skipped_nonfinite"] == 0
    if mode == "split":
        assert np.isfinite(line["eval_trans_err"])
    cfg = json.loads((run / "config.json").read_text())
    assert cfg["data"] == str(split) and (run / "state_dict.pt").exists()


def test_run_pose_training_from_disk_draws_batches_in_jax_order(split, tmp_path, monkeypatch):
    """As in the JAX package: one batch for the model's initialization, one
    for the eval, then the training batches in order."""
    import happypose_tpu_torch.training as training

    drawn, trained = [], []

    class Counted:
        def __init__(self, ds):
            self.ds = ds

        def __iter__(self):
            for b in self.ds:
                drawn.append(b)
                yield b

    make_ds, make_step = run_pose_training.make_pose_dataset, training.make_train_step
    monkeypatch.setattr(run_pose_training, "make_pose_dataset",
                        lambda *a: Counted(make_ds(*a)))

    def recording_step(loss_fn, **kw):
        step = make_step(loss_fn, **kw)
        return lambda state, batch, draws: trained.append(batch) or step(state, batch, draws)

    monkeypatch.setattr(training, "make_train_step", recording_step)
    assert run_pose_training.main(["--run-dir", str(tmp_path / "run"), "--data", str(split),
                                   "--models-dir", str(split / "models"), "--eval-every", "1"]
                                  + POSE_ARGS) == 0
    assert len(drawn) == 4 and [id(b) for b in trained] == [id(b) for b in drawn[2:]]


def test_run_pose_training_from_disk_needs_models_and_shards(split, tmp_path):
    with pytest.raises(SystemExit):
        run_pose_training.main(["--run-dir", str(tmp_path / "a"), "--data", str(split)]
                               + POSE_ARGS)
    with pytest.raises(SystemExit, match="no WDS"):
        run_pose_training.main(["--run-dir", str(tmp_path / "b"), "--data", str(split / "000000"),
                                "--models-dir", str(split / "models"), "--stream"] + POSE_ARGS)


def test_eval_refiner_checkpoint_on_a_split(split, tmp_path):
    run = tmp_path / "run"
    assert run_pose_training.main(["--run-dir", str(run), "--data", str(split), "--models-dir",
                                   str(split / "models")] + POSE_ARGS) == 0
    assert eval_refiner_checkpoint.main([
        "--run-dir", str(run), "--split-dir", str(split), "--models-dir", str(split / "models"),
        "--n-batches", "2", "--batch-size", "2", "--image-size", "48", "64",
        "--n-iterations", "1", "--device", "cpu"]) == 0
    summary = json.loads((run / "refiner_eval.json").read_text())
    assert summary["data"] == str(split) and summary["n_samples"] == 4
    assert all(np.isfinite(v) for v in summary.values() if isinstance(v, float))
    with pytest.raises(SystemExit):
        eval_refiner_checkpoint.main(["--run-dir", str(run), "--split-dir", str(split),
                                      "--device", "cpu"])


def test_run_detector_training_writes_a_run_directory_load_detector_serves(split, tmp_path):
    from happypose_tpu_torch.datasets.bop import BOPSceneDataset
    from happypose_tpu_torch.inference.types import ObservationBatch
    from happypose_tpu_torch.utils.load_model import load_detector

    run = tmp_path / "det"
    common = ["--run-dir", str(run), "--split-dir", str(split), "--models-dir",
              str(split / "models"), "--epoch-size", "2", "--batch-size", "2", "--image-size",
              "64", "80", "--fpn-channels", "8", "--eval-interval", "1", "--eval-frames", "2",
              "--device", "cpu"]
    assert run_detector_training.main(common + ["--epochs", "2"]) == 0
    lines = _log(run)
    assert [x["epoch"] for x in lines] == [0, 1]
    assert all(np.isfinite(x["loss"]) and 0.0 <= x["mAP@0.5"] <= 1.0 for x in lines)
    state = torch.load(run / "state_dict.pt", weights_only=True)
    assert run_detector_training.main(common + ["--epochs", "3", "--resume"]) == 0
    assert [x["epoch"] for x in _log(run)] == [0, 1, 2]
    assert json.loads((run / "epoch.json").read_text())["epoch"] == 3
    moved = torch.load(run / "state_dict.pt", weights_only=True)
    assert not torch.equal(state["cls_head.weight"], moved["cls_head.weight"])
    assert not torch.equal(state["backbone.bn1.running_mean"], moved["backbone.bn1.running_mean"])

    det = load_detector(run, n_classes=2, device="cpu")
    assert det.image_size == (64, 80) and det.model.cfg.fpn_channels == 8
    obs = BOPSceneDataset(split)[0]
    batch = ObservationBatch.from_numpy(obs.rgb[None], obs.K[None], device="cpu")
    detections, _ = det.get_detections(batch, detection_th=0.0)
    assert len(detections.boxes) > 0 and torch.isfinite(detections.boxes).all()
