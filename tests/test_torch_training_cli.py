"""The train step and the training CLIs of the port on the CPU at a tiny
size: the skip of a non-finite step, `run_pose_training` (run directory,
JAX's log keys, resume, a corrupt state dict, warm start, the curriculum,
bfloat16, the profiler, the paths that refuse their arguments, `--dp`
without a launcher),
`eval_refiner_checkpoint`, `eval_coarse_checkpoint`, `plot_training_log`
against JAX's and `supervise`.

Every run passes `--device cpu`: the CLIs default to the card.
"""

import json
import shutil
import sys

import numpy as np
import pytest
import torch

from happypose_tpu.scripts import plot_training_log as jax_plot
from happypose_tpu_torch.models.pose_predictor import PosePredictor, PosePredictorConfig
from happypose_tpu_torch.scripts import (
    eval_coarse_checkpoint, eval_refiner_checkpoint, plot_training_log, run_pose_training,
    supervise,
)
from happypose_tpu_torch.training import TrainState, make_optimizer, make_train_step
from happypose_tpu_torch.training.forward_loss import make_refiner_loss_fn
from happypose_tpu_torch.training.synth_data import (
    make_synth_batch, make_synth_mesh_db, sample_synth_scenes,
)
from happypose_tpu_torch.utils.checkpoint import load_checkpoint
from happypose_tpu_torch.utils.load_model import (
    load_named_model, read_state_dict, spec_from_checkpoints,
)

torch.set_num_threads(2)
TINY = ["--data", "synth", "--epoch-size", "4", "--batch-size", "2", "--image-size", "48", "64",
        "--render-size", "24", "32", "--device", "cpu", "--save-every", "1"]


def _tiny_world(B=2):
    db = make_synth_mesh_db("debug")
    assets, meshes = db.render_assets(device="cpu"), db.batched(n_points=64, device="cpu")
    K1 = torch.tensor([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]])
    model = PosePredictor(PosePredictorConfig(backbone="wide_resnet18", render_size=(24, 32)))
    model.init_weights(torch.Generator().manual_seed(0))
    loss_fn = make_refiner_loss_fn(model, assets, meshes, n_iterations=2)

    def batch(seed):
        return make_synth_batch(assets, K1, sample_synth_scenes(
            torch.Generator().manual_seed(seed), 2, B, (48, 64), z_range=(0.3, 0.4)))

    return model, loss_fn, batch


def _snapshot(state):
    return ({k: v.clone() for k, v in state.model.state_dict().items()},
            {i: {k: v.clone() if torch.is_tensor(v) else v for k, v in s.items()}
             for i, s in state.optimizer.adam.state_dict()["state"].items()},
            state.optimizer.count)


def test_nonfinite_step_changes_nothing():
    """A batch with a NaN pixel: `skipped_nonfinite` 1, `loss` and
    `grad_norm` 0 (as JAX reports them), and the parameters, the BatchNorm
    running statistics (written by the forward), Adam's moments and step
    counts and the schedule's count bit-equal to before. The next finite
    step is applied and counted."""
    model, loss_fn, batch = _tiny_world()
    state = TrainState(model, make_optimizer(model.parameters(), lr=1e-3, n_warmup_steps=2))
    step = make_train_step(loss_fn)
    g = torch.Generator().manual_seed(1)
    m = step(state, batch(0), loss_fn.sample(g, batch(0)))
    assert m["skipped_nonfinite"] == 0 and m["loss"] > 0 and m["grad_norm"] > 0
    assert state.optimizer.count == 1 and state.step == 1
    before = _snapshot(state)

    bad = batch(1)
    bad.images[1, 0, 10, 10] = float("nan")
    m = step(state, bad, loss_fn.sample(g, bad))
    assert m["skipped_nonfinite"] == 1 and m["loss"] == 0 and m["grad_norm"] == 0
    after = _snapshot(state)
    for k in before[0]:
        assert torch.equal(before[0][k], after[0][k]), k
    for i in before[1]:
        for k, v in before[1][i].items():
            assert torch.equal(v, after[1][i][k]), (i, k)
    assert before[2] == after[2] == 1 and state.step == 2

    m = step(state, batch(2), loss_fn.sample(g, batch(2)))
    assert m["skipped_nonfinite"] == 0 and state.optimizer.count == 2
    assert not torch.equal(state.model.state_dict()["pose_fc.weight"], before[0]["pose_fc.weight"])
    assert not torch.equal(state.model.state_dict()["backbone.bn1.running_mean"],
                           before[0]["backbone.bn1.running_mean"])


def test_step_clips_by_the_global_norm():
    """With a clip far below the gradient's norm, Adam's first moment after
    one step is (1 - b1) x the clipped gradient: g x clip / norm (optax's
    `clip_by_global_norm`), and the reported `grad_norm` is the unclipped
    one."""
    model, loss_fn, batch = _tiny_world()
    state = TrainState(model, make_optimizer(model.parameters(), lr=1e-3, clip_grad_norm=1e-3))
    b = batch(0)
    draws = loss_fn.sample(torch.Generator().manual_seed(1), b)
    loss, _ = loss_fn(b, draws)
    loss.backward()
    g0 = model.pose_fc.weight.grad.clone()
    for p in model.parameters():  # the step recomputes the same gradient
        p.grad = None
    m = make_train_step(loss_fn)(state, b, draws)
    assert m["grad_norm"] > 1e-2
    exp_avg = state.optimizer.adam.state[model.pose_fc.weight]["exp_avg"]
    torch.testing.assert_close(exp_avg, 0.1 * g0 * 1e-3 / m["grad_norm"], rtol=1e-4, atol=0)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A refiner (2 iterations) and a coarse grid run, 2 steps each."""
    root = tmp_path_factory.mktemp("runs")
    assert run_pose_training.main(
        ["--run-dir", str(root / "refiner"), "--epochs", "1", "--n-iterations", "2"] + TINY) == 0
    assert run_pose_training.main(
        ["--run-dir", str(root / "coarse"), "--epochs", "1", "--model-type", "coarse",
         "--coarse-hypotheses", "3"] + TINY) == 0
    return root


def test_run_directory_and_log(runs):
    """The run directory holds the port's run-directory files, the
    optimizer state, their `_last` copies and `epoch.json`; the log has
    JAX's keys and the config JAX's `backbone`, `render_size`, `bf16`."""
    r = runs / "refiner"
    for f in ("config.json", "state_dict.pt", "state_dict_last.pt", "optimizer.pt",
              "optimizer_last.pt", "epoch.json", "log.txt"):
        assert (r / f).exists(), f
    (line,) = [json.loads(x) for x in (r / "log.txt").read_text().splitlines()]
    assert set(line) == {"loss_TCO_iter1", "loss_orn_iter1", "loss_TCO_iter2", "loss_orn_iter2",
                         "loss", "grad_norm", "skipped_nonfinite", "epoch", "time"}
    assert line["skipped_nonfinite"] == 0 and np.isfinite(line["loss"])
    cfg = json.loads((r / "config.json").read_text())
    assert cfg["backbone"] == "wide_resnet18" and cfg["render_size"] == [24, 32]
    assert cfg["bf16"] is False and json.loads((r / "epoch.json").read_text()) == {"epoch": 1}
    (line,) = [json.loads(x) for x in (runs / "coarse" / "log.txt").read_text().splitlines()]
    assert {"coarse_acc", "coarse_top1_within_thresh", "loss"} <= set(line)


def test_runs_load_for_serving(runs):
    """`spec_from_checkpoints` builds a MegaPose-flavoured spec from the two
    runs and `load_named_model` loads both state dicts; the refiner moves
    poses on the CPU."""
    from happypose_tpu_torch.inference.types import ObservationBatch, PoseEstimateBatch

    dirs = {"refiner": runs / "refiner", "coarse": runs / "coarse"}
    spec = spec_from_checkpoints(dirs)
    assert spec.coarse_cfg.predict_rendered_views_logits and spec.refiner_cfg.render_size == (24, 32)
    est = load_named_model(spec, make_synth_mesh_db("debug"), n_points=64, device="cpu",
                           checkpoint_dirs=dirs)
    sd = read_state_dict(runs / "refiner")
    assert torch.equal(est.refiner_model.state_dict()["pose_fc.weight"], sd["pose_fc.weight"])
    T = torch.eye(4).repeat(2, 1, 1)
    T[:, 2, 3] = 0.4
    z = torch.zeros(2, dtype=torch.int64)
    pe = PoseEstimateBatch(poses=T, K=torch.tensor([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]]).expand(2, 3, 3),
                           obj_ids=torch.tensor([0, 1]), batch_im_ids=z, instance_ids=z,
                           hypothesis_ids=z, scores=torch.ones(2), coarse_logits=torch.ones(2),
                           pose_logits=torch.ones(2), valid=torch.ones(2, dtype=torch.bool))
    obs = ObservationBatch.from_numpy(np.zeros((48, 64, 3), np.uint8), pe.K[0].numpy(), device="cpu")
    final, _ = est.forward_refiner(obs, pe, n_iterations=1)
    assert torch.isfinite(final.poses).all() and not torch.equal(final.poses, T)


def test_resume_continues_from_epoch_json(runs, tmp_path):
    """`--resume --epochs 2` on a 1-epoch run trains epoch 1 only, from the
    saved weights, optimizer and counts."""
    r = tmp_path / "refiner"
    shutil.copytree(runs / "refiner", r)
    assert run_pose_training.main(
        ["--run-dir", str(r), "--epochs", "2", "--n-iterations", "2", "--resume"] + TINY) == 0
    lines = [json.loads(x) for x in (r / "log.txt").read_text().splitlines()]
    assert [x["epoch"] for x in lines] == [0, 1]
    assert torch.load(r / "optimizer.pt", weights_only=True)["optimizer"]["count"] == 4
    assert json.loads((r / "epoch.json").read_text()) == {"epoch": 2}


def test_truncated_state_dict_falls_back_to_the_last_copy(runs, tmp_path):
    """A truncated `state_dict.pt`: serving reads `state_dict_last.pt`,
    `load_checkpoint` takes the `_last` pair, and `--resume` goes on."""
    r = tmp_path / "refiner"
    shutil.copytree(runs / "refiner", r)
    good = read_state_dict(r)
    data = (r / "state_dict.pt").read_bytes()
    (r / "state_dict.pt").write_bytes(data[: len(data) // 2])
    back = read_state_dict(r)
    assert all(torch.equal(good[k], back[k]) for k in good)
    model = PosePredictor(PosePredictorConfig(backbone="wide_resnet18", render_size=(24, 32)))
    state, epoch = load_checkpoint(r, TrainState(model, make_optimizer(model.parameters())))
    assert epoch == 1 and state.optimizer.count == 2 and state.step == 2
    assert torch.equal(state.model.state_dict()["pose_fc.bias"], good["pose_fc.bias"])
    assert run_pose_training.main(
        ["--run-dir", str(r), "--epochs", "2", "--n-iterations", "2", "--resume"] + TINY) == 0
    assert len((r / "log.txt").read_text().splitlines()) == 2
    for f in ("state_dict.pt", "state_dict_last.pt"):
        (r / f).write_bytes(b"")
    with pytest.raises(EOFError):
        read_state_dict(r)


def test_init_from_curriculum_profile_and_bf16(runs, tmp_path):
    """`--init-from` starts from another run's weights with a fresh
    optimizer; `--add-iteration-epoch-interval 1` adds an iteration in the
    second epoch; `--profile` writes a `torch.profiler` trace of the first;
    `--bf16` records `bf16` in the config, which loads as bfloat16."""
    r = tmp_path / "warm"
    assert run_pose_training.main(
        ["--run-dir", str(r), "--epochs", "2", "--init-from", str(runs / "refiner"),
         "--add-iteration-epoch-interval", "1", "--n-iterations-max", "2", "--profile",
         "--bf16"] + TINY) == 0
    lines = [json.loads(x) for x in (r / "log.txt").read_text().splitlines()]
    assert "loss_TCO_iter2" not in lines[0] and "loss_TCO_iter2" in lines[1]
    assert torch.load(r / "optimizer.pt", weights_only=True)["optimizer"]["count"] == 4
    trace = json.loads((r / "trace" / "trace.json").read_text())
    assert any(e.get("name", "").startswith("aten::") for e in trace["traceEvents"])
    assert json.loads((r / "config.json").read_text())["bf16"] is True
    assert spec_from_checkpoints({"refiner": r}).refiner_cfg.compute_dtype == "bfloat16"


@pytest.mark.parametrize("argv, item", [
    (["--data", "/nonexistent/split"], "item 5"),
    (["--data", "synth", "--stream"], "item 5"),
    (["--data", "synth", "--dp"], "item 9"),
])
def test_paths_not_ported_raise(argv, item, tmp_path):
    """Every path is ported now. The data paths of item 5 refuse the
    arguments they cannot use (a split without `--models-dir`, `--stream`
    without a split), and nothing trains on something else. Data
    parallelism (item 9) without a launcher trains on a process group of
    one rank and destroys the group when it ends."""
    if item == "item 9":
        run_pose_training.main(["--run-dir", str(tmp_path / "r"), "--device", "cpu",
                                "--epochs", "1", "--epoch-size", "2", "--batch-size", "2",
                                "--image-size", "48", "64", "--render-size", "24", "32"] + argv)
        assert json.loads((tmp_path / "r" / "log.txt").read_text())["epoch"] == 0
        assert not torch.distributed.is_initialized()
        return
    with pytest.raises(SystemExit):
        run_pose_training.main(["--run-dir", str(tmp_path / "r"), "--device", "cpu"] + argv)
    assert not (tmp_path / "r").exists()


@pytest.mark.parametrize("init_mode", ["noise", "grid"])
def test_eval_refiner_checkpoint(runs, init_mode, tmp_path):
    """The refiner run evaluated on held-out synthetic scenes: every error
    before and after, finite; `refiner_eval.json` and `--out` written."""
    out = tmp_path / "eval.json"
    assert eval_refiner_checkpoint.main([
        "--run-dir", str(runs / "refiner"), "--n-batches", "2", "--batch-size", "2",
        "--n-iterations", "2", "--image-size", "48", "64", "--init-mode", init_mode,
        "--so3-grid", "72", "--device", "cpu", "--out", str(out)]) == 0
    summary = json.loads(out.read_text())
    assert summary == json.loads((runs / "refiner" / "refiner_eval.json").read_text())
    for k in ("t", "r", "log6", "add"):
        for tag in ("before", "after"):
            assert np.isfinite(summary[f"{k}_{tag}"]) and np.isfinite(summary[f"median_{k}_{tag}"])
    assert summary["n_samples"] == 4 and summary["init_mode"] == init_mode
    with pytest.raises(SystemExit):  # a split needs its models
        eval_refiner_checkpoint.main(["--run-dir", str(runs / "refiner"), "--split-dir", "x",
                                      "--device", "cpu"])


def test_eval_coarse_checkpoint(runs, tmp_path):
    """The coarse run scores the 72-rotation grid for every object of a
    2-frame BOP split written here: recall and ranks in the summary."""
    from happypose_tpu_torch.datasets.bop import SceneObservation, write_bop_models, write_bop_scene
    from happypose_tpu_torch.meshes.database import MeshDataBase
    from happypose_tpu_torch.ops.rasterizer_fused import render_batch_fused

    synth = make_synth_mesh_db("debug")
    db = MeshDataBase({"obj_000001": synth.meshes["box"], "obj_000002": synth.meshes["sphere"]})
    write_bop_models(tmp_path / "models", db)
    K = torch.tensor([[120.0, 0, 32], [0, 120.0, 24], [0, 0, 1]])
    d = sample_synth_scenes(torch.Generator().manual_seed(4), 2, 2, (48, 64), z_range=(0.5, 0.6),
                            xy_extent=0.01, force_obj_ids=torch.tensor([0, 1]))
    batch = make_synth_batch(db.render_assets(device="cpu"), K, d)
    mask = render_batch_fused(db.render_assets(device="cpu"), batch.obj_ids, batch.TCO_gt,
                              batch.K, resolution=(48, 64)).mask
    frames = []
    for i in range(2):
        ys, xs = torch.nonzero(mask[i], as_tuple=True)
        frames.append(SceneObservation(
            rgb=(batch.images[i].permute(1, 2, 0).numpy() * 255).astype(np.uint8), K=K.numpy(),
            obj_labels=[db.labels[i]], TWO=batch.TCO_gt[i:i + 1].numpy(),
            bboxes=np.asarray([[xs.min(), ys.min(), xs.max(), ys.max()]], np.float32),
            visib_fract=np.ones(1, np.float32), view_id=i))
    write_bop_scene(tmp_path / "test", 1, frames)
    out = tmp_path / "coarse.json"
    assert eval_coarse_checkpoint.main([
        "--coarse-dir", str(runs / "coarse"), "--split-dir", str(tmp_path / "test"),
        "--models-dir", str(tmp_path / "models"), "--so3-grid", "72", "--device", "cpu",
        "--out", str(out)]) == 0
    res = json.loads(out.read_text())
    s = res["summary"]
    assert s["n_detections"] == 2 and s["so3_grid"] == 72
    assert 0 <= s["top1_recall"] <= s["top5_recall"] <= 1
    assert all(0 <= r["rank_of_best"] < 72 for r in res["per_detection"])


def test_plot_training_log_matches_jax(runs, tmp_path):
    """The SVG of a series is JAX's byte for byte, and `main` plots a log
    of each package (the port's run, and a log in JAX's keys)."""
    series = [("a", [(0, 1.5), (1, 0.75), (2, 0.5)]), ("b", [(0, 2.0), (2, 1.0)])]
    assert plot_training_log.render_svg(series, "loss") == jax_plot.render_svg(series, "loss")
    jax_run = tmp_path / "jax_run"
    jax_run.mkdir()
    (jax_run / "log.txt").write_text("\n".join(json.dumps(
        {"loss": 1.0 / (e + 1), "grad_norm": 3.0, "skipped_nonfinite": 0.0, "epoch": e,
         "time": 1.0}) for e in range(3)) + "\n")
    out = tmp_path / "curves.svg"
    assert plot_training_log.main(["--runs", str(runs / "refiner"), str(jax_run), "--metric",
                                   "loss", "--out", str(out)]) == 0
    svg = out.read_text()
    assert svg.startswith("<svg") and svg.count("<path") == 2 and "jax_run" in svg


def _child(tmp_path, body):
    script = tmp_path / "child.py"
    script.write_text(body)
    return [sys.executable, str(script)]


def test_supervise_kills_a_stalled_child(tmp_path):
    """A child that writes nothing to the watched file is killed after the
    stall limit; with no restart left the supervisor returns 1."""
    watch = tmp_path / "log.txt"
    cmd = _child(tmp_path, f"import time\nopen({str(watch)!r}, 'a').write('x')\ntime.sleep(60)\n")
    rc = supervise.main(["--watch", str(watch), "--stall-seconds", "1",
                         "--startup-grace-seconds", "1", "--max-restarts", "0", "--"] + cmd)
    assert rc == 1 and watch.read_text() == "x"


def test_supervise_relaunches_a_failed_child(tmp_path):
    """A child that fails once is relaunched (no stall: no device probe)
    and its second run's success ends the supervisor with 0."""
    marker = tmp_path / "tried"
    cmd = _child(tmp_path, (
        "import pathlib, sys\n"
        f"m = pathlib.Path({str(marker)!r})\n"
        "if not m.exists():\n    m.write_text('1')\n    sys.exit(3)\n"))
    rc = supervise.main(["--watch", str(tmp_path / "log.txt"), "--stall-seconds", "30",
                         "--max-restarts", "1", "--"] + cmd)
    assert rc == 0 and marker.exists()


def test_supervise_needs_a_command(tmp_path):
    with pytest.raises(SystemExit):
        supervise.main(["--watch", str(tmp_path / "log.txt")])
