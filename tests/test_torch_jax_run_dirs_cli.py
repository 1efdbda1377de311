"""The port's CLIs on run directories the JAX package's CLIs wrote.

JAX's `run_pose_training` trains a refiner and a coarse grid model on the
CPU at the JAX package's small recipe sizes cut further (48x64 images,
24x32 renders, 2 steps); the port then serves them with `run_eval --model
from-checkpoints`, evaluates them with `eval_refiner_checkpoint` and
`eval_coarse_checkpoint`, and goes on training with `run_pose_training
--resume` (Adam's state and the counts carried over) or `--init-from`, all
with `--device cpu`. Outputs are checked to be finite and the weights the
port runs to be the file's, bit for bit.
"""

import json
import shutil

import numpy as np
import pytest
import torch
from flax import serialization

from happypose_tpu.scripts import run_pose_training as jax_run_pose_training
from happypose_tpu_torch.scripts import (
    eval_coarse_checkpoint, eval_refiner_checkpoint, run_eval, run_pose_training,
)
from happypose_tpu_torch.utils.load_model import read_state_dict
from happypose_tpu_torch.utils.weights_from_jax import pose_predictor_state_dict

torch.set_num_threads(2)
TINY = ["--data", "synth", "--epoch-size", "4", "--batch-size", "2", "--image-size", "48", "64",
        "--render-size", "24", "32", "--save-every", "1"]


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """A refiner (2 iterations) and a coarse grid run of JAX's CLI, 2 steps
    each, and a 2-frame BOP split of the debug meshes."""
    root = tmp_path_factory.mktemp("jax_runs")
    assert jax_run_pose_training.main(
        ["--run-dir", str(root / "refiner"), "--epochs", "1", "--n-iterations", "2"] + TINY) == 0
    assert jax_run_pose_training.main(
        ["--run-dir", str(root / "coarse"), "--epochs", "1", "--model-type", "coarse",
         "--coarse-hypotheses", "3"] + TINY) == 0
    _write_split(root / "bop")
    return root


def _write_split(out):
    from happypose_tpu_torch.datasets.bop import SceneObservation, write_bop_models, write_bop_scene
    from happypose_tpu_torch.meshes.database import MeshDataBase
    from happypose_tpu_torch.ops.rasterizer_fused import render_batch_fused
    from happypose_tpu_torch.training.synth_data import (
        make_synth_batch, make_synth_mesh_db, sample_synth_scenes,
    )

    synth = make_synth_mesh_db("debug")
    db = MeshDataBase({"obj_000001": synth.meshes["box"], "obj_000002": synth.meshes["sphere"]})
    write_bop_models(out / "models", db)
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
    write_bop_scene(out / "test", 1, frames)


def test_jax_run_directory_is_read_as_written(jax_runs):
    """JAX's run directory holds its files only (no `state_dict.pt`); the
    port reads its weights as the bridge gives them from Flax's own
    decoding, and its config's `backbone` and `render_size`."""
    for role in ("refiner", "coarse"):
        r = jax_runs / role
        assert {p.name for p in r.iterdir()} >= {"checkpoint.msgpack", "checkpoint_last.msgpack",
                                                  "config.json", "epoch.json", "log.txt"}
        assert not (r / "state_dict.pt").exists()
        cfg = json.loads((r / "config.json").read_text())
        assert cfg["backbone"] == "wide_resnet18" and cfg["render_size"] == [24, 32]
        ref = pose_predictor_state_dict(
            serialization.msgpack_restore((r / "checkpoint.msgpack").read_bytes()))
        got = read_state_dict(r)
        assert sorted(got) == sorted(ref) and all(torch.equal(got[k], ref[k]) for k in ref)


def test_run_eval_serves_jax_checkpoints(jax_runs, tmp_path):
    """`run_eval --model from-checkpoints --checkpoints` on JAX's two runs:
    a MegaPose-flavoured pipeline, one finite pose a ground-truth object."""
    out = run_eval.run([
        "--split-dir", str(jax_runs / "bop" / "test"), "--models-dir",
        str(jax_runs / "bop" / "models"), "--model", "from-checkpoints", "--checkpoints",
        str(jax_runs), "--so3-grid", "72", "--n-pose-hypotheses", "2",
        "--n-refiner-iterations", "1", "--out-dir", str(tmp_path), "--device", "cpu"])
    poses = np.concatenate([r["poses"] for r in out["predictions"]])
    assert poses.shape == (2, 4, 4) and np.isfinite(poses).all()
    assert out["summary"]["n_matched"] == 2 and (tmp_path / "preds_rank0.csv").exists()


def test_eval_checkpoints_on_jax_runs(jax_runs, tmp_path):
    """`eval_refiner_checkpoint --run-dir` and `eval_coarse_checkpoint
    --coarse-dir` on JAX's runs: finite errors before and after, recall
    in [0, 1]."""
    r = tmp_path / "refiner"
    shutil.copytree(jax_runs / "refiner", r)
    out = tmp_path / "eval.json"
    assert eval_refiner_checkpoint.main([
        "--run-dir", str(r), "--n-batches", "1", "--batch-size", "2", "--n-iterations", "2",
        "--image-size", "48", "64", "--device", "cpu", "--out", str(out)]) == 0
    summary = json.loads(out.read_text())
    assert summary["n_samples"] == 2
    assert all(np.isfinite(summary[f"{k}_{tag}"]) for k in ("t", "r", "log6", "add")
               for tag in ("before", "after"))
    out = tmp_path / "coarse.json"
    assert eval_coarse_checkpoint.main([
        "--coarse-dir", str(jax_runs / "coarse"), "--split-dir", str(jax_runs / "bop" / "test"),
        "--models-dir", str(jax_runs / "bop" / "models"), "--so3-grid", "72", "--device", "cpu",
        "--out", str(out)]) == 0
    assert json.loads(out.read_text())


@pytest.mark.parametrize("mode", ["--resume", "--init-from"])
def test_port_training_continues_a_jax_run(jax_runs, tmp_path, mode):
    """`--resume` on a copy of JAX's run trains epoch 1 only, from JAX's
    weights, Adam state and counts (2 applied updates, then 2 more), and
    writes the port's checkpoint beside JAX's; `--init-from` starts a new
    run from JAX's weights with a fresh optimizer."""
    r = tmp_path / "refiner"
    if mode == "--resume":
        shutil.copytree(jax_runs / "refiner", r)
        argv = ["--resume"]
    else:
        argv = ["--init-from", str(jax_runs / "refiner")]
    assert run_pose_training.main(["--run-dir", str(r), "--epochs", "2", "--n-iterations", "2",
                                   "--device", "cpu"] + argv + TINY) == 0
    lines = [json.loads(x) for x in (r / "log.txt").read_text().splitlines()]
    assert [x["epoch"] for x in lines] == [0, 1]
    assert all(np.isfinite(x["loss"]) for x in lines)
    opt = torch.load(r / "optimizer.pt", weights_only=True)
    assert opt["optimizer"]["count"] == 4 and opt["step"] == 4
    if mode == "--resume":
        assert len(lines) == 2 and (r / "checkpoint.msgpack").exists()
        assert json.loads((r / "epoch.json").read_text()) == {"epoch": 2}
