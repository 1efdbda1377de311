"""`run_accuracy_demo`, the PyTorch port against the JAX package's CLI.

The port's demo draws its scenes with `torch.Generator` where the JAX CLI
draws with `jax.random`, so the two CLIs run here on the same scenes: the
port's `scene_batch` hands it the batches JAX's CLI drew (with its two-pass
reference renderer, as it runs on the CPU), and both read run directories
of the same seeded FlowNetS weights (JAX's msgpack loader is replaced by
the seeded variables; the port's run directories are written from them).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from happypose_tpu.inference import pose_estimator as jax_pose_estimator
from happypose_tpu.scripts import run_accuracy_demo as jdemo
from happypose_tpu.training import synth_data as jax_synth
from happypose_tpu_torch.meshes import io as tio
from happypose_tpu_torch.scripts import run_accuracy_demo as tdemo
from happypose_tpu_torch.training.forward_loss import PoseTrainingBatch
from happypose_tpu_torch.utils.load_model import save_run_dir
from happypose_tpu_torch.utils.weights_from_jax import pose_predictor_state_dict
from test_torch_backbones import seeded_variables
from test_torch_models import icosphere

torch.set_num_threads(2)


# ----------------------------------------------------------- run_accuracy_demo

DEMO = ["--image-size", "64", "96", "--batch-size", "3", "--n-scenes", "6", "--so3-grid", "72",
        "--n-hypotheses", "2", "--n-refiner-iterations", "2", "--synth-set", "mesh_only"]
DEMO_RENDER = [32, 48]
# Medians and poses to 1e-5 (m, and rad for rotations; the summary's
# rotation median is in degrees, so 1e-5 rad = 5.7e-4 degrees).
POSE_TOL = 1e-5


@pytest.fixture(scope="module")
def demo_meshes(tmp_path_factory):
    """A position-coloured icosphere (no pole slivers, no two grid rotations
    render alike) and a box, as PLY files both packages load."""
    root = tmp_path_factory.mktemp("demo_meshes")
    v, f, _ = icosphere(0.04, 2)
    tio.save_ply(root / "ico.ply", tio.position_colored(tio.Mesh(vertices=v, faces=f)))
    tio.save_ply(root / "box.ply", tio.position_colored(tio.make_box_mesh((0.035, 0.025, 0.045))))
    return [str(root / "ico.ply"), str(root / "box.ply")]


def _run_both(tmp_path, meshes, coarse: bool, extra=()):
    """JAX's CLI, then the port's on JAX's scenes and weights. Returns both
    summaries and, per batch, JAX's final estimates and the port's
    `evaluate_batch` outputs."""
    runs = {"refiner": tmp_path / "refiner"}
    if coarse:
        runs["coarse"] = tmp_path / "coarse"
    for run in runs.values():
        run.mkdir()
        (run / "config.json").write_text(json.dumps({"backbone": "flownet",
                                                     "render_size": DEMO_RENDER}))
    argv = (DEMO + ["--mesh-files", *meshes, "--refiner-dir", str(runs["refiner"])]
            + (["--coarse-dir", str(runs["coarse"])] if coarse else []) + list(extra))
    weights, batches, jax_finals, port_outs = {}, [], [], []

    def load_variables(run_dir, template):  # seeded FlowNetS weights (He's gain)
        shapes = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), template)
        weights[run_dir] = seeded_variables(shapes, seed=len(weights) + 31, gain=np.sqrt(2.0))
        return jax.tree.map(jnp.asarray, weights[run_dir])

    make_batch, run_pipeline = jax_synth.make_synth_batch, \
        jax_pose_estimator.PoseEstimator.run_inference_pipeline

    def recorded_batch(*a, **k):
        b = make_batch(*a, **k)
        if k["batch_size"] == 3:  # not the 2-image batch of the model's template
            batches.append({f: np.asarray(getattr(b, f)) for f in b._fields})
        return b

    def recorded_pipeline(self, *a, **k):
        res = run_pipeline(self, *a, **k)
        jax_finals.append(jax.tree.map(np.asarray, res["final"]))
        return res

    evaluate = tdemo.evaluate_batch
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdemo, "_load_variables", load_variables)
        mp.setattr(jax_synth, "make_synth_batch", recorded_batch)
        mp.setattr(jax_pose_estimator.PoseEstimator, "run_inference_pipeline", recorded_pipeline)
        assert jdemo.main(argv + ["--out", str(tmp_path / "jax.json")]) == 0
    for run_dir, variables in weights.items():
        save_run_dir(run_dir, pose_predictor_state_dict(variables),
                     json.loads((run_dir / "config.json").read_text()))
    handed = iter(batches)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdemo, "scene_batch", lambda *a, **k: PoseTrainingBatch(**{
            f: torch.from_numpy(np.array(v, np.int64 if f == "obj_ids" else np.float32))
            for f, v in next(handed).items()}))
        mp.setattr(tdemo, "evaluate_batch",
                   lambda *a, **k: port_outs.append(evaluate(*a, **k)) or port_outs[-1])
        assert tdemo.main(argv + ["--out", str(tmp_path / "port.json"), "--device", "cpu"]) == 0
    summaries = [json.loads((tmp_path / f"{n}.json").read_text()) for n in ("jax", "port")]
    return summaries, batches, jax_finals, port_outs


@pytest.mark.parametrize("coarse", [True, False], ids=["megapose", "cosypose"])
def test_accuracy_demo_matches_jax_on_its_scenes(tmp_path, demo_meshes, coarse):
    """Both CLIs, with a FlowNetS refiner and (MegaPose flavour) a FlowNetS
    coarse classifier cut to 32x48 renders, a 72-rotation grid, top-2 and
    2 refiner iterations, on 2 batches of 3 scenes of JAX's drawing (the
    CosyPose flavour with `--only-labels mesh0`: every scene the
    icosphere, forced by both from `RandomState(seed + b)`): the summary's
    keys equal JAX's, its counts and settings equal, its medians and means
    within POSE_TOL; each batch's final poses within POSE_TOL of JAX's."""
    extra = () if coarse else ("--only-labels", "mesh0")
    (ref, ours), batches, jax_finals, port_outs = _run_both(tmp_path, demo_meshes, coarse, extra)
    assert len(batches) == len(jax_finals) == len(port_outs) == 2
    if not coarse:
        assert all((b["obj_ids"] == 0).all() for b in batches)
    assert list(ours) == list(ref)
    for k in ("n_scenes", "tolerance", "frac_within_tolerance", "so3_grid", "n_hypotheses",
              "n_refiner_iterations", "coarse"):
        assert ours[k] == ref[k], k
    assert ref["n_scenes"] == 6 and ref["coarse"] == coarse
    for k in ("log6_median", "log6_mean", "trans_m_median", "add_m_median"):
        assert abs(ours[k] - ref[k]) < POSE_TOL, (k, ours[k], ref[k])
    assert abs(ours["rot_deg_median"] - ref["rot_deg_median"]) < np.degrees(POSE_TOL)
    for final, out in zip(jax_finals, port_outs):
        keep = final.valid
        np.testing.assert_array_equal(out["batch_im_ids"], final.batch_im_ids[keep])
        T, T_ref = out["poses"], final.poses[keep]
        assert np.isfinite(T).all() and len(T) == 3
        assert np.abs(T[:, :3, 3] - T_ref[:, :3, 3]).max() < POSE_TOL
        dR = np.linalg.norm((T[:, :3, :3] - T_ref[:, :3, :3]).astype(np.float64), axis=(1, 2))
        assert (2 * np.arcsin(np.clip(dR / (2 * np.sqrt(2)), 0, 1))).max() < POSE_TOL
