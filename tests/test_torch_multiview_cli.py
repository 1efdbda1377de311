"""The multi-view CLIs of the port against the JAX package's, on the CPU:
`run_multiview_eval` both ways (each reads the scene the other's
`--synthesize` wrote) and `run_custom_scenario` on one scenario directory.

Tolerances: summaries and fused poses within 1e-4 (float32 matching and
bundle adjustment, summed in another order; the gt + noise candidates come
from the same `RandomState(1)` in both, so they are equal); the port's
synthetic frames against JAX's: labels, poses and boxes equal, rgb within
one level on at least 99% of values (the rasterizer's plain version against
JAX's two-pass renderer on the silhouettes' edge pixels).
"""

import json
import shutil

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as ScipyRot

from happypose_tpu.evaluation.bop_export import load_bop_csv, save_bop_csv
from happypose_tpu.meshes.io import make_box_mesh, make_uv_sphere, save_ply
from happypose_tpu.scripts import run_custom_scenario as jcustom
from happypose_tpu.scripts import run_multiview_eval as jmv
from happypose_tpu_torch.datasets.bop import BOPSceneDataset
from happypose_tpu_torch.scripts import run_custom_scenario as tcustom
from happypose_tpu_torch.scripts import run_multiview_eval as tmv

torch.set_num_threads(2)


def _summary(out_dir):
    return json.loads((out_dir / "multiview_summary.json").read_text())


def _assert_summaries_agree(out, ref):
    assert sorted(out) == sorted(ref)
    assert out["n_scenes"] == ref["n_scenes"] and out["candidates"] == ref["candidates"]
    for k in out:
        if k not in ("n_scenes", "candidates"):
            np.testing.assert_allclose(out[k], ref[k], rtol=1e-4, atol=1e-4, err_msg=k)


@pytest.fixture(scope="module")
def jax_scene(tmp_path_factory):
    """JAX's `--synthesize --n-views 3`: the scene and JAX's summary of it."""
    out = tmp_path_factory.mktemp("jax_mv")
    assert jmv.main(["--out-dir", str(out), "--synthesize", "--n-views", "3"]) == 0
    return out


@pytest.fixture(scope="module")
def torch_scene(tmp_path_factory):
    """The port's `--synthesize --n-views 3 --device cpu`."""
    out = tmp_path_factory.mktemp("torch_mv")
    assert tmv.main(["--out-dir", str(out), "--synthesize", "--n-views", "3",
                     "--device", "cpu"]) == 0
    return out


@pytest.mark.parametrize("solver", ["dense", "schur"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_multiview_eval_reads_the_other_packages_scene(writer, solver, jax_scene, torch_scene,
                                                       tmp_path):
    scene = jax_scene if writer == "jax" else torch_scene
    common = ["--models-dir", str(scene / "models"), "--scenes-dir", str(scene / "scenes"),
              "--ba-solver", solver]
    assert jmv.main(["--out-dir", str(tmp_path / "j")] + common) == 0
    assert tmv.main(["--out-dir", str(tmp_path / "t"), "--device", "cpu"] + common) == 0
    out, ref = _summary(tmp_path / "t"), _summary(tmp_path / "j")
    _assert_summaries_agree(out, ref)
    assert out["n_scenes"] == 1 and out["candidates"] == "gt+noise"
    if solver == "dense":  # the synthesizing call ran the dense solver too
        _assert_summaries_agree(out, _summary(scene))


def test_synthesized_frames_equal_jax(jax_scene, torch_scene):
    for name in ("scene_gt.json", "scene_gt_info.json", "scene_camera.json"):
        out = json.loads((torch_scene / "scenes" / "000000" / name).read_text())
        ref = json.loads((jax_scene / "scenes" / "000000" / name).read_text())
        assert sorted(out) == sorted(ref) == ["0", "1", "2"], name
        for view in out:
            for o, r in zip(out[view] if isinstance(out[view], list) else [out[view]],
                            ref[view] if isinstance(ref[view], list) else [ref[view]]):
                assert sorted(o) == sorted(r)
                for k in o:
                    np.testing.assert_allclose(o[k], r[k], rtol=0, atol=1e-4, err_msg=f"{name} {k}")
    frames_t, frames_j = (BOPSceneDataset(d / "scenes") for d in (torch_scene, jax_scene))
    for i in range(len(frames_j)):
        ft, fj = frames_t[i], frames_j[i]
        assert ft.obj_labels == fj.obj_labels
        np.testing.assert_array_equal(ft.bboxes, fj.bboxes)
        diff = np.abs(ft.rgb.astype(int) - fj.rgb.astype(int))
        assert (diff <= 1).mean() >= 0.99, (diff <= 1).mean()
    for f in sorted((jax_scene / "models").iterdir()):
        assert (torch_scene / "models" / f.name).read_bytes() == f.read_bytes(), f.name


# -------------------- run_custom_scenario --------------------


@pytest.fixture(scope="module")
def scenario(tmp_path_factory):
    """`tests/test_custom_scenario.py`'s scenario (3 views with sparse ids, 3
    objects, gt + noise, one low-score outlier), with the sphere declared
    symmetric about z in `models_info.json`."""
    root = tmp_path_factory.mktemp("scenario")
    models = root / "models"
    models.mkdir()
    save_ply(models / "obj_000001.ply", make_uv_sphere(40.0, 10, 12))
    save_ply(models / "obj_000002.ply", make_box_mesh((40.0, 30.0, 50.0)))
    save_ply(models / "obj_000003.ply", make_box_mesh((50.0, 50.0, 20.0)))
    (models / "models_info.json").write_text(json.dumps({
        "1": {"diameter": 80.0, "symmetries_continuous": [{"axis": [0, 0, 1],
                                                           "offset": [0, 0, 0]}]},
        "2": {"diameter": 70.7},
        "3": {"diameter": 73.5},
    }))
    rng = np.random.RandomState(0)
    n_views, n_objects = 3, 3
    TWO = np.tile(np.eye(4), (n_objects, 1, 1))
    TWO[:, :3, :3] = ScipyRot.random(n_objects, random_state=1).as_matrix()
    TWO[:, :3, 3] = rng.uniform(-0.1, 0.1, (n_objects, 3))
    TWC = np.tile(np.eye(4), (n_views, 1, 1))
    for v in range(n_views):
        TWC[v, :3, :3] = ScipyRot.from_euler("y", 0.15 * (v - 1)).as_matrix()
        TWC[v, :3, 3] = [0.1 * (v - 1), 0.0, -0.6]
    K = np.eye(3)
    K[0, 0] = K[1, 1] = 400.0
    K[0, 2], K[1, 2] = 160.0, 120.0
    poses, objs, views, scores = [], [], [], []
    for v in range(n_views):
        for o in range(n_objects):
            noise = np.eye(4)
            noise[:3, :3] = ScipyRot.from_rotvec(rng.normal(0, 0.01, 3)).as_matrix()
            noise[:3, 3] = rng.normal(0, 0.002, 3)
            poses.append(np.linalg.inv(TWC[v]) @ TWO[o] @ noise)
            objs.append(o + 1)
            views.append(v * 10)
            scores.append(0.9)
    T_bad = np.eye(4)
    T_bad[:3, 3] = [0.5, 0.5, 2.0]
    poses.append(T_bad)
    objs.append(1)
    views.append(0)
    scores.append(0.1)
    save_bop_csv(root / "candidates.csv", np.asarray(poses), np.asarray(objs),
                 np.full(len(poses), 7), np.asarray(views), np.asarray(scores))
    (root / "scene_camera.json").write_text(json.dumps(
        {str(v * 10): {"cam_K": K.reshape(-1).tolist()} for v in range(n_views)}))
    return root


@pytest.mark.parametrize("solver", ["dense", "schur"])
def test_custom_scenario_matches_jax(solver, scenario, tmp_path):
    argv = ["--ransac-n-iter", "20", "--n-symmetries-rot", "8", "--ba-solver", solver]
    dirs = {}
    for name, main, extra in (("jax", jcustom.main, []),
                              ("torch", tcustom.main, ["--device", "cpu"])):
        dirs[name] = shutil.copytree(scenario, tmp_path / name)
        assert main(["--scenario", str(dirs[name])] + argv + extra) == 0
    out, ref = (json.loads((dirs[n] / "results" / "scene.json").read_text())
                for n in ("torch", "jax"))
    assert [o["label"] for o in out["objects"]] == [o["label"] for o in ref["objects"]]
    assert len(out["objects"]) == 3
    for o, r in zip(out["objects"], ref["objects"]):
        assert o["score"] == r["score"]
        np.testing.assert_allclose(o["TWO"], r["TWO"], atol=1e-4, rtol=0)
    assert [c["view_id"] for c in out["cameras"]] == [c["view_id"] for c in ref["cameras"]]
    for c, r in zip(out["cameras"], ref["cameras"]):
        np.testing.assert_allclose(c["TWC"], r["TWC"], atol=1e-4, rtol=0)
    out, ref = (load_bop_csv(dirs[n] / "results" / "poses.csv") for n in ("torch", "jax"))
    assert len(out["poses"]) == len(ref["poses"]) == 9
    for k in ("obj_ids", "scene_ids", "view_ids", "scores"):
        np.testing.assert_array_equal(out[k], ref[k])
    np.testing.assert_allclose(out["poses"], ref["poses"], atol=1e-4, rtol=0)
