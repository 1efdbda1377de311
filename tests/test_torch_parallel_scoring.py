"""Sharded coarse scoring: `PoseEstimator(device_mesh=...)` on 1 and 2
spawned gloo ranks against JAX's serial `forward_coarse` and the port's
serial path (see `tests/test_torch_parallel.py` for the spawning and why
this module imports no JAX at module level).

The world is the coarse half of `tests/test_torch_pipeline.py`'s:
megapose-RGB cut to 64x128 renders and the 72-rotation grid, perturbed
Flax weights carried over, a synthetic 120x160 frame with 2 detections,
chunks of 32 hypotheses. The icosphere is coloured by position: a
uniformly coloured sphere renders alike from many grid rotations, and its
logits tie. The JAX side renders with its two-pass `render_batch`
(`renderer="reference"`), whose logits lie within 1e-6 of the Pallas
interpreter's here.

Tolerances: the logits against JAX's `LOGIT_TOL` as
`tests/test_torch_pipeline.py` (measured 2e-6 there), against the port's
serial path 1e-5 (a rank's block is cut into other chunks, which reach
other convolution kernels); the top-K sets exactly, once the gap at the
K-th logit exceeds twice the tolerance.
"""

import dataclasses

import numpy as np
import pytest

from happypose_tpu_torch.inference.pose_estimator import PoseEstimator
from happypose_tpu_torch.inference.types import DetectionBatch, ObservationBatch
from happypose_tpu_torch.models.pose_predictor import PosePredictor
from happypose_tpu_torch.parallel import make_mesh
from test_torch_parallel import WORLDS, spawn

LOGIT_TOL = 2e-5
N_HYP = 5
GRID = 72


def _rank_body(rank, world, sc):
    mesh = make_mesh((world,), ("hp",), device_type="cpu")
    model = PosePredictor(sc["model_cfg"])
    model.load_state_dict(sc["state_dict"])
    est = PoseEstimator(refiner=None, coarse=model.eval(),
                        assets=sc["db"].render_assets(device="cpu"),
                        meshes=sc["db"].batched(n_points=200, device="cpu"), cfg=sc["cfg"],
                        device_mesh=mesh, mesh_axis="hp")
    res = est.forward_coarse(ObservationBatch.from_numpy(sc["rgb"], sc["K"], device="cpu"),
                             DetectionBatch.from_numpy(sc["boxes"], sc["obj_ids"], device="cpu"))
    return {"coarse_logits": res.coarse_logits.numpy(), "poses": res.poses.numpy()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from happypose_tpu.inference.types import DetectionBatch as JaxDetections
    from happypose_tpu.inference.types import ObservationBatch as JaxObservation
    from happypose_tpu.meshes.database import MeshDataBase as JaxMeshDataBase
    from happypose_tpu.meshes.io import Mesh as JaxMesh, make_box_mesh as jax_box
    from happypose_tpu.utils import load_model as jax_load_model
    from happypose_tpu_torch.meshes.database import MeshDataBase
    from happypose_tpu_torch.meshes.io import Mesh, make_box_mesh
    from happypose_tpu_torch.utils import load_model as torch_load_model
    from happypose_tpu_torch.utils.weights_from_jax import pose_predictor_state_dict
    from test_torch_models import icosphere, perturb
    from test_torch_pipeline import _frame, _small

    v, f, _ = icosphere()
    c = (0.5 + v / 0.1).astype(np.float32)
    jdb = JaxMeshDataBase({"sphere": JaxMesh(vertices=v, faces=f, vertex_colors=c),
                           "box": jax_box((0.04, 0.03, 0.05))})
    tdb = MeshDataBase({"sphere": Mesh(vertices=v, faces=f, vertex_colors=c),
                        "box": make_box_mesh((0.04, 0.03, 0.05))})
    rgb, K, boxes, obj_ids = _frame(tdb)

    def small(spec, **kw):
        spec = _small(spec, **kw)
        return dataclasses.replace(spec, inference_cfg=dataclasses.replace(
            spec.inference_cfg, bsz_images=32, n_pose_hypotheses=N_HYP))

    with pytest.MonkeyPatch.context() as m:
        m.setitem(jax_load_model.NAMED_MODELS, "megapose-RGB-test",
                  small(jax_load_model.NAMED_MODELS["megapose-RGB"], renderer="reference"))
        m.setitem(torch_load_model.NAMED_MODELS, "megapose-RGB-test",
                  small(torch_load_model.NAMED_MODELS["megapose-RGB"]))
        jax_est = jax_load_model.load_named_model("megapose-RGB-test", jdb, n_points=200)
        coarse_vars = perturb(jax_est.coarse_vars, seed=12)
        jax_est.coarse_vars = jax.tree.map(jnp.asarray, coarse_vars)
        jax_res = jax_est.forward_coarse(JaxObservation.from_numpy(rgb, K),
                                         JaxDetections.from_numpy(boxes, obj_ids))
        state_dict = pose_predictor_state_dict(coarse_vars)
        est = torch_load_model.load_named_model(
            "megapose-RGB-test", tdb, n_points=200,
            state_dicts={"refiner": pose_predictor_state_dict(perturb(jax_est.refiner_vars, 11)),
                         "coarse": state_dict}, device="cpu")
    serial = est.forward_coarse(ObservationBatch.from_numpy(rgb, K, device="cpu"),
                                DetectionBatch.from_numpy(boxes, obj_ids, device="cpu"))
    assert est.cfg.bsz_images == 32 and est.SO3_grid.shape[0] == GRID
    inputs = dict(model_cfg=est.coarse_model.cfg, state_dict=state_dict, cfg=est.cfg, db=tdb,
                  rgb=rgb, K=K, boxes=boxes, obj_ids=obj_ids)
    ranks = {w: spawn(_rank_body, w, str(tmp_path_factory.mktemp(f"world{w}")), inputs)
             for w in WORLDS}
    return dict(ranks=ranks, jax=jax.tree.map(np.asarray, jax_res),
                serial=serial.coarse_logits.numpy(), serial_poses=serial.poses.numpy())


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_coarse_scoring_matches_jax_serial(runs, world):
    """The 2 x 72 hypotheses split over the ranks (each scores its block in
    chunks of 32; 144 divides by both worlds, so no padding): on every rank
    the logits are JAX's serial `forward_coarse`'s to `LOGIT_TOL` and the
    port's serial path's to 1e-5, the hypothesis poses are the serial
    path's, and the top-5 sets of each detection are JAX's."""
    jl = runs["jax"].coarse_logits
    for r in runs["ranks"][world]:
        got = r["coarse_logits"]
        assert got.shape == jl.shape == (2 * GRID,)
        np.testing.assert_allclose(got, jl, atol=LOGIT_TOL, rtol=LOGIT_TOL)
        np.testing.assert_allclose(got, runs["serial"], atol=1e-5, rtol=1e-5)
        np.testing.assert_array_equal(r["poses"], runs["serial_poses"])
        for d in range(2):
            row_j, row = jl[d * GRID:(d + 1) * GRID], got[d * GRID:(d + 1) * GRID]
            top = np.sort(row_j)[::-1]
            assert top[N_HYP - 1] - top[N_HYP] > 2 * LOGIT_TOL
            assert set(np.argsort(-row)[:N_HYP]) == set(np.argsort(-row_j)[:N_HYP])


def test_padding_is_cut_off(tmp_path):
    """A hypothesis count that does not divide by the ranks (3 over 2) is
    padded with copies of the last hypothesis and the padded logits cut
    off: `sharded_batch_apply` sees 4 rows, the caller gets 3."""
    ranks = spawn(_pad_body, 2, str(tmp_path), None)
    for r in ranks:
        assert r["seen"] == [2, 2]
        np.testing.assert_array_equal(r["out"], [0.0, 1.0, 2.0])


def _pad_body(rank, world, _):
    import torch

    mesh = make_mesh((world,), ("hp",), device_type="cpu")
    seen = []

    class Model:
        cfg = dataclasses.make_dataclass("Cfg", [("input_depth", bool, False)])()

        def __call__(self, images, K, obj_ids, TCO, assets, meshes, n_iterations):
            seen.append(len(TCO))
            logits = TCO[:, 0, 3].reshape(1, -1, 1)
            return type("Out", (), {"renderings_logits": logits})()

    class Meshes:
        def select(self, ids):
            return None

    est = PoseEstimator.__new__(PoseEstimator)
    est.coarse_model, est.meshes, est.assets = Model(), Meshes(), None
    est.cfg = dataclasses.make_dataclass("C", [("bsz_images", int, 8)])()
    est.device_mesh, est.mesh_axis = mesh, "hp"
    TCO = torch.eye(4).repeat(3, 1, 1)
    TCO[:, 0, 3] = torch.arange(3.0)
    obs = type("Obs", (), {"rgb": torch.zeros(1, 3, 4, 4)})()
    out = est._score_hypotheses(obs, torch.eye(3).repeat(3, 1, 1), torch.zeros(3, dtype=torch.long),
                                torch.zeros(3, dtype=torch.long), TCO)
    gathered = [None] * world
    import torch.distributed as dist

    dist.all_gather_object(gathered, seen)
    return {"seen": [n for s in gathered for n in s], "out": out.numpy()}
