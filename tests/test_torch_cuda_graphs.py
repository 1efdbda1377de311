"""The compiled serving entry points as CUDA graphs (`utils/cuda_graphs.py`):
`run_inference_pipeline_jit`, `forward_coarse_jit`, the stage programs and
the detector's forward, against the port's eager paths and JAX's jitted
ones.

On the CPU a graphed call takes the graph's path with a plain call in place
of the replay (static input buffers, a cache entry per key, outputs cloned
out), so these tests hold the keys, the copies and the clones; the results
must equal the eager paths exactly. Both packages load `megapose-RGB` and
`cosypose-RGB` cut to JAX's own fixture sizes (WideResNet18, 48x64 renders,
an SO(3) grid of 8, `bsz_images` 8, `bsz_objects` 2, one refiner
iteration, top-2) with the same perturbed weights, on the same seeded frame
of two boxes (`test_torch_depth._rgbd_frame`, 32x48, whose 1536 depth
pixels the depth refiners sample in full, so that the two libraries'
random subsamples are the same set). JAX renders with its two-pass
renderer. The card's test is `test_torch_cuda_graphs_card.py`.
"""

import dataclasses
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import happypose_tpu.inference.icp_refiner as jicp
import happypose_tpu_torch.inference.icp_refiner as ticp
from happypose_tpu.inference.types import DetectionBatch as JaxDetections
from happypose_tpu.inference.types import ObservationBatch as JaxObservation
from happypose_tpu.ops.rasterizer import render_batch as jax_render_batch
from happypose_tpu.utils import load_model as jax_load_model
from happypose_tpu_torch.inference import pose_estimator as tpe
from happypose_tpu_torch.inference.detector import Detector
from happypose_tpu_torch.inference.teaser_refiner import _kabsch
from happypose_tpu_torch.inference.types import DetectionBatch, ObservationBatch
from happypose_tpu_torch.models.detector import DetectorConfig, FCOSDetector
from happypose_tpu_torch.ops import rasterizer_fused as rf
from happypose_tpu_torch.utils import load_model as torch_load_model
from happypose_tpu_torch.utils import profiling
from happypose_tpu_torch.utils.cuda_graphs import GraphCache, device_constant
from happypose_tpu_torch.utils.weights_from_jax import pose_predictor_state_dict
from test_torch_depth import FRAME, _rgbd_frame
from test_torch_models import mesh_dbs, perturb

torch.set_num_threads(2)

RENDER = (48, 64)
# JAX's own tolerance of its jit against its eager pipeline
# (tests/test_pose_estimator.py). Measured on the CPU: 6e-8 in the RGB
# stages, 1.9e-6 after ICP (JAX renders the depth refiner's view with its
# two-pass renderer, the port with the fused one)
POSE_TOL = 1e-5
# `_kabsch` against Kabsch through `torch.linalg.svd`, rotation entries:
# float32 covariances, both float32 results of a float64 solve
KABSCH_TOL = 1e-5
FLAVOURS = ("megapose-RGB", "cosypose-RGB", "megapose-RGB+icp")


def _small(spec, depth_refiner=None, **renderer):
    def cfg(c):
        return c and dataclasses.replace(c, backbone="wide_resnet18", render_size=RENDER,
                                         **renderer)

    return dataclasses.replace(
        spec, refiner_cfg=cfg(spec.refiner_cfg), coarse_cfg=cfg(spec.coarse_cfg),
        inference_cfg=dataclasses.replace(
            spec.inference_cfg, SO3_grid_size=8, bsz_images=8, bsz_objects=2,
            n_refiner_iterations=1, n_pose_hypotheses=2,
            run_depth_refiner=depth_refiner is not None, depth_refiner=depth_refiner),
    )


def _estimators(flavour, jdb, tdb):
    """Both packages' cut estimators of `flavour` with the same perturbed
    weights; the depth refiners sample every pixel of the frame."""
    name, _, depth_refiner = flavour.partition("+")
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_load_model.NAMED_MODELS, "graph-test",
                   _small(jax_load_model.NAMED_MODELS[name], depth_refiner or None,
                          renderer="reference"))
        mp.setitem(torch_load_model.NAMED_MODELS, "graph-test",
                   _small(torch_load_model.NAMED_MODELS[name], depth_refiner or None))
        jax_est = jax_load_model.load_named_model("graph-test", jdb, n_points=200)
        refiner_vars = perturb(jax_est.refiner_vars, seed=31)
        head = refiner_vars["params"]["pose_fc"]
        identity = np.asarray(jax_est.refiner_vars["params"]["pose_fc"]["bias"])
        head["kernel"] *= 0.05  # small updates: the depth refiners start near the surface
        head["bias"] = identity + 0.05 * (head["bias"] - identity)
        coarse_vars = perturb(jax_est.coarse_vars, seed=32)
        jax_est.refiner_vars = jax.tree.map(jnp.asarray, refiner_vars)
        jax_est.coarse_vars = jax.tree.map(jnp.asarray, coarse_vars)
        est = torch_load_model.load_named_model(
            "graph-test", tdb, n_points=200, device="cpu",
            state_dicts={"refiner": pose_predictor_state_dict(refiner_vars),
                         "coarse": pose_predictor_state_dict(coarse_vars)})
    n_px = FRAME[0] * FRAME[1]
    jax_est._depth_refiners[(jicp.ICPRefiner, jax_render_batch, FRAME)] = jicp.ICPRefiner(
        jax_est.assets, jax_render_batch, resolution=FRAME, n_points=n_px)
    est._depth_refiners[(ticp.ICPRefiner, FRAME)] = ticp.ICPRefiner(
        est.assets, rf.render_batch_fused, resolution=FRAME, n_points=n_px)
    return jax_est, est


def _numpy(results):
    return {k: {f.name: np.asarray(getattr(v, f.name)) for f in dataclasses.fields(v)}
            for k, v in results.items()}


@pytest.fixture(scope="module")
def world():
    jdb, tdb = mesh_dbs()
    rgb, depth, K, boxes, obj_ids, _ = _rgbd_frame(tdb)
    return dict(jdb=jdb, tdb=tdb, rgb=rgb, depth=depth, K=K, boxes=boxes, obj_ids=obj_ids)


def _inputs(world, flavour, n_det=2):
    depth = world["depth"] if "+" in flavour else None
    obs = ObservationBatch.from_numpy(world["rgb"], world["K"], depth=depth, device="cpu")
    det = DetectionBatch.from_numpy(world["boxes"][:n_det], world["obj_ids"][:n_det],
                                    device="cpu")
    return obs, det


@pytest.fixture(scope="module", params=FLAVOURS)
def runs(request, world):
    """Each flavour through JAX's `run_inference_pipeline_jit` and through
    the port's graphed and eager pipelines."""
    flavour = request.param
    jax_est, est = _estimators(flavour, world["jdb"], world["tdb"])
    depth = world["depth"] if "+" in flavour else None
    jax_res = jax_est.run_inference_pipeline_jit(
        JaxObservation.from_numpy(world["rgb"], world["K"], depth=depth),
        JaxDetections.from_numpy(world["boxes"], world["obj_ids"]))
    obs, det = _inputs(world, flavour)
    graphed = est.run_inference_pipeline_jit(obs, det)
    eager = est.run_inference_pipeline(obs, det)
    return dict(flavour=flavour, est=est, jax=_numpy(jax_res), graphed=_numpy(graphed),
                eager=_numpy(eager))


def test_graphed_pipeline_equals_eager(runs):
    """Every stage, every field, bit for bit."""
    g, e = runs["graphed"], runs["eager"]
    assert sorted(g) == sorted(e)
    for stage in e:
        for name, value in e[stage].items():
            np.testing.assert_array_equal(g[stage][name], value, err_msg=f"{stage}.{name}")


def test_graphed_pipeline_matches_jax_jit(runs):
    """JAX's `run_inference_pipeline_jit` on the same frame: the stages,
    the same `valid` and the poses of "coarse", "scored" and "final" to
    JAX's 1e-5 (CosyPose has no "scored")."""
    j, t = runs["jax"], runs["graphed"]
    assert sorted(t) == sorted(j)
    depth = "depth_refined" in t
    for stage in ("coarse", "scored", "final"):
        if stage not in t:
            continue
        np.testing.assert_array_equal(t[stage]["valid"], j[stage]["valid"], err_msg=stage)
        np.testing.assert_allclose(t[stage]["poses"], j[stage]["poses"], atol=POSE_TOL,
                                   rtol=0, err_msg=stage)
    if depth:  # the comparison is not of a no-op: ICP moved the poses
        moved = np.abs(t["final"]["poses"] - t["scored"]["poses"]).max()
        assert moved > 1e-4, moved


def test_cache_keys(runs, world):
    """A second call with the same shapes adds no entry; another detection
    count adds one; the first call's tensors are not touched by a later
    call on another frame."""
    est = runs["est"]
    cache = est._pipeline_jit_cache
    obs, det = _inputs(world, runs["flavour"])
    n = len(cache)
    first = est.run_inference_pipeline_jit(obs, det)
    assert len(cache) == n
    kept = {k: v.poses.clone() for k, v in first.items()}
    obs1, det1 = _inputs(world, runs["flavour"], n_det=1)
    other = est.run_inference_pipeline_jit(obs1, det1)
    assert len(cache) == n + 1
    assert other["final"].n_rows < first["final"].n_rows
    for k, v in first.items():
        torch.testing.assert_close(v.poses, kept[k], rtol=0, atol=0)
    # and the one-detection frame is the eager pipeline's
    eager = est.run_inference_pipeline(obs1, det1)
    for k in eager:
        torch.testing.assert_close(other[k].poses, eager[k].poses, rtol=0, atol=0)


def test_forward_coarse_jit_matches_jax(world):
    """The coarse stage alone: the port's graph equals its eager stage and
    JAX's `forward_coarse_jit` to 1e-5 in poses and logits (relative to the
    largest logit)."""
    jax_est, est = _estimators("megapose-RGB", world["jdb"], world["tdb"])
    ref = jax_est.forward_coarse_jit(JaxObservation.from_numpy(world["rgb"], world["K"]),
                                     JaxDetections.from_numpy(world["boxes"], world["obj_ids"]))
    obs, det = _inputs(world, "megapose-RGB")
    out = est.forward_coarse_jit(obs, det)
    eager = est.forward_coarse(obs, det)
    for f in dataclasses.fields(out):
        torch.testing.assert_close(getattr(out, f.name), getattr(eager, f.name), rtol=0, atol=0)
    np.testing.assert_allclose(out.poses.numpy(), np.asarray(ref.poses), atol=POSE_TOL, rtol=0)
    logits = np.asarray(ref.coarse_logits)
    np.testing.assert_allclose(out.coarse_logits.numpy(), logits,
                               atol=POSE_TOL * np.abs(logits).max(), rtol=0)
    assert len(est._pipeline_jit_cache) == 1


def test_stage_programs_equal_the_model(world):
    """`_coarse_logits_fn` and `_refine_fn` (a full chunk and a ragged one,
    each its own graph) equal the model's eager call."""
    _, est = _estimators("megapose-RGB", world["jdb"], world["tdb"])
    obs, det = _inputs(world, "megapose-RGB")
    coarse = est.forward_coarse(obs, det)
    for rows in (8, 5):
        sl = slice(0, rows)
        ids = coarse.obj_ids[sl]
        args = (obs.rgb[coarse.batch_im_ids[sl]], coarse.K[sl], ids, coarse.poses[sl],
                est.assets, est.meshes.select(ids))
        with torch.inference_mode():
            ref = est.coarse_model(*args, n_iterations=1).renderings_logits[0, :, 0]
            ref_tco = est.refiner_model(*args, n_iterations=2).TCO_output
        torch.testing.assert_close(tpe._coarse_logits_fn(est.coarse_model, *args), ref,
                                   rtol=0, atol=0)
        torch.testing.assert_close(tpe._refine_fn(est.refiner_model, *args, 2), ref_tco,
                                   rtol=0, atol=0)
    assert len(tpe._stage_graphs[est.coarse_model]) == 2
    assert len(tpe._stage_graphs[est.refiner_model]) == 2


@pytest.fixture(scope="module")
def megapose(world):
    """The port's cut megapose-RGB estimator (seeded weights) and the coarse
    stage's estimates on the seeded frame (16 rows)."""
    est = torch_load_model.load_named_model(_small(torch_load_model.NAMED_MODELS["megapose-RGB"]),
                                            world["tdb"], n_points=200, device="cpu")
    obs, det = _inputs(world, "megapose-RGB")
    return est, obs, est.forward_coarse(obs, det)


def _stage_counts():
    counters = profiling.counters()
    return {w: counters.get(f"graphs.stage.{w}", 0) for w in ("captures", "replays")}


@pytest.mark.parametrize("n_iterations", (1, 2))
@pytest.mark.parametrize("rows", (4, 3))
def test_forward_refiner_equals_the_model(megapose, rows, n_iterations, monkeypatch):
    """`forward_refiner` sends each chunk of `bsz_objects` (2) rows through
    the refiner's stage graph: two full chunks (4 rows) or a full and a
    ragged one (3 rows), one key a chunk shape. Every iteration equals the
    model's eager call on each chunk bit for bit, the other fields are the
    input's, and a second call is one replay a chunk and no new key."""
    est, obs, coarse = megapose
    monkeypatch.setattr(tpe, "_stage_graphs", weakref.WeakKeyDictionary())
    estimates = coarse.select(torch.arange(rows))
    final, per_iter = est.forward_refiner(obs, estimates, n_iterations)

    images = tpe._model_images(est.refiner_model, obs)
    chunks = []
    with torch.inference_mode():
        for s in range(0, rows, 2):
            sl = slice(s, s + 2)
            ids = estimates.obj_ids[sl]
            chunks.append(est.refiner_model(
                images[estimates.batch_im_ids[sl]], estimates.K[sl], ids, estimates.poses[sl],
                est.assets, est.meshes.select(ids), n_iterations=n_iterations).TCO_output)
    ref = torch.cat(chunks, dim=1)
    assert torch.isfinite(ref).all() and not torch.equal(ref[-1], estimates.poses)
    assert sorted(per_iter) == [f"iteration={k + 1}" for k in range(n_iterations)]
    assert final is per_iter[f"iteration={n_iterations}"]
    for k in range(n_iterations):
        out = per_iter[f"iteration={k + 1}"]
        torch.testing.assert_close(out.poses, ref[k], rtol=0, atol=0)
        for f in dataclasses.fields(out):
            if f.name != "poses":
                assert torch.equal(getattr(out, f.name), getattr(estimates, f.name)), f.name

    cache = tpe._stage_graphs[est.refiner_model]
    n_keys = len({min(2, rows - s) for s in range(0, rows, 2)})
    assert len(cache) == n_keys
    before = _stage_counts()
    again, _ = est.forward_refiner(obs, estimates, n_iterations)
    assert len(cache) == n_keys
    assert _stage_counts() == {"captures": before["captures"], "replays": before["replays"] + 2}
    torch.testing.assert_close(again.poses, final.poses, rtol=0, atol=0)


def test_a_frame_graph_runs_the_refiner_plainly(megapose, world, monkeypatch):
    """Inside `run_inference_pipeline_jit`'s call (on the CPU its plain call;
    on the card its warm-up and capture) the refiner's chunks run plainly:
    the frame's first call and its second move `graphs.pipeline.*` and
    leave `graphs.stage.*` and the stage caches as they were. The eager
    pipeline sends the same chunks (4 rows, 2 a chunk) through one stage
    key: a capture, then a replay."""
    est, obs, _ = megapose
    monkeypatch.setattr(tpe, "_stage_graphs", weakref.WeakKeyDictionary())
    det = _inputs(world, "megapose-RGB")[1]
    before, pipeline = _stage_counts(), profiling.counters().get("graphs.pipeline.replays", 0)
    graphed = est.run_inference_pipeline_jit(obs, det)
    est.run_inference_pipeline_jit(obs, det)
    assert profiling.counters()["graphs.pipeline.replays"] == pipeline + 1
    assert _stage_counts() == before
    assert [len(c) for c in tpe._stage_graphs.values()] in ([], [0])
    eager = est.run_inference_pipeline(obs, det)
    assert _stage_counts() == {"captures": before["captures"] + 1,
                               "replays": before["replays"] + 1}
    assert len(tpe._stage_graphs[est.refiner_model]) == 1
    torch.testing.assert_close(graphed["final"].poses, eager["final"].poses, rtol=0, atol=0)


def test_detector_graphed_forward_equals_eager():
    torch.manual_seed(0)
    model = FCOSDetector(DetectorConfig(n_classes=3, fpn_channels=32)).init_weights(
        torch.Generator().manual_seed(0))
    detector = Detector(model, image_size=(64, 80))
    rgb = torch.from_numpy(np.random.RandomState(0).rand(2, 3, 64, 80).astype(np.float32))
    out, _ = detector._detect(rgb, 0.5, 32)
    with torch.inference_mode():
        ref = model(rgb)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    detector._detect(rgb[:1], 0.5, 32)
    detector._detect(rgb, 0.5, 32)
    assert len(detector._graphs) == 2


def test_jit_pipeline_refuses_a_device_mesh(world):
    _, est = _estimators("megapose-RGB", world["jdb"], world["tdb"])
    est.device_mesh = object()
    obs, det = _inputs(world, "megapose-RGB")
    with pytest.raises(ValueError, match="device_mesh"):
        est.run_inference_pipeline_jit(obs, det)


class _HostReads(TorchDispatchMode):
    """Records the operators a CUDA graph capture refuses (a read of a
    device value on the host, a copy from the host, a random draw, a linear
    algebra call that checks its status on the host)."""

    REFUSED = {"_local_scalar_dense", "is_nonzero", "nonzero", "lift_fresh", "masked_select",
               "_linalg_check_errors", "linalg_solve", "linalg_svd", "_linalg_svd",
               "linalg_det", "_linalg_det", "equal", "rand", "randn", "randint", "randperm",
               "_unique2", "unique_consecutive"}

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._overloadpacket.__name__
        # repeat_interleave with a tensor of repeats reads their sum
        if name in self.REFUSED or str(func) == "aten.repeat_interleave.Tensor":
            self.seen.add(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("flavour", FLAVOURS + ("megapose-RGB+teaserpp",))
def test_frame_has_no_host_reads(world, flavour, monkeypatch):
    """The eager frame (after a first call has filled the lazy state, as
    the graph's warm-up does) runs no operator that a capture refuses, the
    kernel's plain version aside (on the card the kernel takes its place)."""
    _, est = _estimators(flavour.replace("teaserpp", "icp"), world["jdb"], world["tdb"])
    if flavour.endswith("teaserpp"):
        est.cfg = dataclasses.replace(est.cfg, depth_refiner="teaserpp")
    obs, det = _inputs(world, flavour)
    est.run_inference_pipeline(obs, det)
    mode = _HostReads()
    plain = rf.raster_fused_reference

    def kernel_stand_in(*args):
        with torch.utils._python_dispatch._disable_current_modes():
            return plain(*args)

    monkeypatch.setattr(rf, "raster_fused_reference", kernel_stand_in)
    with mode:
        est.run_inference_pipeline(obs, det)
    assert not mode.seen, sorted(mode.seen)


def test_kabsch_equals_svd():
    """`_kabsch` against Kabsch through `torch.linalg.svd` on float64, on
    anisotropic, planar, noisy and reflected clouds, to `KABSCH_TOL`."""
    rs = np.random.RandomState(5)
    n = 60
    src = rs.randn(64, n, 3) * rs.uniform(0.01, 1.0, (64, 1, 3))
    src[::4, :, 2] = 0.0  # planar: the third singular value is 0
    R = np.linalg.qr(rs.randn(64, 3, 3))[0]
    R *= np.sign(np.linalg.det(R))[:, None, None]
    dst = np.einsum("bij,bnj->bni", R, src) + rs.randn(64, n, 3) * rs.uniform(0, 0.05, (64, 1, 1))
    dst[::7] *= -1.0  # reflections: det(V U^T) = -1
    w = rs.rand(64, n)
    P = src - (w[..., None] * src).sum(1, keepdims=True) / w.sum(1)[:, None, None]
    Q = dst - (w[..., None] * dst).sum(1, keepdims=True) / w.sum(1)[:, None, None]
    H = torch.from_numpy(np.einsum("bn,bni,bnj->bij", w, P, Q).astype(np.float32))
    U, _, Vt = torch.linalg.svd(H.double())
    V, Ut = Vt.transpose(-1, -2), U.transpose(-1, -2)
    d = torch.sign(torch.linalg.det(V @ Ut))
    ref = V @ torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1)) @ Ut
    out = _kabsch(H)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out.double(), ref, rtol=0, atol=KABSCH_TOL)
    # H = 0 (every weight 0): the identity, as the SVD's U = V = I gives
    torch.testing.assert_close(_kabsch(torch.zeros(2, 3, 3)), torch.eye(3).expand(2, 3, 3))


def test_a_cache_called_inside_a_cache_runs_plainly():
    """A `GraphCache` called inside another's call (here its CPU plain call)
    runs its function plainly: no entry, no count. Alone it counts."""
    inner, outer = GraphCache("inner_test"), GraphCache("outer_test")

    def inner_fn(x):
        return x + 1

    def outer_fn(x):
        return inner("k", inner_fn, (x,)) * 2

    x = torch.arange(3.0)
    torch.testing.assert_close(outer("k", outer_fn, (x,)), (x + 1) * 2)
    counters = profiling.counters()
    assert len(inner) == 0 and "graphs.inner_test.captures" not in counters
    assert counters["graphs.outer_test.captures"] == 1
    inner("k", inner_fn, (x,))
    assert len(inner) == 1 and profiling.counters()["graphs.inner_test.captures"] == 1


def test_graph_cache_on_the_cpu():
    """The cache's plain path: entries per input shape and per captured
    object, outputs cloned (a tensor the function returns twice is cloned
    once), and an input that is returned does not alias its buffer."""
    cache = GraphCache("plain")
    calls = []

    def fn(x, pair):
        calls.append(1)
        y = x * 2
        return {"y": y, "again": y, "x": x, "pair": pair}

    x = torch.arange(4.0)
    out = cache("k", fn, (x, (x + 1, None)))
    assert out["y"] is out["again"] and out["x"] is not x
    assert out["pair"][1] is None
    cache("k", fn, (x + 5, (x, None)))
    assert len(cache) == 1 and len(calls) == 2
    torch.testing.assert_close(out["y"], x * 2)  # not moved by the second call
    cache("k", fn, (torch.arange(3.0), (x, None)))
    cache("k", fn, (x, (x, None)), captured=(object(),))
    assert len(cache) == 3
    with pytest.raises(ValueError):
        cache("k", fn, (x.to("meta"), (x, None)))
    c = device_constant((1.0, 2.0), torch.float32, "cpu")
    assert c is device_constant((1.0, 2.0), torch.float32, torch.device("cpu"))
    assert not c.is_inference()
