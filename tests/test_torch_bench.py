"""The port's bench (`happypose_tpu_torch/bench.py`) against the JAX
package's root `bench.py` and `__graft_entry__.entry()`, on the CPU.

- The inputs and the mesh sets are the JAX bench's, bit for bit.
- `entry()`: JAX's own `entry()` (renderer "reference" on the CPU, as it
  picks itself) with seeded Flax variables, carried over by
  `weights_from_jax`, against the port's `forward` on its example
  arguments: poses to 1e-5 (float32 through ResNet34 at 240x320).
- `refiner_bench`: two chained iterations at B = 2 on the debug set
  against JAX's `model.apply` chain (the second iteration to 1e-5, the
  chain to `CRACK_TOL`), and the same chain through JAX's Pallas kernel
  (interpreted), which ends no closer.
- `pipeline_bench` at `so3_grid=72` (the shipped 72-rotation grid) with
  the four fixed detections: JAX's final poses, with the tolerances of
  `tests/test_torch_pipeline.py`. Both sides run megapose-RGB cut to 24x32
  renders and WideResNet18 (the full-width pipeline takes minutes on the
  CPU; `entry()` and the refiner hold ResNet34 at full width) with seeded
  Flax variables carried over.
- The JSON lines carry JAX's keys, constants and metric names for each
  argv; without a card the CLI fails with PyTorch's error; the PLY of the
  bop mesh sets lies inside the repository, and where it is absent they
  raise `FileNotFoundError` naming it; the module imports no JAX.

The Flax variables are seeded values on the tree of Flax's `init` (read
with `jax.eval_shape`; an eager `init` of ResNet34 at 240x320 takes ~30 s
on the CPU), as `tests/test_torch_backbones.py` makes them.
"""

import ast
import dataclasses
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import happypose_tpu.models.pose_predictor as jpp
from happypose_tpu.inference.types import DetectionBatch as JaxDetections
from happypose_tpu.inference.types import ObservationBatch as JaxObservation
from happypose_tpu.inference.pose_estimator import PoseEstimator as JaxPoseEstimator
from happypose_tpu.utils import load_model as jax_load_model
from happypose_tpu_torch import bench
from happypose_tpu_torch.utils import load_model as torch_load_model
from happypose_tpu_torch.utils.weights_from_jax import pose_predictor_state_dict
from test_torch_backbones import seeded_variables

torch.set_num_threads(2)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

ROOT = Path(__file__).resolve().parents[1]
POSE_TOL = 1e-5
CRACK_TOL = 1e-3  # see test_refiner_bench_matches_jax_chain
PIPELINE_RENDER = (24, 32)
LOGIT_TOL = 2e-5  # tests/test_torch_pipeline.py


def _root_module(name: str):
    """A module at the root of the repository (the JAX bench, the graft
    entry), loaded by path under a name of its own."""
    spec = importlib.util.spec_from_file_location(f"jax_root_{name}", ROOT / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jax_bench():
    return _root_module("bench")


def _jax_inputs(B):
    """The JAX bench's inputs as `bench.py:main` builds them."""
    rs = np.random.RandomState(0)
    images = jnp.asarray(rs.rand(B, 3, 240, 320).astype(np.float32))
    K = jnp.broadcast_to(jnp.asarray([[600.0, 0, 160], [0, 600.0, 120], [0, 0, 1]]), (B, 3, 3))
    obj_ids = jnp.asarray([0, 1] * (B // 2), jnp.int32)
    TCO0 = jnp.broadcast_to(jnp.eye(4), (B, 4, 4)).at[:, 2, 3].set(0.5)
    return images, K, obj_ids, TCO0


def _assert_same_db(jdb, tdb, **assets_kw):
    ja, ta = jdb.render_assets(**assets_kw), tdb.render_assets(device="cpu", **assets_kw)
    for f in dataclasses.fields(ta):
        np.testing.assert_array_equal(getattr(ta, f.name).numpy(), np.asarray(getattr(ja, f.name)),
                                      err_msg=f.name)
    jm, tm = jdb.batched(n_points=512), tdb.batched(n_points=512, device="cpu")
    for f in dataclasses.fields(tm):
        np.testing.assert_array_equal(getattr(tm, f.name).numpy(), np.asarray(getattr(jm, f.name)),
                                      err_msg=f.name)


@pytest.mark.parametrize("B", [2, 16, 64])
def test_inputs_are_the_jax_bench_inputs(B):
    for j, t in zip(_jax_inputs(B), bench.bench_inputs(B, "cpu"), strict=True):
        assert t.shape == j.shape
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_mesh_sets_are_the_jax_bench_mesh_sets(jax_bench):
    jdb, tdb = jax_bench._mesh_db("debug"), bench._mesh_db("debug")
    assert tdb.labels == jdb.labels == ["box", "sphere"]
    assert tdb.render_assets(device="cpu").faces.shape[1] == 512 * 3
    _assert_same_db(jdb, tdb)
    graft = _root_module("__graft_entry__")
    jdb, _, _ = graft._world()
    tdb, _, _ = bench._world("cpu")
    _assert_same_db(jdb, tdb, texture_size=64)


# ---------------------------------------------------------------- weights


def _jax_cfg(renderer="reference", **kw):
    return jpp.PosePredictorConfig(backbone="resnet34", render_size=(240, 320),
                                   renderer=renderer, **kw)


@pytest.fixture(scope="module")
def variables(jax_bench):
    """Seeded Flax variables of the bench's ResNet34 refiner (9 input
    channels: the crop, rgb and normal renders), and their state dict."""
    model = jpp.PosePredictor(_jax_cfg())
    db = jax_bench._mesh_db("debug")
    images, K, obj_ids, TCO0 = _jax_inputs(2)
    shapes = jax.eval_shape(
        lambda *a: model.init(jax.random.PRNGKey(0), *a, n_iterations=1),
        images, K, obj_ids, TCO0, db.render_assets(), db.batched(n_points=512).select(obj_ids))
    v = seeded_variables(shapes, seed=4)
    return v, pose_predictor_state_dict(v)


def _carrying(state_dict):
    """`bench.seeded_predictor` with the carried weights."""
    def build(cfg, device):
        model = bench.PosePredictor(cfg)
        model.load_state_dict(state_dict)
        return model.to(device).eval()
    return build


def test_entry_matches_jax_entry(variables, monkeypatch):
    jvars, state_dict = variables
    graft = _root_module("__graft_entry__")
    with monkeypatch.context() as mp:
        # JAX's entry() inits its model eagerly (~30 s); hand it the seeded tree
        mp.setattr(jpp.PosePredictor, "init",
                   lambda *a, **k: jax.tree.map(jnp.asarray, jvars))
        jax_forward, jax_args = graft.entry()
    ref = np.asarray(jax_forward(*jax_args))

    monkeypatch.setattr(bench, "seeded_predictor", _carrying(state_dict))
    forward, args = bench.entry("cpu")
    for t, j in zip(args, jax_args[1:], strict=True):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    out = forward(*args)
    assert out.shape == (4, 4, 4) and torch.isfinite(out).all()
    # the seeded head moves the poses
    assert np.abs(ref - args[3].numpy()).max() > 1e-3
    np.testing.assert_allclose(out.numpy(), ref, atol=POSE_TOL, rtol=0)


def _jax_chain(jax_bench, jvars, renderer, B=2, n=2):
    """JAX's `model.apply` chain of `n` iterations at B from the bench's
    start, float32, through `renderer`: the poses after each."""
    model = jpp.PosePredictor(_jax_cfg(renderer, compute_dtype="float32"))
    db = jax_bench._mesh_db("debug")
    images, K, obj_ids, T0 = _jax_inputs(B)
    assets, meshes = db.render_assets(), db.batched(n_points=512).select(obj_ids)
    jv = jax.tree.map(jnp.asarray, jvars)
    chain = [T0]
    for _ in range(n):
        chain.append(model.apply(jv, images, K, obj_ids, chain[-1], assets, meshes,
                                 n_iterations=1).TCO_output[-1])
    return [np.asarray(T) for T in chain]


@pytest.fixture(scope="module")
def reference_chain(jax_bench, variables):
    return _jax_chain(jax_bench, variables[0], "reference")


@pytest.fixture(scope="module")
def port_chain(variables):
    """The port's `refiner_bench` at B = 2 with two chained iterations and
    the carried weights: (its line, its notes)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench, "seeded_predictor", _carrying(variables[1]))
        mp.setattr(bench, "N_SCAN", 2)
        return bench.refiner_bench(batch=2, device="cpu")


def test_refiner_bench_matches_jax_chain(variables, reference_chain, port_chain):
    """Two chained iterations at B = 2 from the bench's start against JAX's
    `model.apply` chain through its two-pass reference renderer. The start
    (identity rotation) puts meridian edges of the UV sphere exactly on
    pixel centres, where the kernel's normalized edge functions (bit-equal
    to the card's kernel) leave pixels that neither neighbour covers and
    JAX's two-pass reference covers: 42 of 153,600 depth pixels differ
    there, and the first update by 2.4e-4 (measured), so the chain is held
    to `CRACK_TOL`; the second iteration, run by the port from JAX's first
    pose, to 1e-5 (measured 2e-7). JAX's Pallas kernel does not do better
    there: see `test_refiner_chain_pallas_kernel_is_no_closer`."""
    B = 2
    T0, J1, J2 = reference_chain
    line, notes = port_chain
    assert notes["compute_dtype"] == "float32, tf32 off" and notes["launches"] == 0  # plain
    assert line["metric"] == "refiner_pose_iterations_per_sec_per_chip_b2" and line["value"] > 0
    assert np.abs(J2 - T0).max() > 1e-2  # the seeded head moves the poses
    np.testing.assert_allclose(notes["TCO"].numpy(), J2, atol=CRACK_TOL, rtol=0)

    tdb = bench._mesh_db("debug")
    ti, tK, tids, _ = bench.bench_inputs(B, "cpu")
    port = _carrying(variables[1])(bench.PosePredictorConfig(render_size=bench.RES), "cpu")
    with torch.no_grad():
        P2 = port(ti, tK, tids, torch.from_numpy(J1.copy()), tdb.render_assets(device="cpu"),
                  tdb.batched(n_points=512, device="cpu").select(tids)).TCO_output[-1]
    np.testing.assert_allclose(P2.numpy(), J2, atol=POSE_TOL, rtol=0)


def test_refiner_chain_pallas_kernel_is_no_closer(jax_bench, variables, reference_chain,
                                                  port_chain):
    """The same chain through JAX's Pallas kernel (interpreted): its edge
    functions come from a matrix product, so at this start it disagrees
    with the two-pass reference on more edge pixels
    (`test_torch_rasterizer.py::test_render_batch_fused_matches_jax`, the
    "identity" scene), and the port's chain ends farther from it than from
    the reference's: the gap of `test_refiner_bench_matches_jax_chain` is
    not the reference's alone."""
    out = port_chain[1]["TCO"].numpy()
    ref = reference_chain[-1]
    pallas = _jax_chain(jax_bench, variables[0], "pallas_interpret")[-1]
    assert np.abs(out - ref).max() <= np.abs(out - pallas).max()
    assert np.abs(pallas - ref).max() > CRACK_TOL


# ---------------------------------------------------------------- pipeline


def _cut(spec, **renderer):
    cut = dict(render_size=PIPELINE_RENDER, backbone="wide_resnet18", **renderer)
    return dataclasses.replace(spec, refiner_cfg=dataclasses.replace(spec.refiner_cfg, **cut),
                               coarse_cfg=dataclasses.replace(spec.coarse_cfg, **cut))


def test_pipeline_bench_matches_jax(jax_bench, monkeypatch):
    """`bench.py:pipeline_bench`'s path at `--so3 72` on JAX (its mesh set,
    frame, grid override and detections, megapose-RGB cut to 24x32 renders
    and WideResNet18, seeded variables) against the port's `pipeline_bench` with those
    variables carried over. The coarse logits agree to `LOGIT_TOL`. A box
    detection's top-5 is decided (its 5th and 6th logits lie more than
    2 x `LOGIT_TOL` apart): the same final hypothesis, its pose within
    1e-5 m and 1e-5 rad. The debug sphere is uniformly coloured, so its
    hypotheses tie (5th and 6th logits within 1e-6) and either package may
    keep another of them: its final translation within 1e-5 m (its
    rotation is not observable)."""
    grid = 72
    jdb = jax_bench._mesh_db("debug")
    spec = _cut(jax_load_model.NAMED_MODELS["megapose-RGB"], renderer="reference")
    assets, meshes = jdb.render_assets(), jdb.batched(n_points=1000)
    images, K1, ids, TCO1 = (x[:1] for x in _jax_inputs(2))
    variables = {}

    def seeded(cfg, role, seed):
        model = jpp.PosePredictor(cfg)
        shapes = jax.eval_shape(lambda *a: model.init(jax.random.PRNGKey(0), *a),
                                images, K1, ids, TCO1, assets, meshes.select(ids))
        variables[role] = seeded_variables(shapes, seed)
        return model, jax.tree.map(jnp.asarray, variables[role])

    # bench.py's estimator after its `--so3` override (bench.py:146-155)
    est = JaxPoseEstimator(
        refiner=seeded(spec.refiner_cfg, "refiner", 21), coarse=seeded(spec.coarse_cfg, "coarse", 22),
        assets=assets, meshes=meshes,
        cfg=dataclasses.replace(spec.inference_cfg, SO3_grid_size=grid,
                                bsz_images=min(spec.inference_cfg.bsz_images, grid)))
    rgb = np.random.RandomState(0).rand(1, 3, 240, 320).astype(np.float32)
    K = np.asarray([[[600.0, 0, 160], [0, 600.0, 120], [0, 0, 1]]], np.float32)
    boxes = np.asarray([[60, 40, 140, 120], [160, 50, 240, 130], [80, 120, 160, 200],
                        [180, 130, 260, 210]], np.float32)
    obj_ids = np.asarray([0, 1, 0, 1], np.int32)
    jres = est.run_inference_pipeline(
        JaxObservation(rgb=jnp.asarray(rgb), K=jnp.asarray(K)),
        JaxDetections.from_numpy(boxes=boxes, obj_ids=obj_ids),
        n_refiner_iterations=5, n_pose_hypotheses=5)
    np.testing.assert_array_equal(np.asarray(bench.PIPELINE_BOXES, np.float32), boxes)
    np.testing.assert_array_equal(bench.PIPELINE_OBJ_IDS, obj_ids)

    port_spec = _cut(torch_load_model.NAMED_MODELS["megapose-RGB"])
    state_dicts = {k: pose_predictor_state_dict(v) for k, v in variables.items()}

    def load(name, db, **kw):
        assert name == "megapose-RGB"
        return torch_load_model.load_named_model(port_spec, db, state_dicts=state_dicts, **kw)

    monkeypatch.setattr(bench, "load_named_model", load)
    line, notes = bench.pipeline_bench(n_images=1, so3_grid=grid, device="cpu")
    # 4 x 72 / 72 coarse + ceil(20 / 16) x 5 refiner + ceil(20 / 72) scoring chunks
    assert notes["launches_per_frame"] == 4 + 2 * 5 + 1 and notes["frames"] == 2
    assert notes["launches"] == 0  # the plain version
    assert line["metric"] == "pipeline_seconds_per_image" and line["value"] > 0

    j = jax.tree.map(np.asarray, jres["coarse"])
    t = notes["results"]["coarse"]
    assert t.coarse_logits.shape == (4 * grid,)
    np.testing.assert_allclose(t.coarse_logits.numpy(), j.coarse_logits, atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    top = -np.sort(-j.coarse_logits.reshape(4, grid), axis=1)
    decided = top[:, 4] - top[:, 5] > 2 * LOGIT_TOL
    assert decided.tolist() == [True, False, True, False]  # the boxes, the spheres

    jf, tf = jax.tree.map(np.asarray, jres["final"]), notes["results"]["final"]
    assert tf.valid.sum() == jf.valid.sum() == 4
    for d in range(4):
        jr = np.flatnonzero(jf.valid & (jf.instance_ids == d // 2) & (jf.obj_ids == obj_ids[d]))
        tr = np.flatnonzero((tf.valid & (tf.instance_ids == d // 2)
                             & (tf.obj_ids == int(obj_ids[d]))).numpy())
        assert len(jr) == len(tr) == 1
        jp, tp = jf.poses[jr[0]], tf.poses[tr[0]].numpy()
        assert np.isfinite(tp).all() and np.abs(tp[:3, 3] - jp[:3, 3]).max() < 1e-5
        if decided[d]:
            assert jf.hypothesis_ids[jr[0]] == tf.hypothesis_ids[tr[0]]
            dR = np.linalg.norm((tp[:3, :3] - jp[:3, :3]).astype(np.float64))
            assert 2 * np.arcsin(min(dR / (2 * np.sqrt(2)), 1.0)) < 1e-5


# ---------------------------------------------------------------- the lines


def _jax_line_dicts(jax_bench):
    """The dict literals that `bench.py` hands to `json.dumps`, by function:
    {key: constant value, or None where the value is computed}."""
    out = {}
    for fn in ast.parse(Path(jax_bench.__file__).read_text()).body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        for node in ast.walk(fn):
            if (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "dumps"
                    and isinstance(node.args[0], ast.Dict)):
                d = node.args[0]
                out[fn.name] = {
                    k.value: ast.literal_eval(v) if not isinstance(v, (ast.Call, ast.Name)) else None
                    for k, v in zip(d.keys, d.values)}
    return out


def _same_line(line, jax_dict):
    assert list(line) == list(jax_dict)
    for k, v in jax_dict.items():
        if v is not None:
            assert line[k] == v, k


# argv -> (refiner_bench's arguments, JAX's metric name: bench.py:281-285)
REFINER_ARGV = {
    (): ("debug", 16, "refiner_pose_iterations_per_sec_per_chip"),
    ("--batch", "64"): ("debug", 64, "refiner_pose_iterations_per_sec_per_chip_b64"),
    ("--mesh", "bop3k"): ("bop3k", 16, "refiner_pose_iterations_per_sec_per_chip_bop3k"),
    ("--mesh", "bop_full", "--batch", "8"):
        ("bop_full", 8, "refiner_pose_iterations_per_sec_per_chip_bop_full_b8"),
}


@pytest.fixture
def cli(monkeypatch, capsys):
    """`bench.main` with the card's queries stubbed and each mode replaced
    by a recorder; returns run(argv) -> (the mode's arguments, the lines)."""
    calls = []
    monkeypatch.setattr(bench.torch.cuda, "get_device_name", lambda i=0: "stub card")
    monkeypatch.setattr(bench.torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(bench, "card_line", lambda: "stub card, 700.00 W")

    def refiner(mesh_set="debug", batch=bench.B, device="cuda"):
        calls.append((mesh_set, batch))
        return bench.refiner_line(mesh_set, batch, 800.0), {
            "compute_dtype": "bfloat16, tf32 off", "launches": 21, "launches_with_profile": 41,
            "seconds": 0.4, "profile": {}}

    def pipeline(n_images=8, so3_grid=0, device="cuda"):
        calls.append((n_images, so3_grid))
        return bench.pipeline_line(0.5), {"compute_dtype": "float32, tf32 off", "launches": 38,
                                          "launches_per_frame": 19, "frames": 9}

    def breakdown(device="cuda"):
        calls.append(())
        return {"render_ms": 0.1, "crop_ms": 0.2, "cnn9ch_ms": 1.0, "full_iter_ms": 2.0,
                "batch": 16}

    monkeypatch.setattr(bench, "refiner_bench", refiner)
    monkeypatch.setattr(bench, "pipeline_bench", pipeline)
    monkeypatch.setattr(bench, "breakdown", breakdown)

    def run(argv):
        calls.clear()
        bench.main(list(argv))
        lines = capsys.readouterr().out.strip().splitlines()
        return calls[0], lines
    return run


@pytest.mark.parametrize("argv", sorted(REFINER_ARGV))
def test_refiner_line_for_each_argv(jax_bench, cli, argv):
    mesh_set, batch, metric = REFINER_ARGV[argv]
    args, lines = cli(argv)
    assert args == (mesh_set, batch)
    line = json.loads(lines[-1])
    _same_line(line, _jax_line_dicts(jax_bench)["main"])
    assert line["metric"] == metric and line["vs_baseline"] == 16.0
    assert lines[0].startswith("device stub card count 1; stub card, 700.00 W")
    assert "allow_tf32=False" in lines[1] and "launches 21" in lines[2]
    assert "compute_dtype bfloat16, tf32 off" in lines[2]


@pytest.mark.parametrize("argv,so3", [(("--pipeline",), 0), (("--pipeline", "--so3", "72"), 72)])
def test_pipeline_line_for_each_argv(jax_bench, cli, argv, so3):
    args, lines = cli(argv)
    assert args == (8, so3)
    line = json.loads(lines[-1])
    _same_line(line, _jax_line_dicts(jax_bench)["pipeline_bench"])
    assert line["vs_baseline"] == round(39.7 / 0.5, 2)
    assert ("launches 38 (expected 2 x 19: the frame graph's warm-up and capture; its 9 "
            "replays launch on the device)") in lines[2]
    assert "compute_dtype float32, tf32 off" in lines[2]


def test_breakdown_line(jax_bench, cli, monkeypatch):
    _, lines = cli(["--breakdown"])
    _same_line(json.loads(lines[-1]), _jax_line_dicts(jax_bench)["breakdown"])
    # and the real function, cut to B = 2 and one timed launch on the CPU,
    # with TF32 off inside it whatever the caller's flags, which it restores
    monkeypatch.undo()
    monkeypatch.setattr(bench, "B", 2)
    monkeypatch.setattr(bench, "N_SCAN", 1)
    seen, crop = set(), bench.crop_images_matmul

    def crop_seeing_tf32(*a, **k):
        seen.add((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return crop(*a, **k)

    monkeypatch.setattr(bench, "crop_images_matmul", crop_seeing_tf32)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    line = bench.breakdown(device="cpu")
    assert seen == {(False, False)} and not bench.TF32
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    _same_line(line, _jax_line_dicts(jax_bench)["breakdown"])
    assert line["batch"] == 2 and all(line[k] > 0 for k in line)


# ---------------------------------------------------------------- failures


def test_absent_ply_raises_naming_it(tmp_path, monkeypatch):
    """The bop mesh sets read the reference's BOP test mesh from inside the
    repository, and nothing above it; where the file is absent they wait
    for it, naming its path."""
    assert ROOT in bench.BOP_PLY.resolve().parents
    monkeypatch.setattr(bench, "BOP_PLY", tmp_path / "obj_000001.ply")
    for mesh_set in ("bop3k", "bop_full"):
        with pytest.raises(FileNotFoundError, match=f"waits for .* {tmp_path / 'obj_000001.ply'}"):
            bench.refiner_bench(mesh_set, device="cpu")
    with pytest.raises(SystemExit, match="unknown --mesh set"):
        bench._mesh_db("bop")


def _run(code_or_args, **kw):
    return subprocess.run([sys.executable, *code_or_args], capture_output=True, text=True,
                          cwd=ROOT, timeout=120, **kw)


def test_cli_without_a_card_fails_with_torch_error():
    """No card, no CPU fallback: each mode raises PyTorch's error before
    any work, and the command exits nonzero without a JSON line."""
    for argv in ([], ["--pipeline"], ["--breakdown"], ["--mesh", "bop3k"]):
        with pytest.raises((AssertionError, RuntimeError), match="(?i)cuda|nvidia"):
            bench.main(argv)
    p = _run(["-m", "happypose_tpu_torch.bench", "--pipeline"])
    assert p.returncode != 0
    assert "cuda" in p.stderr.lower() or "nvidia" in p.stderr.lower(), p.stderr[-2000:]
    assert "{" not in p.stdout


def test_bench_imports_no_jax():
    code = ("import sys, happypose_tpu_torch.bench; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', "
            "'happypose_tpu')]; assert not bad, bad")
    p = _run(["-c", code])
    assert p.returncode == 0, p.stderr[-2000:]
