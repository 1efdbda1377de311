"""The JAX package's run directories in the port: the Flax msgpack decoder
and encoder (`utils/flax_msgpack.py`), the weight bridge both ways
(`utils/weights_from_jax.py`), optax's Adam state and the TrainState
(`utils/checkpoint.py`), and serving from such directories
(`utils/load_model.py`).

Files are written by the JAX package's own `utils.checkpoint.save_checkpoint`
(Flax's `to_bytes`) and read back by Flax's `msgpack_restore`. Tolerances:
- decoded arrays equal Flax's bit for bit (bfloat16 compared as its 16-bit
  patterns), scalars by type and value; the encoder's bytes equal Flax's;
- the bridge both ways exactly: the tree JAX's `model.init` makes (read
  with `jax.eval_shape`, seeded with numpy), its key order, shapes,
  dtypes and values;
- Adam's `count`, `mu`, `nu` and the TrainState's `step` exactly after
  transposition; the first resumed step's loss to 1e-5 relative
  (`tests/test_torch_training_grads.py`);
- final poses through `run_inference_pipeline` to 1e-5 m and 1e-5 rad,
  logits to 2e-5 (`tests/test_torch_pipeline.py`); detections: the same
  rows, boxes to 1e-3 px, scores to 1e-4 relative
  (`tests/test_torch_detector.py`); variables JAX reads from a directory
  the port wrote equal the ones it read from its own, bit for bit.
"""

import copy
import dataclasses
import json
import shutil

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from happypose_tpu.inference.types import DetectionBatch as JaxDetections
from happypose_tpu.inference.types import ObservationBatch as JaxObservation
from happypose_tpu.models import detector as jd
from happypose_tpu.models.pose_predictor import PosePredictor as JaxPosePredictor
from happypose_tpu.models.pose_predictor import PosePredictorConfig as JaxConfig
from happypose_tpu.training import forward_loss as jax_fl
from happypose_tpu.training import trainer as jax_trainer
from happypose_tpu.utils import checkpoint as jax_ckpt
from happypose_tpu.utils import load_model as jax_load_model
from happypose_tpu_torch.inference.types import DetectionBatch, ObservationBatch
from happypose_tpu_torch.models import detector as td
from happypose_tpu_torch.models.pose_predictor import PosePredictor, PosePredictorConfig
from happypose_tpu_torch.training import TrainState, make_optimizer, make_train_step
from happypose_tpu_torch.training.forward_loss import make_refiner_loss_fn
from happypose_tpu_torch.utils import checkpoint as ckpt
from happypose_tpu_torch.utils import flax_msgpack as fm
from happypose_tpu_torch.utils import load_model as torch_load_model
from happypose_tpu_torch.utils import weights_from_jax as wfj
from test_torch_backbones import seeded_variables
from test_torch_models import mesh_dbs, perturb
from test_torch_pipeline import LOGIT_TOL, _frame, _rows, _small
from test_torch_training import jax_noise_draws
from test_torch_training_grads import _batch, _torch_batch

torch.set_num_threads(2)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


def _leaves(tree, path=()):
    """(path, leaf) in the tree's own key order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _bits(x):
    """(dtype name, shape, bytes) of an array leaf, bfloat16 as its bits."""
    if isinstance(x, torch.Tensor):
        name = str(x.dtype).split(".")[-1]
        return name, tuple(x.shape), x.view(torch.int16 if x.element_size() == 2
                                            else torch.uint8).numpy().tobytes()
    x = np.asarray(x)
    return x.dtype.name, x.shape, x.tobytes()


def assert_trees_equal(ours, ref):
    """The same keys in the same order, arrays bit for bit, scalars by type
    and value."""
    a, b = list(_leaves(ours)), list(_leaves(ref))
    assert [p for p, _ in a] == [p for p, _ in b]
    for (p, x), (_, y) in zip(a, b):
        if isinstance(y, (np.ndarray, jax.Array)) or isinstance(x, torch.Tensor):
            assert _bits(x) == _bits(y), p
        else:
            assert type(x) is type(y) and (x == y or (x != x and y != y)), (p, x, y)


# --------------------------------------------------- (a), (b) the file format


def _params(rs):
    return {"Conv_0": {"kernel": rs.randn(3, 3, 4, 8).astype(np.float32),
                       "bias": rs.randn(8).astype(np.float32)},
            "pose_fc": {"kernel": rs.randn(8, 9).astype(np.float32),
                        "bias": rs.randn(9).astype(np.float32)}}


def _train_state(weight_decay):
    """A JAX TrainState after one applied update: Adam (or AdamW) behind the
    clip, the schedule's count."""
    rs = np.random.RandomState(1)
    params = jax.tree.map(jnp.asarray, _params(rs))
    tx = jax_trainer.make_optimizer(lr=1e-3, n_warmup_steps=2, weight_decay=weight_decay)
    state = jax_trainer.TrainState.create(
        {"params": params, "batch_stats": {"BatchNorm_0": {"mean": jnp.ones(8),
                                                           "var": jnp.full(8, 2.0)}}}, tx)
    grads = jax.tree.map(lambda p: jnp.asarray(rs.randn(*p.shape), jnp.float32), params)
    updates, opt = tx.update(grads, state.opt_state, state.params)
    return state.replace(step=state.step + 1, params=optax.apply_updates(state.params, updates),
                         opt_state=opt)


def _mixed(rs):
    """Every leaf type of the format: numpy scalars, complex, ints of every
    width, floats, str of every header, bytes, bool, None, lists, nested and
    empty maps, bfloat16, float8, integer and empty arrays."""
    return {
        "bf16": rs.randn(5, 3).astype(ml_dtypes.bfloat16),
        "f8": rs.randn(4).astype(ml_dtypes.float8_e4m3fn),
        "f64": rs.randn(2, 2), "i8": np.arange(-4, 4, dtype=np.int8),
        "u16": np.arange(7, dtype=np.uint16), "b": np.asarray([True, False]),
        "empty_array": np.zeros((0, 3), np.float16), "c64": np.asarray([1 + 2j], np.complex64),
        "scalars": {"f32": np.float32(2.5), "i64": np.int64(-7), "u8": np.uint8(200),
                    "bool": np.bool_(True), "f16": np.float16(0.25)},
        "python": {"complex": 1.5 - 2j, "float": 0.1, "none": None, "true": True,
                   "ints": [0, 127, 128, 255, 256, 65535, 65536, 2**32, -1, -32, -33, -128,
                            -129, -32768, -32769, -2**31 - 1, 2**63],
                   "str": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "e" * 65536],
                   "bytes": [b"", b"x" * 255, b"y" * 256, b"z" * 65536]},
        "nested": {"a": {"b": {"c": {}}}, "empty": {}},
        "many": {f"k{i}": i for i in range(17)},
    }


def _chunked(rs):
    return {"w": rs.randn(37, 11).astype(np.float32),
            "h": rs.randn(300).astype(ml_dtypes.bfloat16), "small": np.arange(3)}


TREES = {
    "adam": lambda rs: _train_state(0.0),
    "adamw": lambda rs: _train_state(1e-2),
    "mixed": _mixed,
    "chunked": _chunked,
}


@pytest.fixture(params=sorted(TREES))
def written(request, tmp_path, monkeypatch):
    """(tree, run directory) of a tree written by the JAX package's
    `save_checkpoint`; "chunked" with Flax's chunk size (and the port's)
    lowered to 1000 bytes."""
    if request.param == "chunked":
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 1000)
        monkeypatch.setattr(fm, "MAX_CHUNK_SIZE", 1000)
    tree = TREES[request.param](np.random.RandomState(0))
    jax_ckpt.save_checkpoint(tmp_path, tree, epoch=3, config={"backbone": "resnet34"})
    return request.param, tree, tmp_path


def test_decoder_matches_msgpack_restore(written):
    """(a) Every file `save_checkpoint` writes decodes to Flax's tree."""
    name, _, run_dir = written
    data = (run_dir / "checkpoint.msgpack").read_bytes()
    ref = serialization.msgpack_restore(data)
    assert_trees_equal(fm.read_file(run_dir / "checkpoint.msgpack"), ref)
    assert_trees_equal(fm.msgpack_restore(data), ref)
    if name == "chunked":
        assert "__msgpack_chunked_array__" in data.decode("latin-1")
        assert fm.msgpack_restore(data)["w"].shape == (37, 11)
    if name == "mixed":  # `save_checkpoint` writes numpy scalars as arrays; Flax's own
        data = serialization.msgpack_serialize(copy.deepcopy(written[1]), in_place=True)
        got = fm.msgpack_restore(data)
        assert_trees_equal(got, serialization.msgpack_restore(data))
        assert got["bf16"].dtype == torch.bfloat16 and got["f8"].dtype == torch.float8_e4m3fn
        assert type(got["scalars"]["u8"]) is np.uint8
        assert got["python"]["complex"] == 1.5 - 2j


def test_encoder_matches_flax_bytes(written):
    """(b) The encoder writes Flax's bytes for the same tree, and for the
    tree it decoded."""
    _, tree, run_dir = written
    data = (run_dir / "checkpoint.msgpack").read_bytes()
    state_dict = serialization.to_state_dict(jax.device_get(tree))
    assert fm.msgpack_serialize(state_dict) == data
    assert fm.msgpack_serialize(fm.read_file(run_dir / "checkpoint.msgpack")) == data
    plain = tree if isinstance(tree, dict) else state_dict
    assert fm.msgpack_serialize(plain) == serialization.msgpack_serialize(
        copy.deepcopy(plain), in_place=True)


def test_dtype_without_counterpart_raises():
    """A dtype neither numpy nor torch has (JAX's `int4`) raises the
    format's error, naming it."""
    data = serialization.msgpack_serialize({"q": np.asarray([1, -2], ml_dtypes.int4)})
    with pytest.raises(fm.FlaxMsgpackError, match="int4"):
        fm.msgpack_restore(data)


@pytest.mark.parametrize("cut", [0, 1, 0.3, 0.999, "corrupt"])
def test_truncated_file_raises_and_falls_back_to_last(tmp_path, cut):
    """(a) A truncated or corrupt `checkpoint.msgpack` raises the one
    error `UNREADABLE` holds; reading the run directory takes
    `checkpoint_last.msgpack`."""
    tree = _train_state(0.0)
    jax_ckpt.save_checkpoint(tmp_path, tree, epoch=1)
    path = tmp_path / "checkpoint.msgpack"
    data = path.read_bytes()
    bad = (b"\xc1" + data[1:] if cut == "corrupt"
           else data[: cut if isinstance(cut, int) else int(len(data) * cut)])
    path.write_bytes(bad)
    with pytest.raises(fm.FlaxMsgpackError) as e:
        fm.read_file(path)
    assert isinstance(e.value, torch_load_model.UNREADABLE)
    back = torch_load_model.read_first(tmp_path, "checkpoint.msgpack", fm.read_file)
    assert_trees_equal(back, serialization.msgpack_restore(data))
    (tmp_path / "checkpoint_last.msgpack").write_bytes(bad)
    with pytest.raises(fm.FlaxMsgpackError):
        torch_load_model.read_first(tmp_path, "checkpoint.msgpack", fm.read_file)


# ------------------------------------------------------------ (c) the bridge

IMAGE = (120, 160)


def _pose_tree(backbone, coarse, seed):
    """Seeded values on the tree JAX's `PosePredictor.init` makes."""
    jdb, _ = mesh_dbs()
    model = JaxPosePredictor(JaxConfig(
        backbone=backbone, render_size=(32, 48), renderer="reference",
        predict_pose_update=not coarse, predict_rendered_views_logits=coarse))
    ids = jnp.zeros((1,), jnp.int32)
    K = jnp.asarray([[[150.0, 0, 80], [0, 150.0, 60], [0, 0, 1]]])
    TCO = jnp.eye(4)[None].at[:, 2, 3].set(0.5)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 3, *IMAGE)), K, ids,
                            TCO, jdb.render_assets(), jdb.batched(n_points=32).select(ids))
    return shapes, seeded_variables(shapes, seed)


def _port_pose_model(backbone, coarse):
    return PosePredictor(PosePredictorConfig(
        backbone=backbone, render_size=(32, 48), predict_pose_update=not coarse,
        predict_rendered_views_logits=coarse))


@pytest.mark.parametrize("backbone, coarse", [
    ("resnet34", False), ("resnet34", True), ("wide_resnet18", False), ("wide_resnet34", True),
    ("efficientnet_b3", False), ("flownet", False)])
def test_pose_bridge_both_ways_exact(backbone, coarse):
    """(c) Flax -> state dict -> Flax gives JAX's `init` tree back: its key
    order (sorted, as every jitted JAX tree), shapes, float32 and values;
    the port's model takes the state dict strictly."""
    shapes, variables = _pose_tree(backbone, coarse, seed=3)
    sd = wfj.pose_predictor_state_dict(variables)
    model = _port_pose_model(backbone, coarse)
    model.load_state_dict(sd)
    back = wfj.pose_predictor_variables(model.state_dict(), backbone)
    assert_trees_equal(back, variables)
    assert_trees_equal(wfj.model_variables(model), variables)
    assert [p for p, _ in _leaves(back)] == [p for p, _ in _leaves(jax.tree.map(
        lambda s: s, shapes))]
    assert ("batch_stats" in back) == ("batch_stats" in shapes)


@pytest.mark.parametrize("name", ["efficientnet_b0", "flownet_bn"])
def test_backbone_bridge_both_ways_exact(name):
    """(c) The backbones the predictor does not name: EfficientNet-B0 and
    FlowNetS with BatchNorm, through the predictor's table."""
    from happypose_tpu.models import backbones as jb

    jax_cls, kw = {"efficientnet_b0": (jb.EfficientNetB0, {}),
                   "flownet_bn": (jb.FlowNetS, {"use_batchnorm": True})}[name]
    shapes = jax.eval_shape(jax_cls(**kw).init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 6)))
    variables = seeded_variables(shapes, 4)
    sd = wfj.backbone_state_dict(variables["params"], variables["batch_stats"], "backbone.")
    back = wfj.pose_predictor_variables(sd, name.split("_bn")[0])
    assert_trees_equal(back, {c: {"backbone": variables[c]} for c in ("batch_stats", "params")})


def test_detector_bridge_both_ways_exact():
    """(c) The ResNet50-FPN detector: Flax -> state dict -> Flax exactly."""
    cfg = dict(n_classes=3, n_prototypes=8, fpn_channels=32, head_depth=2)
    shapes = jax.eval_shape(lambda k, x: jd.FCOSDetector(jd.DetectorConfig(**cfg)).init(
        k, x, train=False), jax.random.PRNGKey(0), jnp.zeros((1, 3, 64, 80)))
    variables = seeded_variables(shapes, 5)
    model = td.FCOSDetector(td.DetectorConfig(**cfg))
    model.load_state_dict(wfj.detector_state_dict(variables))
    assert_trees_equal(wfj.detector_variables(model.state_dict()), variables)
    assert_trees_equal(wfj.model_variables(model), variables)
    with pytest.raises(KeyError, match="no Flax counterpart.*extra"):
        wfj.detector_variables({**model.state_dict(), "extra.weight": torch.zeros(1)})


# -------------------------------------------- (d), (g) serving a run directory

CONFIG = {"model_type": "refiner", "backbone": "resnet34", "render_size": [64, 128],
          "bf16": False, "synth_set": "debug"}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The cut `megapose-RGB` (`tests/test_torch_pipeline.py`) with perturbed
    weights, written by JAX's `save_checkpoint` (the refiner as a TrainState
    with its optimizer, the coarse model as bare variables), served by JAX's
    `load_named_model(checkpoint_dirs=)` and by the port's; the port's
    models written back in JAX's format."""
    root = tmp_path_factory.mktemp("served")
    jdb, tdb = mesh_dbs()
    rgb, K, boxes, obj_ids = _frame(tdb)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_load_model.NAMED_MODELS, "megapose-RGB-test",
                   _small(jax_load_model.NAMED_MODELS["megapose-RGB"],
                          renderer="pallas_interpret"))
        mp.setitem(torch_load_model.NAMED_MODELS, "megapose-RGB-test",
                   _small(torch_load_model.NAMED_MODELS["megapose-RGB"]))
        fresh = jax_load_model.load_named_model("megapose-RGB-test", jdb, n_points=200)
        jax_dirs = {r: root / "jax" / r for r in ("refiner", "coarse")}
        refiner = jax.tree.map(jnp.asarray, perturb(fresh.refiner_vars, seed=11))
        jax_ckpt.save_checkpoint(jax_dirs["refiner"], jax_trainer.TrainState.create(
            refiner, jax_trainer.make_optimizer()), epoch=2, config=CONFIG)
        jax_ckpt.save_checkpoint(jax_dirs["coarse"], perturb(fresh.coarse_vars, seed=12),
                                 epoch=2, config={**CONFIG, "model_type": "coarse"})

        jax_est = jax_load_model.load_named_model("megapose-RGB-test", jdb, n_points=200,
                                                  checkpoint_dirs=jax_dirs)
        jax_res = jax_est.run_inference_pipeline(
            JaxObservation.from_numpy(rgb, K), JaxDetections.from_numpy(boxes, obj_ids))
        est = torch_load_model.load_named_model("megapose-RGB-test", tdb, n_points=200,
                                                checkpoint_dirs=jax_dirs, device="cpu")
        res = est.run_inference_pipeline(
            ObservationBatch.from_numpy(rgb, K, device="cpu"),
            DetectionBatch.from_numpy(boxes, obj_ids, device="cpu"))

        port_dirs = {r: root / "port" / r for r in ("refiner", "coarse")}
        for role, model in (("refiner", est.refiner_model), ("coarse", est.coarse_model)):
            torch_load_model.save_flax_run_dir(port_dirs[role], wfj.model_variables(model),
                                               json.loads((jax_dirs[role] / "config.json")
                                                          .read_text()))
        jax_from_port = jax_load_model.load_named_model("megapose-RGB-test", jdb, n_points=200,
                                                        checkpoint_dirs=port_dirs)
    return dict(jax_dirs=jax_dirs, port_dirs=port_dirs, jax_est=jax_est, est=est,
                jax_from_port=jax_from_port,
                jax_res=jax.tree.map(np.asarray, jax_res["final"]),
                res={f.name: getattr(res["final"], f.name).numpy()
                     for f in dataclasses.fields(res["final"])})


def test_port_serves_a_jax_run_directory(served):
    """(d) The same final poses as JAX's `load_named_model` on the same
    directories, to the pipeline test's tolerances; the weights the port
    runs are the file's."""
    j, t_ = served["jax_res"], served["res"]
    assert t_["valid"].sum() == j.valid.sum() == 2
    jo = _rows({k: getattr(j, k)[j.valid] for k in ("instance_ids", "obj_ids", "hypothesis_ids")})
    to = _rows({k: t_[k][t_["valid"]] for k in ("instance_ids", "obj_ids", "hypothesis_ids")})
    jp, tp = j.poses[j.valid][jo], t_["poses"][t_["valid"]][to]
    assert np.isfinite(tp).all()
    assert (j.hypothesis_ids[j.valid][jo] == t_["hypothesis_ids"][t_["valid"]][to]).all()
    assert np.abs(tp[:, :3, 3] - jp[:, :3, 3]).max() < 1e-5
    dR = np.linalg.norm((tp[:, :3, :3] - jp[:, :3, :3]).astype(np.float64), axis=(1, 2))
    assert (2 * np.arcsin(np.clip(dR / (2 * np.sqrt(2)), 0, 1))).max() < 1e-5
    np.testing.assert_allclose(t_["pose_logits"][t_["valid"]][to], j.pose_logits[j.valid][jo],
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    sd = served["est"].refiner_model.state_dict()
    flax = serialization.msgpack_restore(
        (served["jax_dirs"]["refiner"] / "checkpoint.msgpack").read_bytes())
    assert np.array_equal(sd["pose_fc.weight"].numpy(), flax["params"]["pose_fc"]["kernel"].T)
    spec = torch_load_model.spec_from_checkpoints(served["jax_dirs"])
    assert spec.refiner_cfg.backbone == "resnet34" and spec.coarse_cfg.render_size == (64, 128)


@pytest.mark.parametrize("role", ["refiner", "coarse"])
def test_jax_serves_a_run_directory_the_port_wrote(served, role):
    """(g) A directory the port writes in JAX's format is read by JAX's
    `load_named_model` into the variables JAX read from its own directory,
    bit for bit: JAX's pipeline then gives the poses (d) holds the port's
    to. The port reads it back to its own state dict."""
    got = getattr(served["jax_from_port"], f"{role}_vars")
    ref = getattr(served["jax_est"], f"{role}_vars")
    assert_trees_equal(jax.tree.map(np.asarray, dict(got)), jax.tree.map(np.asarray, dict(ref)))
    back = torch_load_model.read_state_dict(served["port_dirs"][role])
    model = served["est"].refiner_model if role == "refiner" else served["est"].coarse_model
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v), k


def test_truncated_jax_run_directory_serves_its_last_copy(served, tmp_path):
    """A corrupt `checkpoint.msgpack` in a pose run directory: the port
    reads `checkpoint_last.msgpack`; without one it raises, never seeds."""
    r = tmp_path / "refiner"
    shutil.copytree(served["jax_dirs"]["refiner"], r)
    good = torch_load_model.read_state_dict(r)
    data = (r / "checkpoint.msgpack").read_bytes()
    (r / "checkpoint.msgpack").write_bytes(data[: len(data) // 2])
    back = torch_load_model.read_state_dict(r)
    assert all(torch.equal(good[k], back[k]) for k in good)
    (r / "checkpoint_last.msgpack").unlink()
    with pytest.raises(fm.FlaxMsgpackError):
        torch_load_model.read_state_dict(r)


# --------------------------------------------------------- (e) the detector

DET_CFG = {"fpn_channels": 32, "image_size": [120, 160], "lr": 1e-4}


@pytest.fixture(scope="module")
def detectors(tmp_path_factory):
    """A detector run directory as JAX's `run_detector_training` writes it
    (params, batch stats, `optax.adam`'s state), JAX's `load_detector` and
    the port's on it, and on the port's own writing of it."""
    root = tmp_path_factory.mktemp("det")
    model = jd.FCOSDetector(jd.DetectorConfig(n_classes=2, fpn_channels=32))
    images = np.random.RandomState(0).rand(2, 3, 120, 160).astype(np.float32)
    variables = perturb(jax.jit(lambda k, x: model.init(k, x, train=False))(
        jax.random.PRNGKey(0), jnp.asarray(images[:1])), seed=5)
    params = jax.tree.map(jnp.asarray, variables["params"])
    jax_ckpt.save_checkpoint(root / "jax", {
        "params": params, "batch_stats": variables["batch_stats"],
        "opt_state": optax.adam(1e-4).init(params)}, epoch=1, config=DET_CFG)
    jdet = jax_load_model.load_detector(root / "jax", 2)
    det = torch_load_model.load_detector(root / "jax", 2, device="cpu")
    torch_load_model.save_flax_run_dir(root / "port", wfj.model_variables(det.model), DET_CFG)
    return dict(root=root, images=images, jdet=jdet, det=det,
                jdet_from_port=jax_load_model.load_detector(root / "port", 2))


def test_port_detects_from_a_jax_run_directory(detectors):
    """(e) JAX's `load_detector` and the port's on the same directory: the
    same rows, boxes to 1e-3 px, scores to 1e-4 relative."""
    images = detectors["images"]
    K = np.tile(np.asarray([[150.0, 0, 80], [0, 150.0, 60], [0, 0, 1]], np.float32), (2, 1, 1))
    assert detectors["det"].image_size == detectors["jdet"].image_size == (120, 160)
    jdet, _ = detectors["jdet"].get_detections(
        JaxObservation(rgb=jnp.asarray(images), K=jnp.asarray(K)), detection_th=0.0)
    det, _ = detectors["det"].get_detections(
        ObservationBatch(rgb=torch.from_numpy(images), K=torch.from_numpy(K)), detection_th=0.0)
    assert det.n_rows == jdet.n_rows > 0
    for f in ("obj_ids", "batch_im_ids", "instance_ids"):
        np.testing.assert_array_equal(getattr(det, f).numpy(), np.asarray(getattr(jdet, f)))
    np.testing.assert_allclose(det.boxes.numpy(), np.asarray(jdet.boxes), atol=1e-3, rtol=0)
    np.testing.assert_allclose(det.scores.numpy(), np.asarray(jdet.scores), rtol=1e-4, atol=0)


def test_jax_detector_reads_the_port_writing(detectors):
    """(g) JAX's `load_detector` on the directory the port wrote: its
    variables bit for bit."""
    assert_trees_equal(jax.tree.map(np.asarray, detectors["jdet_from_port"].variables),
                       jax.tree.map(np.asarray, detectors["jdet"].variables))


def test_detector_optimizer_state_resumes(detectors):
    """A JAX detector run's `optax.adam` state (count 0, zero moments)
    loads into the port's detector trainer and writes back as JAX's
    layout."""
    from happypose_tpu_torch.scripts.run_detector_training import make_detector_trainer

    trainer = make_detector_trainer(2, 32, 1e-4, torch.device("cpu"))
    state, epoch = ckpt.load_checkpoint(detectors["root"] / "jax", trainer.state)
    assert epoch == 1 and state.step == 0 and state.optimizer.count == 0
    for k, v in detectors["det"].model.state_dict().items():
        assert torch.equal(state.model.state_dict()[k], v), k
    ref = serialization.msgpack_restore(
        (detectors["root"] / "jax" / "checkpoint.msgpack").read_bytes())
    assert_trees_equal(ckpt.flax_train_state(state), ref)


# --------------------------------------------------- (f) a JAX TrainState

RENDER = (60, 80)


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """JAX trains the refiner (WideResNet18, 60x80 renders) two steps, the
    second on a NaN image (skipped), writes its TrainState, and takes a
    third step; the port loads the directory and takes the same third
    step on the same batch and draws."""
    root = tmp_path_factory.mktemp("resumed")
    jdb, tdb = mesh_dbs()
    jmodel = JaxPosePredictor(JaxConfig(backbone="wide_resnet18", render_size=RENDER,
                                        renderer="reference"))
    j_assets, j_meshes = jdb.render_assets(), jdb.batched(n_points=128)
    b1, b3 = _batch(jdb, 2, 37), _batch(jdb, 2, 41)
    b2 = dict(b1, images=np.full_like(b1["images"], np.nan))
    jb = lambda b: jax_fl.PoseTrainingBatch(**{k: jnp.asarray(v) for k, v in b.items()})  # noqa
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), *(jnp.asarray(b1[k]) for k in (
        "images", "K", "obj_ids", "TCO_gt")), j_assets, j_meshes.select(jnp.asarray(b1["obj_ids"])))
    variables = jax.tree.map(jnp.asarray, perturb(variables, seed=21))
    tx = jax_trainer.make_optimizer(lr=1e-3, n_warmup_steps=4)
    step = jax_trainer.make_train_step(
        jax_fl.make_refiner_loss_fn(jmodel, j_assets, j_meshes, n_iterations=2), tx, donate=False)
    state = jax_trainer.TrainState.create(variables, tx)
    state, m1 = step(state, jb(b1), jax.random.PRNGKey(1))
    state, m2 = step(state, jb(b2), jax.random.PRNGKey(2))
    assert float(m1["skipped_nonfinite"]) == 0 and float(m2["skipped_nonfinite"]) == 1
    jax_ckpt.save_checkpoint(root / "refiner", state, epoch=1,
                             config={**CONFIG, "backbone": "wide_resnet18",
                                     "render_size": list(RENDER)})
    _, m3 = step(state, jb(b3), jax.random.PRNGKey(3))

    model = PosePredictor(PosePredictorConfig(backbone="wide_resnet18", render_size=RENDER))
    port = TrainState(model, make_optimizer(model.parameters(), lr=1e-3, n_warmup_steps=4))
    port, epoch = ckpt.load_checkpoint(root / "refiner", port)
    written = {k: v.clone() for k, v in model.state_dict().items()}
    adam = copy.deepcopy(port.optimizer.adam.state_dict()["state"])
    counts = (port.step, port.optimizer.count)
    loss_fn = make_refiner_loss_fn(model, tdb.render_assets(device="cpu"),
                                   tdb.batched(n_points=128, device="cpu"), n_iterations=2)
    metrics = make_train_step(loss_fn)(port, _torch_batch(b3), jax_noise_draws(
        jax.random.PRNGKey(3), 2))
    return dict(root=root, state=jax.device_get(state), epoch=epoch, written=written, adam=adam,
                counts=counts, port=port, loss=metrics["loss"], jax_loss=float(m3["loss"]))


def test_jax_train_state_restores_exactly(resumed):
    """(f) `count` (1: the skipped step applied nothing), `mu`, `nu`, the
    schedule's count and `step` (2) exactly after transposition; the
    weights and BatchNorm statistics too."""
    state = resumed["state"]
    adam = state.opt_state[1][0]
    assert int(state.step) == 2 and int(adam.count) == 1 == int(state.opt_state[1][1].count)
    assert resumed["counts"] == (2, 1) and resumed["epoch"] == 1
    sd = wfj.pose_predictor_state_dict({"params": state.params, "batch_stats": state.batch_stats})
    for k, v in sd.items():
        assert torch.equal(resumed["written"][k], v), k
    names = [n for n, _ in resumed["port"].model.named_parameters()]
    for key, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        moments = wfj.pose_predictor_state_dict({"params": tree, "batch_stats": state.batch_stats})
        for i, n in enumerate(names):
            assert torch.equal(resumed["adam"][i][key], moments[n]), (key, n)
            assert float(resumed["adam"][i]["step"]) == 1.0
    assert float(resumed["adam"][0]["exp_avg"].abs().max()) > 0  # the applied step moved them


def test_resumed_step_loss_matches_jax(resumed):
    """(f) The first step after the resume: the port's loss is JAX's to
    1e-5 relative; the step applies, so the count moves to 2 and the step
    to 3."""
    np.testing.assert_allclose(resumed["loss"], resumed["jax_loss"], rtol=1e-5)
    assert resumed["port"].optimizer.count == 2 and resumed["port"].step == 3


def test_port_train_state_writes_jax_layout(resumed, tmp_path):
    """The other direction: the restored state written as JAX's TrainState
    is the file JAX wrote (same bytes), and JAX's `load_checkpoint` restores
    it into its own TrainState."""
    model = PosePredictor(PosePredictorConfig(backbone="wide_resnet18", render_size=RENDER))
    port = TrainState(model, make_optimizer(model.parameters(), lr=1e-3, n_warmup_steps=4))
    ckpt.load_checkpoint(resumed["root"] / "refiner", port)
    ckpt.save_flax_checkpoint(tmp_path, port, epoch=1, config=CONFIG)
    ours = (tmp_path / "checkpoint.msgpack").read_bytes()
    assert ours == (resumed["root"] / "refiner" / "checkpoint.msgpack").read_bytes()
    assert (tmp_path / "checkpoint_last.msgpack").read_bytes() == ours
    back, epoch = jax_ckpt.load_checkpoint(tmp_path, resumed["state"])
    assert epoch == 1 and int(back.step) == 2
