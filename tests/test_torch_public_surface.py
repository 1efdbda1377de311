"""The port's public surface is the JAX package's: the lib3d functions and
grid sources that were missing, the subpackages' re-exports, the
detector's `compute_dtype` and `bn_axis_name`, and an `ast` comparison of
every module's public names.

Tolerances: the lib3d functions 1e-5 absolute + 1e-5 relative (float32
results of a few operations; the crops, bilinear samples of [0, 1] images,
1e-5 absolute as `tests/test_torch_crop_segment.py`); the grids and the
covering radius exactly (the same numpy code). The bfloat16 detector: see
its test.
"""

import ast
import dataclasses
import importlib
import inspect
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import happypose_tpu
import happypose_tpu.lib3d.camera as jcam
import happypose_tpu.lib3d.cropping as jcrop
import happypose_tpu.lib3d.pose_update as jupd
import happypose_tpu.lib3d.so3_grid as jgrid
import happypose_tpu_torch
import happypose_tpu_torch.lib3d.camera as tcam
import happypose_tpu_torch.lib3d.cropping as tcrop
import happypose_tpu_torch.lib3d.pose_update as tupd
import happypose_tpu_torch.lib3d.so3_grid as tgrid
from happypose_tpu.models import detector as jd
from happypose_tpu_torch.models import detector as td
from happypose_tpu_torch.models.backbones import BatchNorm2d
from happypose_tpu_torch.utils.weights_from_jax import detector_state_dict
from test_torch_models import perturb

torch.set_num_threads(2)

B = 4


def _poses(rs, n=B, z=0.5):
    T = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    T[:, :3, :3] = Rotation.random(n, random_state=rs).as_matrix()
    T[:, :3, 3] = rs.randn(n, 3) * 0.03 + [0, 0, z]
    return T


def _K(n=B, h=120, w=160):
    return np.tile(np.asarray([[150.0, 0, w / 2], [0, 152.0, h / 2], [0, 0, 1]], np.float32),
                   (n, 1, 1))


def _crop_inputs(rs):
    images = rs.rand(B, 3, 120, 160).astype(np.float32)
    xy = rs.rand(B, 2).astype(np.float32) * [80, 50] + 20
    obs_boxes = np.concatenate([xy, xy + rs.rand(B, 2).astype(np.float32) * 30 + 15], -1)
    verts = (rs.randn(B, 30, 3) * 0.03).astype(np.float32)
    mask = rs.rand(B, 30) > 0.2
    return images, obs_boxes, _K(), _poses(rs), verts, mask


def case_boxes_from_uv(rs):
    uv = rs.randn(B, 17, 2).astype(np.float32) * 50
    return jcam.boxes_from_uv(jnp.asarray(uv)), tcam.boxes_from_uv(torch.from_numpy(uv))


def case_cropresize_backtransform_points2d(rs):
    args = (rs.rand(B, 2) * 100 + 50, rs.rand(B, 4) * 200, rs.rand(B, 2) * 300 + 100,
            rs.rand(B, 9, 2) * 200)
    args = [a.astype(np.float32) for a in args]
    return (jcam.cropresize_backtransform_points2d(*map(jnp.asarray, args)),
            tcam.cropresize_backtransform_points2d(*map(torch.from_numpy, args)))


def case_deepim_crops(rs, masked=False):
    images, obs_boxes, K, TCO, verts, mask = _crop_inputs(rs)
    kw = dict(output_size=(48, 64), lamb=1.4)
    j = jcrop.deepim_crops(*map(jnp.asarray, (images, obs_boxes, K, TCO, verts)),
                           points_mask=jnp.asarray(mask) if masked else None, **kw)
    t = tcrop.deepim_crops(*map(torch.from_numpy, (images, obs_boxes, K, TCO, verts)),
                           points_mask=torch.from_numpy(mask) if masked else None, **kw)
    return j, t


def case_deepim_crops_masked(rs):
    return case_deepim_crops(rs, masked=True)


def case_deepim_crops_robust(rs, masked=False, return_crops=True):
    images, obs_boxes, K, TCO, verts, mask = _crop_inputs(rs)
    tCR = (TCO[:, :3, 3] + rs.randn(B, 3).astype(np.float32) * 0.01).astype(np.float32)
    kw = dict(output_size=(48, 64), return_crops=return_crops)
    j = jcrop.deepim_crops_robust(*map(jnp.asarray, (images, obs_boxes, K, TCO, tCR, verts)),
                                  points_mask=jnp.asarray(mask) if masked else None, **kw)
    t = tcrop.deepim_crops_robust(*map(torch.from_numpy, (images, obs_boxes, K, TCO, tCR, verts)),
                                  points_mask=torch.from_numpy(mask) if masked else None, **kw)
    if not return_crops:
        assert j[1] is None and t[1] is None
        return j[0], t[0]
    return j, t


def case_deepim_crops_robust_masked(rs):
    return case_deepim_crops_robust(rs, masked=True)


def case_deepim_crops_robust_boxes_only(rs):
    return case_deepim_crops_robust(rs, return_crops=False)


def case_apply_imagespace_predictions(rs):
    TCO, K = _poses(rs), _K()
    v = np.concatenate([rs.randn(B, 2) * 5, 1 + rs.randn(B, 1) * 0.05], -1).astype(np.float32)
    dR = Rotation.from_rotvec(rs.randn(B, 3) * 0.1).as_matrix().astype(np.float32)
    return (jupd.apply_imagespace_predictions(*map(jnp.asarray, (TCO, K, v, dR))),
            tupd.apply_imagespace_predictions(*map(torch.from_numpy, (TCO, K, v, dR))))


CASES = {name[5:]: fn for name, fn in dict(globals()).items() if name.startswith("case_")}


def _flat(x):
    return [x] if not isinstance(x, (tuple, list)) else [y for v in x for y in _flat(v)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_lib3d_matches_jax(name):
    j, t = CASES[name](np.random.RandomState(0))
    for a, b in zip(_flat(j), _flat(t), strict=True):
        a = np.asarray(a)
        assert b.shape == a.shape and np.isfinite(a).all()
        np.testing.assert_allclose(b.numpy(), a, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("resolution,source", [
    (72, "qua"), (576, "qua"), (576, "auto"), (100, "auto"), (576, "super_fibonacci"),
    (512, "auto")])
def test_so3_grid_sources_match_jax(resolution, source):
    """`source=` picks the shipped `.qua` file or the super-Fibonacci spiral
    exactly as JAX's does (`tests/test_lib3d.py:358-390`): the same
    quaternions and rotation matrices, bit for bit."""
    np.testing.assert_array_equal(tgrid.load_SO3_quats(resolution, source),
                                  jgrid.load_SO3_quats(resolution, source))
    np.testing.assert_array_equal(tgrid.load_SO3_grid(resolution, source=source),
                                  jgrid.load_SO3_grid(resolution, source=source))


def test_so3_grid_unknown_source_raises():
    for grid in (jgrid, tgrid):
        with pytest.raises(ValueError, match="unknown SO"):
            grid.load_SO3_quats(73, "lattice")


def test_covering_radius_matches_jax():
    """The Monte-Carlo covering radius (seeded probes) of both 576 grids
    equals JAX's, and the generated grid covers SO(3) within 15% of the
    shipped one, as JAX's test asks."""
    r = {}
    for source in ("qua", "super_fibonacci"):
        q = tgrid.load_SO3_quats(576, source)
        r[source] = tgrid.covering_radius(q, n_probes=2048)
        assert r[source] == jgrid.covering_radius(q, n_probes=2048)
    assert r["super_fibonacci"] < 1.15 * r["qua"]


SUBPACKAGES = ["lib3d", "meshes", "datasets", "inference", "evaluation"]


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackages_reexport_the_jax_names(sub):
    """`from happypose_tpu_torch.<sub> import X` works for every X that
    `from happypose_tpu.<sub> import X` does, and X is the port's own."""
    jax_pkg = importlib.import_module(f"happypose_tpu.{sub}")
    port_pkg = importlib.import_module(f"happypose_tpu_torch.{sub}")
    assert sorted(port_pkg.__all__) == sorted(jax_pkg.__all__)
    # JAX's lib3d lists its submodules too (`dir()`): 33 functions and classes
    objects = [getattr(port_pkg, n) for n in port_pkg.__all__]
    objects = [o for o in objects if not inspect.ismodule(o)]
    assert len(objects) == {"lib3d": 33, "meshes": 4, "datasets": 6, "inference": 5,
                            "evaluation": 5}[sub]
    for name in port_pkg.__all__:
        obj = getattr(port_pkg, name)
        where = obj.__name__ if inspect.ismodule(obj) else obj.__module__
        assert where.startswith("happypose_tpu_torch."), name


# JAX names without a namesake in the port, each with its counterpart: the
# Pallas module (ported as `ops/rasterizer_fused.py` + `csrc/raster_fused.cu`),
# a JAX PRNG key (`utils/random.py::generator_for`), the native PLY decoder's
# loaders (in `csrc/fastply.py`), and the grid files' package (read by path).
NOT_PORTED = {
    "ops/rasterizer_pallas.py": None,
    "utils/random.py": {"key_for"},
    "csrc/__init__.py": {"get_fastply", "load_ply_native", "Optional"},
    "data/__init__.py": None,
}


def _public_names(path: Path, jax_side: bool) -> set:
    """Module-level public names: functions, classes and assignments (an
    alias of `typing.Any` is an annotation, not API), and on the port's
    side also every imported name (a re-export)."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            if isinstance(node.value, ast.Name) and node.value.id == "Any":
                continue
            names |= {t.id for t in targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.ImportFrom) and (not jax_side or path.name == "__init__.py"):
            names |= {a.asname or a.name for a in node.names}
    return {n for n in names if not n.startswith("_")}


def test_every_public_jax_name_has_a_namesake_in_the_port():
    jax_root = Path(happypose_tpu.__file__).parent
    port_root = Path(happypose_tpu_torch.__file__).parent
    missing = {}
    for path in sorted(jax_root.rglob("*.py")):
        rel = path.relative_to(jax_root).as_posix()
        if rel in NOT_PORTED and NOT_PORTED[rel] is None:
            continue
        port = port_root / rel
        have = _public_names(port, jax_side=False) if port.exists() else set()
        gap = _public_names(path, jax_side=True) - have - (NOT_PORTED.get(rel) or set())
        if gap:
            missing[rel] = sorted(gap)
    assert not missing, missing


# ------------------------------------------------------------ the detector

H, W = 120, 160
CFG = dict(n_classes=2, n_prototypes=8, fpn_channels=32, head_depth=1)


@pytest.fixture(scope="module")
def bf16_detectors():
    images = np.random.RandomState(0).rand(2, 3, H, W).astype(np.float32)
    out = {}
    variables = None
    for dtype in ("float32", "bfloat16"):
        jax_model = jd.FCOSDetector(jd.DetectorConfig(**CFG, compute_dtype=dtype))
        if variables is None:
            variables = perturb(jax.jit(lambda k, x: jax_model.init(k, x, train=False))(
                jax.random.PRNGKey(0), jnp.asarray(images[:1])), seed=5)
        ref = jax.jit(lambda v, x: jax_model.apply(v, x, train=False))(
            variables, jnp.asarray(images))
        model = td.FCOSDetector(td.DetectorConfig(**CFG, compute_dtype=dtype)).eval()
        model.load_state_dict(detector_state_dict(variables))
        with torch.no_grad():
            out[dtype] = (jax.tree.map(np.asarray, ref), model(torch.from_numpy(images)))
    return out


def _dev(a, b, scale, mean):
    """(max |a - b| / scale, mean |a - b| / mean)."""
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return np.asarray([d.max() / scale, d.mean() / mean])


@pytest.mark.parametrize("field", ["cls_logits", "box_reg", "centerness", "mask_coeffs",
                                   "prototypes"])
def test_bfloat16_detector_close_to_jax(bf16_detectors, field):
    """`DetectorConfig.compute_dtype="bfloat16"` runs the network in
    bfloat16 and returns float32 outputs, as JAX's. bfloat16 keeps 8 bits
    of mantissa and the frameworks round at other places (Flax casts every
    layer's output, autocast the convolutions' inputs), so the two bfloat16
    runs differ as much as either differs from float32: the port's lies
    within 2x JAX's own bfloat16-to-float32 deviation of JAX's bfloat16 run
    and of its own float32 run, in the largest and the mean deviation
    (measured 0.6-1.5x; JAX's deviation is 0.8-5.5% of the largest value,
    0.25-1.5% of the mean), and it differs from float32."""
    ref16, out16 = bf16_detectors["bfloat16"]
    ref32, out32 = bf16_detectors["float32"]
    r16, r32 = getattr(ref16, field), getattr(ref32, field)
    t16, t32 = getattr(out16, field), getattr(out32, field)
    assert t16.dtype == torch.float32 and r16.dtype == np.float32 and t16.shape == r16.shape
    scale, mean = np.abs(r32).max(), np.abs(r32).mean()
    jax_dev = _dev(r16, r32, scale, mean)
    assert (jax_dev < [0.1, 0.03]).all(), jax_dev
    assert (_dev(t16, r16, scale, mean) <= 2 * jax_dev).all()
    assert (_dev(t16, t32, scale, mean) <= 2 * jax_dev).all()
    assert not torch.equal(t16, t32)
    for f in ("locations", "level_ids"):
        np.testing.assert_array_equal(getattr(out16, f).numpy(), getattr(ref16, f))


def test_detector_bn_axis_name_names_every_batchnorm():
    model = td.FCOSDetector(td.DetectorConfig(**CFG, bn_axis_name="dp"))
    bns = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    assert len(bns) == 53 and all(m.axis_name == "dp" and m.group is None for m in bns)
    assert all(m.axis_name is None for m in td.FCOSDetector(td.DetectorConfig(**CFG)).modules()
               if isinstance(m, BatchNorm2d))


# ------------------------------------------------- parameters, by `ast`

# A parameter of a JAX function, method or dataclass (or Flax module)
# field that the port names otherwise or drops, by its JAX idiom. Each
# entry: {JAX parameter: the port's name, or None where it has none},
# the port's own parameters that may come before JAX's in its positional
# order, and the reason.
_KEY = "JAX draws inside the function from `key`; the port takes the finished draws"
PARAMS = {
    "datasets/augmentations.py::rgb_jitter": (
        dict(key=None, p_apply=None, brightness=None, contrast=None, saturation=None,
             sharpness=None), {"draws"},
        _KEY + " (`sample_rgb_jitter(generator, n, p_apply, brightness, ...)`)"),
    "datasets/augmentations.py::background_replace": (
        dict(key=None, p_apply=None), {"draws"},
        _KEY + " (`sample_background_replace(generator, ..., p_apply)`)"),
    "datasets/augmentations.py::depth_augment": (
        dict(key=None, ellipse_dropout_rate=None), {"draws"},
        _KEY + " (`sample_depth_augment(generator, ..., ellipse_dropout_rate)`)"),
    "datasets/scene_record.py::record_scene_batch": (
        dict(key="noise", renderer=None), set(),
        _KEY + " (the sensor noise); the port has one renderer (ROADMAP, not to port)"),
    "datasets/scene_record.py::BatchedSceneRecorder": (
        dict(renderer=None), set(), "the port has one renderer (ROADMAP, not to port)"),
    "inference/detector.py::Detector": (
        dict(variables=None), set(),
        "Flax `variables` live apart from the module; a torch module holds its weights"),
    "inference/icp_refiner.py::icp_point_to_plane": (
        dict(n_points=None), set(),
        "unused in JAX: a `static_argnames` entry of its jit (ROADMAP, not to port)"),
    "meshes/database.py::MeshDataBase.batched": (
        dict(seed=None), set(),
        "unused in JAX, which deletes it on entry: the subsample is deterministic"),
    "inference/icp_refiner.py::ICPRefiner.refine": (
        dict(key="generator"), set(), "a JAX PRNG key becomes a `torch.Generator`"),
    "inference/teaser_refiner.py::TeaserRefiner.refine": (
        dict(key="generator"), set(), "a JAX PRNG key becomes a `torch.Generator`"),
    "inference/teaser_refiner.py::farthest_point_sample": (
        dict(key="generator"), set(), "a JAX PRNG key becomes a `torch.Generator`"),
    "lib3d/transforms.py::add_pose_noise": (
        dict(key="generator"), set(), "a JAX PRNG key becomes a `torch.Generator`"),
    "training/synth_data.py::random_rotations": (
        dict(key="generator"), set(), "a JAX PRNG key becomes a `torch.Generator`"),
    "training/synth_data.py::make_synth_batch": (
        dict(rng=None, n_objects=None, batch_size=None, resolution=None, z_range=None,
             xy_extent=None, renderer=None, force_obj_ids=None), {"draws"},
        _KEY + " (`sample_synth_scenes(generator, n_objects, batch_size, resolution, ...)`); "
        "one renderer"),
    "training/forward_loss.py::sample_grid_hypotheses": (
        dict(rng=None, n_hypotheses=None, euler_deg_std=None, trans_std=None), {"draws"},
        _KEY + " (the hypotheses' grid indices and noise)"),
    "models/pose_predictor.py::PosePredictorConfig": (
        dict(renderer=None), set(), "the port has one renderer (ROADMAP, not to port)"),
    "ops/scene_renderer.py::render_scenes": (
        dict(renderer=None), set(), "the port has one renderer (ROADMAP, not to port)"),
    "parallel/collectives.py::reduce_dict": (
        {}, {"mesh"},
        "a JAX axis name resolves inside `shard_map`; a process group needs the `DeviceMesh`"),
    "training/trainer.py::make_optimizer": (
        {}, {"params"}, "`torch.optim` binds the parameters when it is made, optax does not"),
    "training/trainer.py::make_train_step": (
        dict(tx=None, donate=None), set(),
        "the step reads the torch optimizer from its `TrainState`, not an optax `tx`; "
        "`donate` is XLA's buffer donation"),
    "utils/checkpoint.py::load_checkpoint": (
        dict(target="state"), set(),
        "a Flax target tree to restore into becomes the port's `TrainState` to load into"),
    "utils/load_model.py::load_named_model": (
        dict(rng_seed="seed"), set(),
        "the seed of the weights' `torch.Generator`, where JAX seeds a PRNG key"),
    "utils/load_model.py::load_detector": (
        dict(run_dir="cfg"), set(), "takes a run directory, as JAX's, or a `DetectorConfig`"),
    "utils/resources.py::get_device_memory": (
        dict(device_index="device"), set(), "a torch device; an index names the card, as in JAX"),
}
# whole methods of JAX idioms
NOT_PORTED_METHODS = {
    "__call__": "Flax's `__call__`: the port's modules run through `forward`",
    "setup": "Flax's `setup`: the port's modules build their layers in `__init__`",
    "tree_flatten": "pytree registration (ROADMAP, not to port)",
    "tree_unflatten": "pytree registration (ROADMAP, not to port)",
    "create": "`TrainState.create` over optax; the port's `TrainState` is a dataclass",
}
# Flax module fields: the compute dtype (the port's modules run under
# `torch.autocast`) and the BatchNorm axis (`set_bn_axis_name`); a torch
# layer takes its input channels first, which Flax infers
FLAX_FIELDS = {"dtype": None, "bn_axis_name": None}
TORCH_INPUT_CHANNELS = {"inplanes", "in_ch", "n_inputs"}


def _decorators(node):
    return {getattr(d.func if isinstance(d, ast.Call) else d, "attr", None)
            or getattr(d.func if isinstance(d, ast.Call) else d, "id", None)
            for d in node.decorator_list}


def _params(fn):
    """(positional parameter names, keyword-only names, has **kwargs)."""
    a = fn.args
    pos = [x.arg for x in a.posonlyargs + a.args]
    if pos and pos[0] in ("self", "cls"):
        pos = pos[1:]
    return pos, [x.arg for x in a.kwonlyargs], a.kwarg is not None


def _signatures(path: Path) -> dict:
    """{name: (positional, keyword-only, **kwargs, is a Flax module)} of a
    module's public functions, of its public classes (a dataclass's,
    NamedTuple's or Flax module's fields, else `__init__`'s parameters),
    and of their public methods and `__call__`."""
    out = {}
    tree = ast.parse(path.read_text())
    uses_flax = any(isinstance(n, (ast.Import, ast.ImportFrom)) and "flax" in ast.unparse(n)
                    for n in tree.body)
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and not node.name.startswith("_"):
            out[node.name] = (*_params(node), False)
        if not isinstance(node, ast.ClassDef) or node.name.startswith("_"):
            continue
        bases = {getattr(b, "attr", None) or getattr(b, "id", None) for b in node.bases}
        flax = uses_flax and "Module" in bases
        fields = [s.target.id for s in node.body
                  if isinstance(s, ast.AnnAssign) and isinstance(s.target, ast.Name)
                  and not s.target.id.startswith("_")]
        methods = {s.name: s for s in node.body if isinstance(s, ast.FunctionDef)}
        if "dataclass" in _decorators(node) or "NamedTuple" in bases or flax:
            out[node.name] = (fields, [], False, flax)
        elif "__init__" in methods:
            out[node.name] = (*_params(methods["__init__"]), False)
        for name, fn in methods.items():
            public = not name.startswith("_") or name == "__call__"  # `__init__`: the class
            if public and "property" not in _decorators(fn):
                out[f"{node.name}.{name}"] = (*_params(fn), flax)
    return out


def test_every_jax_parameter_has_its_namesake_in_the_port():
    """For every public function, method and class of the JAX package, the
    port's namesake takes each of its parameters (dataclass and Flax
    fields included) by the same name, and JAX's positional parameters
    come first in the port's positional order, in JAX's order, so that a
    call written for JAX means the same in the port. `PARAMS`,
    `NOT_PORTED_METHODS` and `FLAX_FIELDS` list the JAX idioms with their
    reasons; the `*_jit` entry points are CUDA graphs with JAX's
    signatures (`utils/cuda_graphs.py`), held like every other name."""
    jax_root = Path(happypose_tpu.__file__).parent
    port_root = Path(happypose_tpu_torch.__file__).parent
    faults, used = {}, set()
    for path in sorted(jax_root.rglob("*.py")):
        rel = path.relative_to(jax_root).as_posix()
        if rel in NOT_PORTED and NOT_PORTED[rel] is None:
            continue
        port = _signatures(port_root / rel) if (port_root / rel).exists() else {}
        for name, (jpos, jkw, _, flax) in _signatures(path).items():
            method = name.split(".")[-1]
            if (name in (NOT_PORTED.get(rel) or ())
                    or "." in name and method in NOT_PORTED_METHODS):
                continue
            key = f"{rel}::{name}"
            if name not in port:
                faults[key] = "missing"
                continue
            renames, port_only, _ = PARAMS.get(key, ({}, set(), ""))
            used.add(key) if key in PARAMS else None
            if flax:
                renames, port_only = {**FLAX_FIELDS, **renames}, port_only | TORCH_INPUT_CHANNELS
            jpos = [renames.get(p, p) for p in jpos if renames.get(p, p) is not None]
            jkw = [renames.get(p, p) for p in jkw if renames.get(p, p) is not None]
            ppos, pkw, pvar, _ = port[name]
            absent = [p for p in jpos + jkw if p not in ppos + pkw and not pvar]
            order = [p for p in ppos if p not in port_only][: len(jpos)]
            if absent or order != jpos:
                faults[key] = {"absent": absent, "jax": jpos, "port": order}
    assert not faults, faults
    assert used == set(PARAMS), set(PARAMS) - used  # no stale entry
    assert all(reason for _, _, reason in PARAMS.values())


# ------------------------------------------------- the repairs, against JAX


def test_get_K_crop_resize_positional_call_matches_jax():
    """JAX's positional call (K, boxes, orig_size, crop_resize): the port
    takes `orig_size` in the same place and, as JAX, does not use it."""
    rs = np.random.RandomState(0)
    xy = rs.rand(B, 2).astype(np.float32) * 200
    boxes = np.concatenate([xy, xy + rs.rand(B, 2).astype(np.float32) * 150 + 20], -1)
    j = jcam.get_K_crop_resize(jnp.asarray(_K(h=480, w=640)), jnp.asarray(boxes), (480, 640),
                               (240, 320))
    for orig in ((480, 640), (1, 1)):
        t = tcam.get_K_crop_resize(torch.from_numpy(_K(h=480, w=640)), torch.from_numpy(boxes),
                                   orig, (240, 320))
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", [None, "float32", "float64"])
def test_make_T_dtype_matches_jax(dtype):
    import happypose_tpu.lib3d.transforms as jtr
    import happypose_tpu_torch.lib3d.transforms as ttr

    with jax.enable_x64(True):
        rs = np.random.RandomState(1)
        R = Rotation.random(B, random_state=rs).as_matrix().astype(np.float32)
        t = rs.randn(B, 3)  # float64: cast to `dtype`, or to R's
        j = jtr.make_T(jnp.asarray(R), jnp.asarray(t),
                       dtype=None if dtype is None else getattr(jnp, dtype))
        o = ttr.make_T(torch.from_numpy(R), torch.from_numpy(t),
                       dtype=None if dtype is None else getattr(torch, dtype))
        assert str(o.dtype).split(".")[-1] == str(j.dtype) == (dtype or "float32")
        np.testing.assert_array_equal(o.numpy(), np.asarray(j))


def _bench_like_db(jax_side: bool):
    """A textured UV sphere (a procedural texture) and a box, as the JAX
    graft entry's world, in one package's database."""
    if jax_side:
        from happypose_tpu.meshes import database, io
    else:
        from happypose_tpu_torch.meshes import database, io
    sphere = io.make_uv_sphere(radius=0.05, n_lat=10, n_lon=12, with_uv=True)
    sphere.texture = io.make_procedural_texture(64, seed=3)
    return database.MeshDataBase({"sphere": sphere, "box": io.make_box_mesh((0.04, 0.03, 0.05))})


@pytest.mark.parametrize("bake", [False, True])
def test_render_assets_bake_textures_matches_jax(bake):
    """`render_assets(bake_textures=True)` folds the texture into vertex
    colours (no texture slot is used) as JAX does, to 1e-6."""
    ja = _bench_like_db(True).render_assets(texture_size=64, bake_textures=bake)
    ta = _bench_like_db(False).render_assets(texture_size=64, bake_textures=bake, device="cpu")
    for f in dataclasses.fields(ta):
        a, b = np.asarray(getattr(ja, f.name)), getattr(ta, f.name).numpy()
        assert b.shape == a.shape, f.name
        np.testing.assert_allclose(b, a, atol=1e-6, rtol=0, err_msg=f.name)
    assert bool(ta.has_texture.any()) is not bake


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("n_points,aabb", [(96, False), (2000, False), (8, True)])
def test_batched_seed_matches_jax(seed, n_points, aabb):
    """JAX's `batched(seed=)` deletes the seed on entry (its subsample is
    deterministic): whatever the seed, it gives the port's `batched`, which
    takes none (`PARAMS`)."""
    jm = _bench_like_db(True).batched(n_points=n_points, aabb=aabb, seed=seed)
    tdb = _bench_like_db(False)
    tm = tdb.batched(n_points=n_points, aabb=aabb, device="cpu")
    for f in dataclasses.fields(tm):
        np.testing.assert_array_equal(getattr(tm, f.name).numpy(), np.asarray(getattr(jm, f.name)),
                                      err_msg=f.name)
    with pytest.raises(TypeError, match="seed"):
        tdb.batched(n_points=n_points, seed=seed, device="cpu")


def test_pose_dataset_takes_the_jax_fields():
    """`PoseDataset(..., apply_depth_augmentation=, apply_background_augmentation=)`
    constructs in both packages with the same field order. Neither package's
    batches get such augmentation, and JAX never reads the fields: the port
    takes False, its default for both, and raises on True, where JAX's
    default for the background (True) says what its batches do not get."""
    from happypose_tpu.datasets.pose_dataset import PoseDataset as JaxPoseDataset
    from happypose_tpu_torch.datasets.pose_dataset import PoseDataset

    names = [f.name for f in dataclasses.fields(JaxPoseDataset)]
    port = {f.name: f.default for f in dataclasses.fields(PoseDataset)}
    assert [n for n in port if n in names] == names
    for f in dataclasses.fields(JaxPoseDataset):
        if f.name != "apply_background_augmentation":
            assert port[f.name] == f.default, f.name
    assert port["apply_background_augmentation"] is False
    ds = PoseDataset(None, None, apply_depth_augmentation=False,
                     apply_background_augmentation=False, device="cpu")
    assert not ds.apply_depth_augmentation and not ds.apply_background_augmentation
    for name in ("apply_depth_augmentation", "apply_background_augmentation"):
        with pytest.raises(ValueError, match=name):
            PoseDataset(None, None, device="cpu", **{name: True})
    src = Path(happypose_tpu_torch.__file__).parent / "datasets" / "pose_dataset.py"
    jsrc = Path(happypose_tpu.__file__).parent / "datasets" / "pose_dataset.py"
    for text in (src.read_text(), jsrc.read_text()):
        assert "self.apply_depth_augmentation" not in text
        assert "self.apply_background_augmentation" not in text
