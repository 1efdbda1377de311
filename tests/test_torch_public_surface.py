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
