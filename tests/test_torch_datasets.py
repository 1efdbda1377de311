"""BOP datasets on disk, the dataset registry, samplers, the scene renderer
and the small utilities: the port against the JAX package.

A directory written by one package is read by both: meshes, symmetries,
frames and annotations must be equal (both sides are numpy; the PNG bytes
differ between PIL and the port's codec, the pixels do not). Depth is
stored as uint16 millimetres, clipped at 65.535 m and truncated, so a
round trip moves it by up to 1 mm: `DEPTH_ATOL`. `render_scenes` is held
to JAX's (two-pass `reference` renderer) on an icosphere and a box: to 1e-5
per instance on the port's two-pass renderer, with two instances at exactly
equal depth (their values add, and so do their errors: 2e-5 there).
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import happypose_tpu.datasets.bop as jbop
import happypose_tpu.datasets.datasets_cfg as jcfg
import happypose_tpu.datasets.samplers as jsamplers
import happypose_tpu.meshes.io as jio
import happypose_tpu.utils.config as jconfig
import happypose_tpu_torch.datasets.bop as tbop
import happypose_tpu_torch.datasets.datasets_cfg as tcfg
import happypose_tpu_torch.datasets.samplers as tsamplers
import happypose_tpu_torch.meshes.io as tio
import happypose_tpu_torch.utils.config as tconfig
from happypose_tpu.inference.types import DetectionBatch as JaxDetectionBatch
from happypose_tpu.meshes.database import MeshDataBase as JaxMeshDataBase
from happypose_tpu.ops.scene_renderer import render_scenes as jax_render_scenes
from happypose_tpu_torch.datasets.object_datasets import (
    GoogleScannedObjectDataset, MeshDirDataset, ShapeNetObjectDataset,
)
from happypose_tpu_torch.inference.types import DetectionBatch
from happypose_tpu_torch.meshes.database import MeshDataBase
from happypose_tpu_torch.ops.rasterizer import render_batch
from happypose_tpu_torch.ops.scene_renderer import render_scenes
from happypose_tpu_torch.utils.timer import DeviceTimer, Timer
from test_torch_meshio import assert_meshes_equal
from test_torch_models import mesh_dbs

torch.set_num_threads(2)

DEPTH_ATOL = 1e-3 + 1e-6  # one millimetre of truncation, and float32 rounding of the product
H, W = 48, 64


def _meshes(mod):
    """A textured sphere, a box with a 180-degree symmetry, a coloured capsule."""
    sphere = mod.make_uv_sphere(radius=0.05, n_lat=8, n_lon=12, with_uv=True)
    sphere.texture = mod.make_procedural_texture(32, seed=1)
    return {
        "obj_000001": sphere,
        "obj_000002": mod.make_box_mesh((0.04, 0.03, 0.05)),
        "obj_000005": mod.position_colored(mod.make_capsule_mesh(0.02, 0.06, 8, 2)),
    }


SYMMETRIES = {"obj_000002": np.stack([np.eye(4), np.diag([-1.0, -1.0, 1.0, 1.0])])}
SYMMETRIES["obj_000002"][1, :3, 3] = [0.0, 0.0, 0.002]


def _frames(mod, n=3):
    rs = np.random.RandomState(0)
    frames = []
    for i in range(n):
        n_obj = 1 + i % 2
        TWO = np.tile(np.eye(4, dtype=np.float32), (n_obj, 1, 1))
        TWO[:, :3, :3] = Rotation.random(n_obj, random_state=rs).as_matrix()
        TWO[:, :3, 3] = rs.randn(n_obj, 3) * 0.05 + [0, 0, 0.6]
        TWC = np.eye(4, dtype=np.float32)
        if i == 1:
            TWC[:3, :3] = Rotation.random(random_state=rs).as_matrix()
            TWC[:3, 3] = [0.1, -0.2, 0.3]
        depth = rs.uniform(0.2, 2.0, (H, W)).astype(np.float32)
        depth[0, :4] = [0.0, 70.0, 0.0005, 65.535]  # no reading, past the clip, under 1 mm
        frames.append(mod.SceneObservation(
            rgb=rs.randint(0, 256, (H, W, 3)).astype(np.uint8),
            K=np.asarray([[80.0, 0, W / 2], [0, 80.0, H / 2], [0, 0, 1]], np.float32),
            depth=depth if i != 2 else None, TWC=TWC,
            obj_labels=[("obj_000001", "obj_000002", "obj_000005")[(i + j) % 3]
                        for j in range(n_obj)],
            TWO=TWO, bboxes=rs.uniform(0, 40, (n_obj, 4)).astype(np.float32),
            visib_fract=rs.rand(n_obj).astype(np.float32), scene_id=7, view_id=3 * i,
        ))
    return frames


def _write(mod, db_cls, root):
    meshes = _meshes(jio if mod is jbop else tio)
    db = db_cls(meshes=meshes, symmetries=SYMMETRIES)
    mod.write_bop_models(root / "models", db)
    mod.write_bop_scene(root / "test", 7, _frames(mod))
    return meshes


OBS_FIELDS = [f.name for f in dataclasses.fields(tbop.SceneObservation)]


def assert_observations_equal(a, b):
    for f in OBS_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)
        else:
            assert x == y, f


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_bop_directory_reads_the_same_in_both_packages(writer, tmp_path):
    mod, db_cls = (jbop, JaxMeshDataBase) if writer == "jax" else (tbop, MeshDataBase)
    meshes = _write(mod, db_cls, tmp_path)

    ours = tbop.BOPObjectDataset(tmp_path / "models")
    ref = jbop.BOPObjectDataset(tmp_path / "models")
    assert ours.labels == ref.labels == sorted(meshes)
    assert ours.diameters_mm == ref.diameters_mm
    np.testing.assert_array_equal(ours.is_symmetric, ref.is_symmetric)
    assert ours.is_symmetric.tolist() == [False, True, False]
    for label, mesh in meshes.items():
        assert_meshes_equal(ours.mesh_db.meshes[label], ref.mesh_db.meshes[label])
        # millimetres on disk, metres in memory
        np.testing.assert_allclose(ours.mesh_db.meshes[label].vertices, mesh.vertices, atol=1e-7)
        S, S_ref = ours.mesh_db.symmetries[label], ref.mesh_db.symmetries[label]
        np.testing.assert_array_equal(S, S_ref)
    S = ours.mesh_db.symmetries["obj_000002"]
    np.testing.assert_allclose(S, SYMMETRIES["obj_000002"], atol=1e-9)  # translation back in m
    assert ours.mesh_db.meshes["obj_000001"].texture is not None

    for load_depth in (False, True):
        a = tbop.BOPSceneDataset(tmp_path / "test", load_depth=load_depth)
        b = jbop.BOPSceneDataset(tmp_path / "test", load_depth=load_depth)
        assert a.frames == b.frames == [(7, 0), (7, 3), (7, 6)]
        for i in range(len(a)):
            assert_observations_equal(a[i], b[i])
    for got, want in zip((a[i] for i in range(3)), _frames(tbop)):
        np.testing.assert_array_equal(got.rgb, want.rgb)
        np.testing.assert_allclose(got.TWO, want.TWO, atol=1e-6)
        np.testing.assert_allclose(got.TWC, want.TWC, atol=1e-6)
        np.testing.assert_allclose(got.bboxes, want.bboxes, atol=1e-4)
        assert got.obj_labels == want.obj_labels
        if want.depth is None:
            assert got.depth is None
        else:
            clipped = np.minimum(want.depth, 65.535)
            assert np.abs(got.depth - clipped).max() <= DEPTH_ATOL
            assert (got.depth <= clipped + 1e-6).all()  # truncated, never rounded up


def test_both_packages_write_the_same_bop_directory(tmp_path):
    """json files equal as text, PLY files as bytes, images as pixels."""
    from PIL import Image

    from happypose_tpu_torch.utils.png import read_png

    _write(jbop, JaxMeshDataBase, tmp_path / "j")
    _write(tbop, MeshDataBase, tmp_path / "t")
    files = sorted(p.relative_to(tmp_path / "j") for p in (tmp_path / "j").rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(tmp_path / "t") for p in (tmp_path / "t").rglob("*")
                           if p.is_file())
    assert len(files) == 3 + 1 + 1 + 3 + 2 + 3  # PLYs, texture, info, rgb, depth, scene json
    for rel in files:
        a, b = tmp_path / "t" / rel, tmp_path / "j" / rel
        if rel.suffix == ".png":
            np.testing.assert_array_equal(read_png(a), np.asarray(Image.open(b)))
        else:
            assert a.read_bytes() == b.read_bytes(), rel


def test_scene_dataset_options(tmp_path):
    _write(tbop, MeshDataBase, tmp_path)
    ds = tbop.BOPSceneDataset(tmp_path / "test", cache_frames=True)
    assert ds[1] is ds[1] and ds[0].depth is None
    # grey frames become three channels; a missing ground truth gives None
    from happypose_tpu_torch.utils.png import write_png

    scene = tmp_path / "test" / "000007"
    write_png(scene / "rgb" / "000000.png", np.full((H, W), 9, np.uint8))
    (scene / "scene_gt.json").unlink()
    obs = tbop.BOPSceneDataset(tmp_path / "test")[0]
    assert obs.rgb.shape == (H, W, 3) and obs.obj_labels is None and obs.TWO is None
    # a .jpg frame goes through PIL, where it is read
    from PIL import Image

    (scene / "rgb" / "000003.png").unlink()
    Image.fromarray(np.full((H, W, 3), 200, np.uint8)).save(scene / "rgb" / "000003.jpg")
    assert tbop.BOPSceneDataset(tmp_path / "test")[1].rgb.shape == (H, W, 3)


def test_max_faces_decimates_at_load_time(tmp_path):
    dense = tio.position_colored(tio.make_uv_sphere(50.0, 30, 40))
    tio.save_ply(tmp_path / "obj_000001.ply", dense)
    ours = tbop.BOPObjectDataset(tmp_path, max_faces=300)
    ref = jbop.BOPObjectDataset(tmp_path, max_faces=300)
    assert_meshes_equal(ours.mesh_db.meshes["obj_000001"], ref.mesh_db.meshes["obj_000001"])
    assert len(ours.mesh_db.meshes["obj_000001"].faces) <= 300 < len(dense.faces)


# -------------------------------------------------------------- registries

def _bop_tree(root):
    _write(tbop, MeshDataBase, root / "bop_datasets" / "ycbv")
    (root / "bop_datasets" / "ycbv" / "test_targets_bop19.json").write_text(json.dumps(
        [{"scene_id": 7, "im_id": 3, "obj_id": 1, "inst_count": 1},
         {"scene_id": 7, "im_id": 6, "obj_id": 2, "inst_count": 1}]))
    (root / "bop_datasets" / "ycbv" / "test").rename(root / "bop_datasets" / "ycbv" / "train_pbr")
    _write(tbop, MeshDataBase, root / "bop_datasets" / "ycbv")
    _write(tbop, MeshDataBase, root / "bop_datasets" / "tless")
    (root / "bop_datasets" / "tless" / "test").rename(
        root / "bop_datasets" / "tless" / "test_primesense")


@pytest.mark.parametrize("name,n_frames", [
    ("ycbv.bop19", None), ("ycbv.pbr", None), ("ycbv.test", 2), ("tless.bop19", None),
    ("ycbv.train_pbr", 1),
])
def test_scene_dataset_names_resolve_as_in_jax(name, n_frames, tmp_path):
    _bop_tree(tmp_path)
    ours = tcfg.make_scene_dataset(name, data_dir=tmp_path, load_depth=True, n_frames=n_frames)
    ref = jcfg.make_scene_dataset(name, data_dir=tmp_path, load_depth=True, n_frames=n_frames)
    assert isinstance(ours, tbop.BOPSceneDataset)
    assert ours.split_dir == ref.split_dir and ours.frames == ref.frames
    assert ours.load_depth and len(ours) == {"ycbv.bop19": 2, "ycbv.pbr": 3, "ycbv.test": 2,
                                             "tless.bop19": 3, "ycbv.train_pbr": 1}[name]


def test_scene_dataset_from_a_path_and_names_not_ported(tmp_path):
    _write(tbop, MeshDataBase, tmp_path)
    ds = tcfg.make_scene_dataset(str(tmp_path / "test"))
    assert len(ds) == 3 and not ds.load_depth
    # a DeepIM name resolves to its reader, which reads its object list from
    # `<data_dir>/modelnet`: absent here, in both packages alike
    for cfg in (tcfg, jcfg):
        with pytest.raises(FileNotFoundError, match="modelnet/model_set/airplane_test.txt"):
            cfg.make_scene_dataset("deepim.modelnet-airplane-test", data_dir=tmp_path)
    # a shard directory resolves as in JAX (`webdataset.<dir>`)
    from happypose_tpu_torch.datasets.web_scene_dataset import (
        WebSceneDataset,
        write_scene_ds_as_wds,
    )

    write_scene_ds_as_wds([ds[i] for i in range(3)], tmp_path / "wds", shard_size=2)
    wds = tcfg.make_scene_dataset(f"webdataset.{tmp_path / 'wds'}", data_dir=tmp_path)
    ref = jcfg.make_scene_dataset(f"webdataset.{tmp_path / 'wds'}", data_dir=tmp_path)
    assert isinstance(wds, WebSceneDataset) and len(wds) == len(ref) == 3
    np.testing.assert_array_equal(wds[2].rgb, ds[2].rgb)


@pytest.mark.parametrize("name", ["ycbv.cad", "ycbv", "meshdir", "explicit_path"])
def test_object_dataset_names_resolve_as_in_jax(name, tmp_path):
    _bop_tree(tmp_path)
    models = tmp_path / "bop_datasets" / "ycbv" / "models"
    if name == "meshdir":
        name = f"meshdir.{models}"
    elif name == "explicit_path":
        name = str(models)
    ours = tcfg.make_object_dataset(name, data_dir=tmp_path)
    ref = jcfg.make_object_dataset(name, data_dir=tmp_path)
    assert ours.labels == ref.labels and len(ours.labels) == 3
    for label in ours.labels:
        assert_meshes_equal(ours.mesh_db.meshes[label], ref.mesh_db.meshes[label])


def test_object_dataset_layouts(tmp_path):
    """GSO, ShapeNet and plain mesh directories: lazy loading, labels, scale."""
    box = tio.make_box_mesh((1.0, 2.0, 3.0))
    gso = tmp_path / "gso" / "models_normalized" / "mug" / "meshes"
    shapenet = tmp_path / "shapenet" / "0123" / "abc" / "models"
    for d in (gso, shapenet, tmp_path / "plain"):
        d.mkdir(parents=True)
    obj = "".join(f"v {x} {y} {z}\n" for x, y, z in box.vertices) + "".join(
        f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in box.faces)
    (gso / "model.obj").write_text(obj)
    (shapenet / "model_normalized.obj").write_text(obj)
    tio.save_ply(tmp_path / "plain" / "thing.ply", box)
    (tmp_path / "plain" / "notes.txt").write_text("not a mesh")
    assert GoogleScannedObjectDataset(tmp_path / "gso").labels == ["gso_mug"]
    assert ShapeNetObjectDataset(tmp_path / "shapenet").labels == ["shapenet_0123_abc"]
    ds = MeshDirDataset(tmp_path / "plain", scale=0.001)
    assert ds.labels == ["thing"] and len(dict.keys(ds.mesh_db.meshes)) == 0  # nothing decoded yet
    np.testing.assert_allclose(ds.mesh_db.meshes["thing"].vertices, box.vertices * 0.001)
    assert len(dict.keys(ds.mesh_db.meshes)) == 1
    tdb = tcfg.make_object_dataset("gso.normalized", data_dir=tmp_path)
    assert tdb.labels == []  # no such directory under this root: an empty registry, as in JAX


# ---------------------------------------------------------------- samplers

@pytest.mark.parametrize("n,replicas,shuffle", [(10, 1, False), (10, 3, False), (11, 4, True),
                                                (3, 4, True)])
def test_distributed_sampler_matches_jax(n, replicas, shuffle):
    for rank in range(replicas):
        a = tsamplers.DistributedSceneSampler(n, replicas, rank, shuffle=shuffle, seed=5)
        b = jsamplers.DistributedSceneSampler(n, replicas, rank, shuffle=shuffle, seed=5)
        assert list(a) == list(b) and len(a) == len(b)
    covered = sorted(i for r in range(replicas)
                     for i in tsamplers.DistributedSceneSampler(n, replicas, r, shuffle, 5))
    assert covered == list(range(n))


def test_other_samplers_match_jax():
    assert list(tsamplers.PartialSampler(20, 7, seed=2)) == list(jsamplers.PartialSampler(20, 7, seed=2))
    assert len(tsamplers.PartialSampler(5, 9)) == 5
    data = list(range(100, 110))
    for mod_a, mod_b in ((tsamplers, jsamplers),):
        a = iter(mod_a.RandomIterableSceneDataset(data, seed=3))
        b = iter(mod_b.RandomIterableSceneDataset(data, seed=3))
        assert [next(a) for _ in range(12)] == [next(b) for _ in range(12)]
        ma = iter(mod_a.IterableMultiSceneDataset(
            [mod_a.RandomIterableSceneDataset(data, 1), mod_a.RandomIterableSceneDataset(data[:3], 2)], 4))
        mb = iter(mod_b.IterableMultiSceneDataset(
            [mod_b.RandomIterableSceneDataset(data, 1), mod_b.RandomIterableSceneDataset(data[:3], 2)], 4))
        assert [next(ma) for _ in range(12)] == [next(mb) for _ in range(12)]


# ---------------------------------------------------------- scene renderer

SCENE_ATOL = 1e-5  # float32 renders of the same faces by two libraries, per front instance


def _scene_inputs():
    rs = np.random.RandomState(2)
    # scene 0: sphere in front of box (overlapping); scene 1: two boxes at
    # the same pose (equal depth on every pixel) and an invalid instance
    obj_ids = np.asarray([0, 1, 1, 1, 0])
    scene_ids = np.asarray([0, 0, 1, 1, 1])
    valid = np.asarray([True, True, True, True, False])
    TCO = np.tile(np.eye(4, dtype=np.float32), (5, 1, 1))
    TCO[:, :3, :3] = Rotation.random(5, random_state=rs).as_matrix()
    TCO[:, :3, 3] = [[0.01, 0.0, 0.4], [0.03, 0.01, 0.5], [-0.02, 0.0, 0.45],
                     [-0.02, 0.0, 0.45], [0.0, 0.0, 0.3]]
    TCO[3] = TCO[2]
    K = np.tile(np.asarray([[120.0, 0, W / 2], [0, 120.0, H / 2], [0, 0, 1]], np.float32), (5, 1, 1))
    lights = np.concatenate([rs.randn(5, 3), rs.uniform(0.3, 0.7, (5, 2))], 1).astype(np.float32)
    lights[2:] = lights[2]  # one lighting per scene
    lights[:2] = lights[0]
    return obj_ids, scene_ids, TCO, K, valid, lights


@pytest.mark.parametrize("with_lights", [False, True], ids=["headlight", "lights"])
def test_render_scenes_matches_jax(with_lights):
    """JAX merges the renders of its two-pass renderer. The port's merge on
    the port's two-pass renderer agrees to 1e-5 per front instance; on the
    fused renderer (the default: the kernel's path) to the bounds that
    `test_torch_rasterizer.py` states for fused against two-pass (depth
    1e-4, normals 1e-3 on faces seen edge-on), masks equal."""
    jdb, tdb = mesh_dbs()
    obj_ids, scene_ids, TCO, K, valid, lights = _scene_inputs()
    ref = jax_render_scenes(
        jdb.render_assets(), jnp.asarray(obj_ids, jnp.int32), jnp.asarray(scene_ids, jnp.int32),
        jnp.asarray(TCO), jnp.asarray(K), jnp.asarray(valid), n_scenes=2, resolution=(H, W),
        renderer="reference", lights=jnp.asarray(lights) if with_lights else None)
    args = (tdb.render_assets(device="cpu"), torch.from_numpy(obj_ids), torch.from_numpy(scene_ids),
            torch.from_numpy(TCO), torch.from_numpy(K), torch.from_numpy(valid))
    kw = dict(n_scenes=2, resolution=(H, W),
              lights=torch.from_numpy(lights) if with_lights else None)
    out = render_scenes(*args, renderer_fn=render_batch, **kw)
    fused = render_scenes(*args, **kw)
    for got, tol in ((out, {"rgb": SCENE_ATOL, "depth": SCENE_ATOL, "normals": SCENE_ATOL}),
                     (fused, {"rgb": 1e-3, "depth": 1e-4, "normals": 1e-3})):
        np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
        for f, atol in tol.items():
            a, b = getattr(got, f).numpy(), np.asarray(getattr(ref, f))
            assert a.shape == b.shape
            # scene 1 sums two instances, and with them their errors
            np.testing.assert_allclose(a[0], b[0], atol=atol, err_msg=f)
            np.testing.assert_allclose(a[1], b[1], atol=2 * atol, err_msg=f)
    assert out.mask[0].float().mean() > 0.2 and out.mask[1].float().mean() > 0.1
    # the tie: both boxes of scene 1 count as front, so their normals add
    # up to length 2 (a single front instance gives unit normals)
    for got in (out, fused):
        n1 = got.normals[1][got.mask[1]].norm(dim=-1)
        n0 = got.normals[0][got.mask[0]].norm(dim=-1)
        assert torch.allclose(n1, torch.full_like(n1, 2.0), atol=1e-4)
        assert torch.allclose(n0, torch.ones_like(n0), atol=1e-4)
        # the invalid instance (nearest of scene 1) left no trace
        assert float(got.depth[1][got.mask[1]].min()) > 0.35


# ----------------------------------------------------------- DetectionBatch

def test_detection_batch_pad_truncates_with_a_stable_sort():
    """More rows than the budget: the best scored are kept, the earlier row
    among equal scores (as JAX); fewer rows: JAX pads, the port does not."""
    rs = np.random.RandomState(0)
    boxes = rs.uniform(0, 50, (7, 4)).astype(np.float32)
    ids = np.arange(7)
    scores = np.asarray([0.5, 0.9, 0.5, 0.9, 0.1, 0.5, 0.9], np.float32)
    ours = DetectionBatch.from_numpy(boxes, ids, scores=scores, device="cpu")
    ref = JaxDetectionBatch.from_numpy(boxes, ids, scores=scores)
    for n in (1, 2, 4, 5):
        a, b = DetectionBatch.pad(ours, n), JaxDetectionBatch.pad(ref, n)
        assert a.n_rows == b.n_rows == n
        for f in ("boxes", "obj_ids", "batch_im_ids", "instance_ids", "scores", "valid"):
            np.testing.assert_array_equal(getattr(a, f).numpy(), np.asarray(getattr(b, f)), err_msg=f)
    assert DetectionBatch.pad(ours, 4).obj_ids.tolist() == [1, 3, 6, 0]
    assert DetectionBatch.pad(ours, 7) is ours
    padded = JaxDetectionBatch.pad(ref, 9)
    same = DetectionBatch.pad(ours, 9)
    assert same is ours and padded.n_rows == 9 and int(np.asarray(padded.valid).sum()) == 7


# ---------------------------------------------------------------- utilities

@dataclasses.dataclass(frozen=True)
class _Inner:
    size: "Tuple[int, int]" = (1, 2)
    name: str = "a"


@dataclasses.dataclass(frozen=True)
class _Outer:
    inner: _Inner = _Inner()
    lr: float = 0.1
    tags: list = dataclasses.field(default_factory=list)


def test_config_overrides_match_jax():
    overrides = ["inner.size=[3,4]", "lr=0.5", "inner.name=resnet", "tags=[1,2]"]
    ours, ref = tconfig.apply_overrides(_Outer(), overrides), jconfig.apply_overrides(_Outer(), overrides)
    assert ours == ref and ours.inner.size == (3, 4) and ours.tags == [1, 2]
    assert tconfig.config_to_dict(ours) == jconfig.config_to_dict(ref)
    for bad, err in (("lr", ValueError), ("nope=1", AttributeError)):
        with pytest.raises(err):
            tconfig.apply_overrides(_Outer(), [bad])


def test_timers_and_logging():
    import logging

    from happypose_tpu_torch.utils.logging import get_logger, set_logging_level

    t = Timer().start()
    t.pause()
    first = t.elapsed
    t.resume()
    assert t.stop().total_seconds() >= first >= 0.0 and not t.is_running
    timer = DeviceTimer(device="cpu")
    out = timer.time(lambda a, b: a @ b, torch.ones(8, 8), torch.ones(8, 8))
    assert out.shape == (8, 8) and timer.elapsed > 0.0
    off = DeviceTimer(enabled=False, device="cpu")
    assert off.time(lambda: 3) == 3 and off.elapsed == 0.0
    assert DeviceTimer().device.type == "cuda"  # the default waits for the card
    logger = get_logger("happypose_tpu_torch.test")
    assert get_logger("happypose_tpu_torch.test") is logger and len(logger.handlers) == 1
    set_logging_level("warning")
    assert logging.getLogger("happypose_tpu_torch").level == logging.WARNING
    set_logging_level("info")
