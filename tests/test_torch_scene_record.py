"""The synthetic scene sampler and the batched recorder: the port against
the JAX package.

`scene_synth` is numpy on both sides: the same seed gives the same scenes,
exactly. The recorder's host draws follow the same numpy streams, so both
packages sample the same batches; its one `jax.random` draw, the sensor
noise, is handed to the port. The renders differ in their rasterizers:
JAX's CPU recorder uses the two-pass `render_batch`, the port the kernel's
plain version (`raster_fused_reference`), which agree to 1e-5 away from
sliver triangles, so the meshes here are an icosphere, a box and the floor
grid (no UV-sphere pole slivers). Limits, from what differs:
- `rgb`: uint8 within 1 level on >= 99.5% of pixels. The composite is
  rounded to 8 bits after shading, blur and noise: a 1e-6 difference of the
  renders moves a value across a rounding boundary now and then, and the
  shadow's depth compare can flip a pixel at the shadow's edge.
- `visib_px` / `solo_px` within 2 px and bboxes within 1 px: a pixel centre
  within float32 rounding of a triangle's edge can be covered on one side
  and not on the other.
- depth within 1e-4 relative, on the same pixels: 1 / (interpolated 1/z)
  against the two-pass renderer's own interpolation. Over 30 recorded
  frames they parted by up to 8.3e-5 relative (5.6e-5 m), on the floor
  seen at grazing angles, and covered the same pixels every time.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import happypose_tpu.datasets.scene_record as jrec
import happypose_tpu.datasets.scene_synth as jsynth
import happypose_tpu.meshes.database as jdb
import happypose_tpu.meshes.io as jio
import happypose_tpu_torch.datasets.scene_record as trec
import happypose_tpu_torch.datasets.scene_synth as tsynth
import happypose_tpu_torch.meshes.database as tdb
import happypose_tpu_torch.meshes.io as tio

torch.set_num_threads(2)

RGB_LEVELS, RGB_SHARE = 1, 0.995
PX_ATOL, BBOX_ATOL, DEPTH_RTOL = 2, 1.0, 1e-4
RES = (60, 80)
SHADOW = 64


def _icosphere(radius=0.035, subdivisions=1):
    t = (1.0 + 5 ** 0.5) / 2
    v = np.asarray([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0], [0, -1, t], [0, 1, t],
                    [0, -1, -t], [0, 1, -t], [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]],
                   np.float64)
    f = [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11], [1, 5, 9], [5, 11, 4],
         [11, 10, 2], [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8],
         [3, 8, 9], [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]]
    verts = [x / np.linalg.norm(x) for x in v]
    for _ in range(subdivisions):
        mid, out = {}, []

        def m(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                x = verts[a] + verts[b]
                verts.append(x / np.linalg.norm(x))
                mid[key] = len(verts) - 1
            return mid[key]

        for a, b, c in f:
            ab, bc, ca = m(a, b), m(b, c), m(c, a)
            out += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        f = out
    verts = (np.asarray(verts) * radius).astype(np.float32)
    return verts, np.asarray(f, np.int32)


def _meshes(io):
    """Position-coloured icosphere and box of package `io`."""
    v, f = _icosphere()
    return {
        "obj_000001": io.position_colored(io.Mesh(vertices=v, faces=f)),
        "obj_000002": io.position_colored(io.make_box_mesh((0.03, 0.02, 0.04))),
    }


def _dbs():
    return jdb.MeshDataBase(_meshes(jio)), tdb.MeshDataBase(_meshes(tio))


# ------------------------------------------------------------ scene_synth

@pytest.mark.parametrize("falling", [0.0, 0.5, 1.0])
def test_scene_synth_matches_jax_exactly(falling):
    jd, td = _dbs()
    cfg = dict(proba_falling=falling, resolution=RES)
    js = jsynth.SceneSynthesizer(jd, jsynth.SceneSynthConfig(**cfg), seed=4)
    ts = tsynth.SceneSynthesizer(td, tsynth.SceneSynthConfig(**cfg), seed=4)
    for _ in range(6):
        a, b = js.sample_scene(), ts.sample_scene()
        for f in ("obj_ids", "TWO", "TWC", "K", "light", "material"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)
        assert a.falling == b.falling
        np.testing.assert_array_equal(a.TCO, b.TCO)
    np.testing.assert_array_equal(js.background(), ts.background())
    np.testing.assert_array_equal(js.sample_camera(np.zeros(3))[0],
                                  ts.sample_camera(np.zeros(3))[0])


def test_scene_synth_helpers_match_jax():
    rs = np.random.RandomState(0)
    xy, radii = rs.uniform(-0.05, 0.05, (5, 2)), rs.uniform(0.02, 0.04, 5)
    np.testing.assert_array_equal(tsynth.separate_footprints(xy, radii),
                                  jsynth.separate_footprints(xy, radii))
    np.testing.assert_array_equal(tsynth.look_at_TWC(np.ones(3), 0.6, 0.4, 1.1, 0.05),
                                  jsynth.look_at_TWC(np.ones(3), 0.6, 0.4, 1.1, 0.05))
    R = tsynth.random_rotations_np(np.random.RandomState(1), 3)
    np.testing.assert_array_equal(R, jsynth.random_rotations_np(np.random.RandomState(1), 3))
    box = _meshes(tio)["obj_000002"].vertices
    assert tsynth.resting_height(box, R[0]) == jsynth.resting_height(box, R[0])


def test_floor_mesh_and_light_camera_match_jax():
    a, b = jrec.make_floor_mesh(seed=20), trec.make_floor_mesh(seed=20)
    assert len(b.faces) == 512
    for f in ("vertices", "faces", "vertex_colors", "vertex_uv", "texture"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    TCO = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    TCO[:, :3, 3] = [[0.02, 0, 0.5], [-0.05, 0.03, 0.6], [0, 0, 10]]
    args = (np.asarray([0.3, -0.2, -0.9]), TCO, np.asarray([True, True, False]),
            np.asarray([0.07, 0.05, 0.9]), SHADOW)
    for x, y in zip(jrec.light_camera(*args), trec.light_camera(*args)):
        np.testing.assert_array_equal(x, y)


# ------------------------------------------------------- record_scene_batch

def _recorders(seed=3, **kw):
    jd, td = _dbs()
    cfg = dict(resolution=RES, proba_falling=kw.pop("proba_falling", 0.5))
    common = dict(seed=seed, batch_scenes=kw.pop("batch_scenes", 2), shadow_size=SHADOW,
                  n_backgrounds=4, **kw)
    j = jrec.BatchedSceneRecorder(jd, jsynth.SceneSynthConfig(**cfg), renderer="reference",
                                  **common)
    t = trec.BatchedSceneRecorder(td, tsynth.SceneSynthConfig(**cfg), device="cpu", **common)
    return j, t


def _assert_rgb_close(a, b):
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    assert d.max() <= 255 and (d <= RGB_LEVELS).mean() >= RGB_SHARE, (
        f"{(d <= RGB_LEVELS).mean()} of pixels within {RGB_LEVELS} level, max {d.max()}")


def _assert_depth_close(ref, out):
    np.testing.assert_array_equal(out > 0, ref > 0)
    np.testing.assert_allclose(out, ref, rtol=DEPTH_RTOL, atol=0)


def _assert_batches_close(ref, out):
    """`RecordBatch` of JAX (numpy) against the port's, field by field."""
    _assert_rgb_close(ref.rgb, out.rgb.numpy())
    _assert_depth_close(ref.depth, out.depth.numpy())
    for f in ("visib_px", "solo_px"):
        np.testing.assert_allclose(getattr(out, f).numpy(), getattr(ref, f), atol=PX_ATOL,
                                   err_msg=f)
    shown = ref.visib_px > 0
    np.testing.assert_array_equal(out.visib_px.numpy() > 0, shown)
    np.testing.assert_allclose(out.bbox.numpy()[shown], ref.bbox[shown], atol=BBOX_ATOL)
    # the empty set keeps JAX's +-inf
    np.testing.assert_array_equal(out.bbox.numpy()[~shown], ref.bbox[~shown])
    np.testing.assert_array_equal(out.any_vis.numpy(), ref.any_vis)
    np.testing.assert_array_equal(out.border_bad.numpy(), ref.border_bad)


@pytest.mark.parametrize("shadows", [True, False], ids=["shadows", "no_shadows"])
def test_record_scene_batch_matches_jax(shadows):
    """Both recorders sample the same batch (inputs equal); JAX's
    `record_scene_batch` and the port's with JAX's noise handed in."""
    j, t = _recorders(proba_falling=1.0)
    scenes_j, dev_j = j._sample_batch()
    scenes_t, dev_t = t._sample_batch()
    for k, v in dev_j.items():
        np.testing.assert_array_equal(dev_t[k].numpy(), np.asarray(v), err_msg=k)
    key = jax.random.PRNGKey(11)
    ref = jrec.record_scene_batch(
        j.assets, key=key, n_scenes=2, resolution=RES, renderer="reference",
        shadow_size=SHADOW, enable_shadows=shadows, bg_pool=j.bg_pool, **dev_j)
    noise = torch.from_numpy(np.array(jax.random.normal(key, (2, *RES, 3))))
    out = trec.record_scene_batch(
        t.assets, noise=noise, n_scenes=2, resolution=RES, shadow_size=SHADOW,
        enable_shadows=shadows, bg_pool=t.bg_pool, **dev_t)
    ref = jrec.RecordBatch(*(np.asarray(x) for x in ref))
    assert out.rgb.dtype == torch.uint8 and out.visib_px.dtype == torch.int32
    _assert_batches_close(ref, out)
    assert ref.visib_px.sum() > 0 and ref.any_vis.any()


def test_shadow_pass_darkens_the_floor_as_jax():
    """The JAX test's hand-posed scene (`tests/test_scene_record.py`): a box
    over the floor, the light tilted; shadows on against off, in the port,
    beside JAX's outputs of the same scene."""
    import test_scene_record as jt

    args = jt._shadow_scene()
    TCO, lights, T_LC, K_L, materials = args[2], args[5], args[6], args[7], args[8]
    td = tdb.MeshDataBase({"obj_000001": tio.make_box_mesh((0.03, 0.03, 0.03)),
                           "zz_floor": trec.make_floor_mesh(half_size=0.4, n_grid=4)})
    assets_t = td.render_assets(texture_size=16, device="cpu")
    H, W = jt.H, jt.W

    def port(enable):
        return trec.record_scene_batch(
            assets_t, torch.tensor(args[1]), torch.zeros(2, dtype=torch.int64),
            torch.from_numpy(TCO), torch.from_numpy(jt.K1[None]), torch.tensor([True, True]),
            torch.tensor([True, False]), torch.from_numpy(lights), torch.from_numpy(T_LC),
            torch.from_numpy(K_L), torch.from_numpy(materials),
            torch.zeros(1, H, W, 3, dtype=torch.uint8), torch.zeros(1, dtype=torch.int64),
            torch.ones(1, 3), torch.zeros(1, H, W, 3), n_scenes=1, resolution=(H, W),
            shadow_size=64, enable_shadows=enable)

    for enable in (False, True):
        ref = jrec.RecordBatch(*(np.asarray(x) for x in jt._call(*args, enable_shadows=enable)))
        _assert_batches_close(ref, port(enable))
    lit, sh = (port(e).rgb[0].numpy().astype(np.float32) for e in (False, True))
    u_s, v_s = jt._uv_of(-0.025, 0.0, 0.5)
    assert sh[v_s, u_s].mean() < 0.75 * lit[v_s, u_s].mean()


def test_gaussian_blur5_matches_jax():
    img = np.random.RandomState(2).rand(3, 9, 11, 3).astype(np.float32)
    sigma = np.asarray([0.0, 0.7, 1.5], np.float32)
    ref = np.asarray(jrec._gaussian_blur5(img, sigma))
    out = trec._gaussian_blur5(torch.from_numpy(img), torch.from_numpy(sigma)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(out[0], img[0])  # sigma 0: the identity


# ------------------------------------------------------------- the recorder

FRAME_FIELDS_EXACT = ("K", "TWC", "TCO")


def _assert_frames_match(fj, ft):
    """Accepted frames: the same scenes (exact), the same annotations
    (within the limits above), depth to DEPTH_RTOL. The sensor noise is
    drawn by each library, so rgb is not compared here."""
    assert ft.labels == fj.labels
    for f in FRAME_FIELDS_EXACT:
        np.testing.assert_array_equal(getattr(ft, f), getattr(fj, f), err_msg=f)
    np.testing.assert_allclose(ft.bboxes, fj.bboxes, atol=BBOX_ATOL)
    np.testing.assert_allclose(ft.visib_fract, fj.visib_fract, atol=0.02)
    _assert_depth_close(fj.depth, ft.depth)
    assert ft.rgb.shape == fj.rgb.shape and ft.rgb.dtype == np.uint8


def test_recorder_accepts_the_same_frames_as_jax():
    """Per batch, the same frames are rejected (border check, nothing
    visible) and the accepted ones carry the same annotations; the numpy
    streams stay in step over batches, object textures re-drawn included."""
    j, t = _recorders(seed=5, batch_scenes=3, randomize_object_textures=True)
    n_accepted = 0
    for _ in range(3):
        fj, ft = j._render_frames(), t._render_frames()
        assert [f is None for f in ft] == [f is None for f in fj]
        for a, b in zip(fj, ft):
            if a is not None:
                _assert_frames_match(a, b)
                n_accepted += 1
        np.testing.assert_array_equal(t.assets.textures.numpy(), np.asarray(j.assets.textures))
    assert 0 < n_accepted
    frames = t.record(2)
    assert len(frames) == 2 and all(len(f.labels) >= 1 for f in frames)


def test_record_multiview_matches_jax():
    j, t = _recorders(seed=2, batch_scenes=4)
    gj, gt = j.record_multiview(2, 2, max_rounds=3), t.record_multiview(2, 2, max_rounds=3)
    assert [len(g) for g in gt] == [len(g) for g in gj] and len(gt) >= 1
    for a, b in zip(gj, gt):
        for fa, fb in zip(a, b):
            _assert_frames_match(fa, fb)
        # one world layout: TWC_v @ TCO_v agrees between views
        TWO = [f.TWC @ f.TCO for f in b]
        np.testing.assert_allclose(TWO[0], TWO[1], atol=1e-4)


def test_recorder_rejects_a_floor_label_that_does_not_sort_last():
    db = tdb.MeshDataBase({"zzzz": tio.make_box_mesh()})
    with pytest.raises(ValueError, match="sort last"):
        trec.BatchedSceneRecorder(db, tsynth.SceneSynthConfig(resolution=RES), device="cpu")


def test_recorded_frame_fields_as_jax():
    assert [f.name for f in dataclasses.fields(trec.RecordedFrame)] == \
        [f.name for f in dataclasses.fields(jrec.RecordedFrame)]
    assert trec.RecordBatch._fields == jrec.RecordBatch._fields
