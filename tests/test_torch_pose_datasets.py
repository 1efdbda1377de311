"""Training data from disk: the record CLI's BOP and WDS output, the WDS
readers and writer, `PoseDataset`, `StreamingPoseDataset` and the
detector's batches, the port against the JAX package.

A split is recorded once by the port's CLI on the CPU (60x80, shadows on).
Both packages read it, and shards written by either are read by the other.
Frames and objects are picked by `np.random.RandomState` on both sides, so
with the colour jitter off the batches hold the same frames: `K`, object
ids and `TCO` exactly, images to 1e-5 (the crops' `roi_align_matmul`; the
scale 0.5 is exact in float32, where XLA's fused multiply-add would
otherwise move a sample by an ulp).
"""

import io
import tarfile
import threading

import numpy as np
import pytest
import torch

import happypose_tpu.datasets.bop as jbop
import happypose_tpu.datasets.web_scene_dataset as jwds
import happypose_tpu_torch.datasets.bop as tbop
import happypose_tpu_torch.datasets.web_scene_dataset as twds
from happypose_tpu.datasets.pose_dataset import PoseDataset as JaxPoseDataset
from happypose_tpu.datasets.streaming_pose_dataset import (
    StreamingPoseDataset as JaxStreamingPoseDataset,
)
from happypose_tpu_torch.datasets.pose_dataset import PoseDataset
from happypose_tpu_torch.datasets.streaming_pose_dataset import StreamingPoseDataset
from happypose_tpu_torch.scripts import record_synthetic_dataset

torch.set_num_threads(2)

IMAGES_ATOL = 1e-5
RES = (60, 80)
TRAIN_RES = (30, 40)


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    out = tmp_path_factory.mktemp("rec")
    rc = record_synthetic_dataset.main([
        "--out-dir", str(out), "--n-frames", "6", "--resolution", *map(str, RES),
        "--batch-scenes", "4", "--write-models", "--wds",
        "--shard-size", "2", "--proba-falling", "1.0", "--seed", "1", "--device", "cpu"])
    assert rc == 0
    return out


def _assert_obs_equal(a, b, depth_atol=0.0):
    np.testing.assert_array_equal(a.rgb, b.rgb)
    np.testing.assert_allclose(a.depth, b.depth, rtol=0, atol=depth_atol)
    assert list(a.obj_labels) == list(b.obj_labels)
    np.testing.assert_allclose(a.TWO, b.TWO, rtol=0, atol=1e-6)
    np.testing.assert_allclose(a.bboxes, b.bboxes, rtol=0, atol=1e-4)
    np.testing.assert_allclose(a.visib_fract, b.visib_fract, rtol=0, atol=1e-6)
    np.testing.assert_allclose(a.K, b.K, rtol=1e-6)


def test_record_cli_writes_bop_and_wds_read_alike(recorded):
    """The BOP tree and the shards hold the same frames, for both packages'
    readers (depth: BOP's mm x 0.001 against the shards' mm / 1000)."""
    bop_t = tbop.BOPSceneDataset(recorded, load_depth=True)
    bop_j = jbop.BOPSceneDataset(recorded, load_depth=True)
    wds_t, wds_j = twds.WebSceneDataset(recorded / "wds"), jwds.WebSceneDataset(recorded / "wds")
    assert len(bop_t) == len(bop_j) == len(wds_t) == len(wds_j) == 6
    assert len(list((recorded / "wds").glob("*.tar"))) == 3
    for i in range(6):
        _assert_obs_equal(bop_t[i], bop_j[i])
        _assert_obs_equal(wds_t[i], wds_j[i])
        _assert_obs_equal(wds_t[i], bop_t[i], depth_atol=1e-6)
        assert bop_t[i].depth.max() > 0.1 and len(bop_t[i].obj_labels) >= 1
    models_t = tbop.BOPObjectDataset(recorded / "models").mesh_db
    assert models_t.labels == jbop.BOPObjectDataset(recorded / "models").mesh_db.labels


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_shards_written_by_one_package_read_in_the_other(writer, tmp_path):
    rs = np.random.RandomState(0)
    obs = []
    for i in range(5):
        kw = dict(rgb=rs.randint(0, 256, (12, 16, 3), dtype=np.uint8),
                  K=np.eye(3, dtype=np.float32), depth=rs.rand(12, 16).astype(np.float32),
                  obj_labels=["obj_000001", "obj_000002"][: 1 + i % 2],
                  TWO=np.tile(np.eye(4, dtype=np.float32), (1 + i % 2, 1, 1)),
                  bboxes=rs.rand(1 + i % 2, 4).astype(np.float32) * 10,
                  visib_fract=rs.rand(1 + i % 2).astype(np.float32), view_id=i)
        obs.append((jbop if writer == "jax" else tbop).SceneObservation(**kw))
    write = jwds.write_scene_ds_as_wds if writer == "jax" else twds.write_scene_ds_as_wds
    write(obs, tmp_path, shard_size=2)
    for reader in (twds.WebSceneDataset(tmp_path), jwds.WebSceneDataset(tmp_path)):
        assert len(reader) == 5
        for i in range(5):
            _assert_obs_equal(reader[i], obs[i], depth_atol=1e-3)  # truncated to uint16 mm
    j_it, t_it = iter(jwds.IterableWebSceneDataset(tmp_path, 3, seed=4)), iter(
        twds.IterableWebSceneDataset(tmp_path, 3, seed=4))
    for _ in range(12):  # past an epoch: the same shuffled order
        np.testing.assert_array_equal(next(t_it).rgb, next(j_it).rgb)


def _assert_batches_equal(out, ref):
    np.testing.assert_array_equal(out.obj_ids.numpy(), np.asarray(ref.obj_ids))
    np.testing.assert_array_equal(out.K.numpy(), np.asarray(ref.K))
    np.testing.assert_array_equal(out.TCO_gt.numpy(), np.asarray(ref.TCO_gt))
    assert out.images.shape == ref.images.shape and out.images.dtype == torch.float32
    np.testing.assert_allclose(out.images.numpy(), np.asarray(ref.images), rtol=0,
                               atol=IMAGES_ATOL)


def test_pose_dataset_batches_match_jax(recorded):
    db_t = tbop.BOPObjectDataset(recorded / "models").mesh_db
    db_j = jbop.BOPObjectDataset(recorded / "models").mesh_db
    kw = dict(batch_size=3, resolution=TRAIN_RES, seed=7, apply_rgb_augmentation=False)
    it_t = iter(PoseDataset(tbop.BOPSceneDataset(recorded, cache_frames=True), db_t,
                            device="cpu", **kw))
    it_j = iter(JaxPoseDataset(jbop.BOPSceneDataset(recorded, cache_frames=True), db_j, **kw))
    for _ in range(3):
        _assert_batches_equal(next(it_t), next(it_j))


def test_pose_dataset_device_cache_equals_the_host_path(recorded):
    db = tbop.BOPObjectDataset(recorded / "models").mesh_db
    scene_ds = tbop.BOPSceneDataset(recorded, cache_frames=True)
    kw = dict(batch_size=4, resolution=TRAIN_RES, seed=3, device="cpu")
    host, cached = iter(PoseDataset(scene_ds, db, **kw)), iter(
        PoseDataset(scene_ds, db, device_cache=True, **kw))
    for _ in range(2):
        a, b = next(host), next(cached)
        for x, y in zip(a, b):
            assert torch.equal(x, y)  # bit for bit, jitter included
    on = next(iter(PoseDataset(scene_ds, db, **kw)))
    off = next(iter(PoseDataset(scene_ds, db, apply_rgb_augmentation=False, **kw)))
    assert torch.equal(on.K, off.K) and torch.equal(on.TCO_gt, off.TCO_gt)
    assert not torch.equal(on.images, off.images)
    assert 0.0 <= float(on.images.min()) and float(on.images.max()) <= 1.0


def test_pose_dataset_filters_objects_as_jax(recorded):
    """`keep_labels` and `min_area` as in JAX: only the kept label comes out."""
    db_t = tbop.BOPObjectDataset(recorded / "models").mesh_db
    db_j = jbop.BOPObjectDataset(recorded / "models").mesh_db
    kw = dict(batch_size=4, resolution=TRAIN_RES, seed=1, apply_rgb_augmentation=False,
              keep_labels=["obj_000002"], min_area=30.0)
    out = next(iter(PoseDataset(tbop.BOPSceneDataset(recorded), db_t, device="cpu", **kw)))
    ref = next(iter(JaxPoseDataset(jbop.BOPSceneDataset(recorded), db_j, **kw)))
    _assert_batches_equal(out, ref)
    assert (out.obj_ids == db_t.id_of("obj_000002")).all()


def _stream_pair(recorded, **kw):
    db_t = tbop.BOPObjectDataset(recorded / "models").mesh_db
    db_j = jbop.BOPObjectDataset(recorded / "models").mesh_db
    kw = dict(batch_size=3, resolution=TRAIN_RES, chunk_frames=3, prefetch_chunks=1,
              apply_rgb_augmentation=False, seed=2, **kw)
    return (StreamingPoseDataset(str(recorded / "wds"), db_t, device="cpu", **kw),
            JaxStreamingPoseDataset(str(recorded / "wds"), db_j, **kw))


def test_streaming_pose_dataset_batches_match_jax(recorded):
    ours, ref = _stream_pair(recorded)
    it_t, it_j = iter(ours), iter(ref)
    try:
        for _ in range(5):  # several chunks
            _assert_batches_equal(next(it_t), next(it_j))
    finally:
        ours.stop()
        ref.stop()
    assert not ours._chunks._thread.is_alive()


def test_streaming_pose_dataset_stop_ends_its_thread(recorded):
    ds, _ = _stream_pair(recorded)
    before = threading.active_count()
    it = iter(ds)
    try:
        b = next(it)
        assert b.images.shape == (3, 3, *TRAIN_RES)
        assert threading.active_count() == before + 1
    finally:
        ds.stop()
    assert threading.active_count() == before


def test_streaming_decode_error_surfaces_in_the_training_loop(recorded, tmp_path):
    """A shard with a corrupt PNG: the decode thread's error is raised by
    the iterator, and the thread has ended."""
    payloads = {}
    with tarfile.open(next((recorded / "wds").glob("*.tar"))) as tar:
        for m in tar.getmembers():
            payloads[m.name] = tar.extractfile(m).read()
    with tarfile.open(tmp_path / "bad.tar", "w") as tar:
        for name, data in payloads.items():
            if name.endswith(".rgb.png"):
                data = data[:40]  # truncated image
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
    db = tbop.BOPObjectDataset(recorded / "models").mesh_db
    ds = StreamingPoseDataset(str(tmp_path), db, batch_size=2, resolution=TRAIN_RES,
                              chunk_frames=2, device="cpu")
    it = iter(ds)
    try:
        with pytest.raises(ValueError, match="rgb.png"):
            next(it)
    finally:
        ds.stop()
    assert not ds._chunks._thread.is_alive()


def test_streaming_pose_dataset_needs_shards(tmp_path):
    with pytest.raises(FileNotFoundError):
        StreamingPoseDataset(str(tmp_path), None, device="cpu")


@pytest.mark.parametrize("image_size", [(30, 40), (40, 40)], ids=["same_aspect", "crop_x"])
def test_detector_batches_match_jax(recorded, image_size, monkeypatch):
    """`run_detector_training`'s first batch from `RandomState(0)`: the JAX
    CLI's (read by intercepting the targets it builds, then stopping it)
    against the port's `BatchMaker`: the same boxes, labels, validity and
    box masks exactly, the images to 1e-5."""
    import happypose_tpu.datasets.augmentations as jaug
    import happypose_tpu.training.detector_loss as jdl
    from happypose_tpu.scripts import run_detector_training as jcli
    from happypose_tpu_torch.scripts.run_detector_training import BatchMaker

    seen = {}

    class Stop(Exception):
        pass

    crop = jaug.crop_resize_to_aspect

    def record_crop(*a, **kw):
        seen["x"], K = crop(*a, **kw)
        return seen["x"], K

    def record_targets(**kw):
        seen["targets"] = {k: np.asarray(v) for k, v in kw.items()}
        raise Stop

    monkeypatch.setattr(jaug, "crop_resize_to_aspect", record_crop)
    monkeypatch.setattr(jdl, "DetectionTargets", record_targets)
    with pytest.raises(Stop):
        jcli.main(["--run-dir", str(recorded / "unused"), "--split-dir", str(recorded),
                   "--models-dir", str(recorded / "models"), "--image-size", *map(str, image_size),
                   "--batch-size", "3", "--max-gt", "4"])
    db = tbop.BOPObjectDataset(recorded / "models").mesh_db
    maker = BatchMaker(tbop.BOPSceneDataset(recorded, cache_frames=True), db.label_to_id,
                       image_size, 3, 4, "cpu")
    x, t = maker.make(np.random.RandomState(0))
    for k in ("boxes", "labels", "masks", "valid"):
        np.testing.assert_array_equal(getattr(t, k).numpy(), seen["targets"][k], err_msg=k)
    assert t.masks.shape == (3, 4, image_size[0] // 4, image_size[1] // 4) and t.masks.any()
    np.testing.assert_allclose(x.numpy(), np.asarray(seen["x"]), rtol=0, atol=IMAGES_ATOL)
