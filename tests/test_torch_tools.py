"""The tools of the last slice, the PyTorch port against the JAX package:
the DeepIM-ModelNet reader, `preprocess_object_dataset`, `download`,
`utils/resources`, and run directories of the new backbones
(`efficientnet_b3`, `flownet`) from training to serving through
`run_accuracy_demo` (held to JAX's CLI in `test_torch_accuracy_demo.py`).
"""

import argparse
import json
import logging
import os
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from happypose_tpu.datasets import datasets_cfg as jcfg
from happypose_tpu.datasets import deepim_modelnet as jdm
from happypose_tpu.meshes import io as jio
from happypose_tpu.scripts import download as jdl
from happypose_tpu.scripts import preprocess_object_dataset as jpre
from happypose_tpu.utils import resources as jres
from happypose_tpu_torch.datasets import datasets_cfg as tcfg
from happypose_tpu_torch.datasets import deepim_modelnet as tdm
from happypose_tpu_torch.scripts import download as tdl
from happypose_tpu_torch.scripts import preprocess_object_dataset as tpre
from happypose_tpu_torch.scripts import run_accuracy_demo as tdemo
from happypose_tpu_torch.utils import resources as tres
from test_torch_models import icosphere

torch.set_num_threads(2)


# ----------------------------------------------------------- DeepIM-ModelNet

def _modelnet_tree(root: Path) -> Path:
    """`tests/test_modelnet_flownet.py`'s fixture, written with PIL (whose
    PNG rows carry the Average / Paeth filters the port's codec undoes):
    2 chair objects x 2 frames, 48x64 colour, 16-bit depth in mm, an 8-bit
    label, the ground-truth and DeepIM's initial pose files."""
    cat, split = "chair", "test"
    (root / "model_set").mkdir(parents=True)
    (root / "model_set" / f"{cat}_{split}.txt").write_text("chair_0001\nchair_0002\n")
    real = root / "modelnet_render_v1" / "data" / "real" / cat / split
    rend = root / "modelnet_render_v1" / "data" / "rendered" / cat / split
    real.mkdir(parents=True)
    rend.mkdir(parents=True)
    rs = np.random.RandomState(0)
    for obj in ("chair_0001", "chair_0002"):
        for im in range(2):
            stem = f"{obj}_{im:04d}"
            Image.fromarray(rs.randint(0, 255, (48, 64, 3), dtype=np.uint8)).save(
                real / f"{stem}-color.png")
            Image.fromarray((rs.rand(48, 64) * 2000).astype(np.uint16)).save(
                real / f"{stem}-depth.png")
            lab = np.zeros((48, 64), np.uint8)
            lab[10 + im:30, 20:50 - obj.count("2")] = 1
            Image.fromarray(lab).save(real / f"{stem}-label.png")
            T = np.eye(4)
            T[:3, :3] = np.asarray([[0, -1, 0], [1, 0, 0], [0, 0, 1]]) if im else np.eye(3)
            T[:3, 3] = [0.01 * im, -0.02, 0.8]
            (real / f"{stem}-pose.txt").write_text(
                "header line\n" + "\n".join(" ".join(str(x) for x in T[r]) for r in range(3)))
            T[0, 3] += 0.05
            (rend / f"{stem}_0-pose.txt").write_text(
                "\n".join(" ".join(str(x) for x in T[r]) for r in range(3)))
    return root


def _assert_same_observation(ours, ref):
    for name in ("rgb", "K", "depth", "TWC", "TWO", "TWO_init", "bboxes", "visib_fract"):
        a, b = getattr(ours, name), getattr(ref, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert ours.obj_labels == ref.obj_labels
    assert (ours.scene_id, ours.view_id) == (ref.scene_id, ref.view_id)


@pytest.mark.parametrize("load_depth", [False, True])
def test_deepim_modelnet_reads_what_jax_reads(tmp_path, load_depth):
    """Every frame of the DeepIM tree through both readers (the port's PNG
    codec against PIL): every field equal, dtypes included; the frame index
    and the object ids too."""
    root = _modelnet_tree(tmp_path)
    kw = dict(n_objects=2, n_images_per_object=2, load_depth=load_depth,
              label_format="modelnet_{label}")
    ours = tdm.DeepImModelNetDataset(root, "chair", **kw)
    ref = jdm.DeepImModelNetDataset(root, "chair", **kw)
    assert len(ours) == len(ref) == 4
    assert ours.frames == ref.frames and ours.object_ids == ref.object_ids
    for i in range(len(ref)):
        _assert_same_observation(ours[i], ref[i])
    assert ours[3].bboxes.tolist() == [[20.0, 11.0, 48.0, 29.0]]
    np.testing.assert_array_equal(tdm.MODELNET_K, jdm.MODELNET_K)


def test_deepim_helpers_match_jax():
    lab = np.zeros((40, 60), np.uint8)
    lab[10:20, 25:45] = 1
    for label in (lab, np.zeros((8, 8), np.uint8), lab * 2):
        np.testing.assert_array_equal(tdm.bbox_from_label_mask(label),
                                      jdm.bbox_from_label_mask(label))
    text = "a header\n1 0 0 0.1\n0 1 0 -0.2\n0 0 1 0.9\n"
    np.testing.assert_array_equal(tdm.parse_pose(text), jdm.parse_pose(text))


def test_deepim_names_resolve_in_the_registry(tmp_path):
    """`make_scene_dataset("deepim.modelnet-chair-test")` returns the port's
    reader over `<data_dir>/modelnet`, as JAX's returns its own."""
    _modelnet_tree(tmp_path / "modelnet")
    ours = tcfg.make_scene_dataset("deepim.modelnet-chair-test", data_dir=tmp_path,
                                   load_depth=True)
    ref = jcfg.make_scene_dataset("deepim.modelnet-chair-test", data_dir=tmp_path,
                                  load_depth=True)
    assert isinstance(ours, tdm.DeepImModelNetDataset)
    assert (ours.category, ours.split, ours.load_depth) == ("chair", "test", True)
    assert ours.root == ref.root and ours.frames == ref.frames
    # n_images_per_object defaults to 50: frame 0 is in the tree
    _assert_same_observation(ours[0], ref[0])


def test_deepim_reader_refuses_what_its_codec_cannot_read(tmp_path):
    """A palette PNG (PIL's mode "P") raises the codec's `ValueError`,
    naming the file: there is no PIL branch."""
    root = _modelnet_tree(tmp_path)
    path = root / "modelnet_render_v1/data/real/chair/test/chair_0001_0000-color.png"
    Image.open(path).convert("P").save(path)
    with pytest.raises(ValueError, match="chair_0001_0000-color.png"):
        tdm.DeepImModelNetDataset(root, "chair", n_objects=1, n_images_per_object=1)[0]


# --------------------------------------------------- preprocess_object_dataset

@pytest.fixture(scope="module")
def mesh_dir(tmp_path_factory):
    """`tests/test_preprocess_cli.py`'s meshes: a colourless UV sphere and a
    position-coloured box in a subdirectory; plus an OBJ icosphere."""
    root = tmp_path_factory.mktemp("meshes")
    (root / "sub").mkdir()
    sphere = jio.make_uv_sphere(0.05, 12, 16)
    jio.save_ply(root / "sphere.ply", jio.Mesh(vertices=sphere.vertices, faces=sphere.faces))
    jio.save_ply(root / "sub" / "box.ply", jio.position_colored(jio.make_box_mesh((0.04, 0.03, 0.05))))
    v, f, _ = icosphere(0.03, 1)
    (root / "sub" / "ico.obj").write_text(
        "".join(f"v {x:.6f} {y:.6f} {z:.6f}\n" for x, y, z in v)
        + "".join(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in f))
    return root


def _files(root: Path):
    """Every file under `root`, through symlinked directories too."""
    return sorted(Path(d, f).relative_to(root) for d, _, files in os.walk(root, followlinks=True)
                  for f in files)


@pytest.mark.parametrize("argv", [
    ["scale", "--target-diameter", "0.2"], ["scale", "--scale", "1000"],
    ["pointclouds", "--n-points", "256"], ["pointclouds", "--n-points", "300", "--seed", "3"],
])
def test_preprocess_writes_jax_files(mesh_dir, tmp_path, argv):
    """`scale` writes JAX's PLY files byte for byte; `pointclouds` draws from
    `RandomState(--seed)` in JAX's order: the same points and normals in
    every `.npz` (fewer vertices than points for the box: drawn with
    repeats; more for the spheres: without)."""
    outs = {}
    for name, main in (("ours", tpre.main), ("ref", jpre.main)):
        out = tmp_path / name
        assert main([argv[0], "--in-dir", str(mesh_dir), "--out-dir", str(out)] + argv[1:]) == 0
        outs[name] = out
    files = _files(outs["ref"])
    assert _files(outs["ours"]) == files and len(files) == 3
    for rel in files:
        a, b = outs["ours"] / rel, outs["ref"] / rel
        if rel.suffix == ".ply":
            assert a.read_bytes() == b.read_bytes(), rel
        else:
            with np.load(a) as x, np.load(b) as y:
                assert sorted(x) == sorted(y) == ["normals", "points"]
                for k in x:
                    np.testing.assert_array_equal(x[k], y[k], err_msg=f"{rel}:{k}")


def test_preprocess_stats_and_subsets_match_jax(mesh_dir, tmp_path):
    """`stats` writes JAX's json byte for byte; `subset` with each filter
    (faces, vertices, diameters, colours, a count) writes JAX's lists."""
    for name, main in (("ours", tpre.main), ("ref", jpre.main)):
        assert main(["stats", "--in-dir", str(mesh_dir), "--out",
                     str(tmp_path / name / "stats.json")]) == 0
    stats = (tmp_path / "ref" / "stats.json").read_bytes()
    assert (tmp_path / "ours" / "stats.json").read_bytes() == stats
    assert set(json.loads(stats)) == {"sphere.ply", "sub/box.ply", "sub/ico.obj"}
    for filters in (["--max-faces", "100"], ["--max-vertices", "50"], ["--min-diameter", "0.07"],
                    ["--max-diameter", "0.07"], ["--require-colors"], ["--n-objects", "2"], []):
        lists = []
        for name, main in (("ours", tpre.main), ("ref", jpre.main)):
            out = tmp_path / name / "subset.json"
            assert main(["subset", "--stats", str(tmp_path / "ref" / "stats.json"),
                         "--out", str(out)] + filters) == 0
            lists.append(out.read_bytes())
        assert lists[0] == lists[1], filters


# ------------------------------------------------------------------ download

def _namespace(**kw):
    base = dict(bop_dataset=None, megapose_models=False, cosypose_models=None, examples=None)
    return argparse.Namespace(**{**base, **kw})


@pytest.mark.parametrize("request_kw", [
    dict(bop_dataset=["ycbv", "tless"], megapose_models=True, cosypose_models=["run-1"],
         examples=["barbecue-sauce"]),
    dict(examples=["demo"]), dict(),
])
def test_download_requests_match_jax(request_kw):
    args = _namespace(**request_kw)
    assert tdl.gather_requests(args) == jdl.gather_requests(args)


def test_download_links_and_copies_the_tree_jax_does(tmp_path):
    """From a local mirror: the same exit codes (2 without a mirror, 3 for
    a missing asset, 1 for nothing asked), and the same tree linked (a
    symlink to the mirror's directory) and copied; a second run skips what
    is there."""
    mirror = tmp_path / "mirror"
    for rel in ("examples/demo/f.txt", "bop_datasets/ycbv/models/m.ply", "megapose-models/w.pt"):
        (mirror / rel).parent.mkdir(parents=True, exist_ok=True)
        (mirror / rel).write_text(rel)
    env = os.environ.pop(tdl.MIRROR_ENV, None)
    try:
        for name, main in (("ours", tdl.main), ("ref", jdl.main)):
            base = ["--data-dir", str(tmp_path / name / "d")]
            assert main(["--examples", "demo"] + base) == 2
            assert main(["--bop_dataset", "lm", "--mirror", str(mirror)] + base) == 3
            assert main(base) == 1
            want = ["--examples", "demo", "--bop_dataset", "ycbv", "--megapose_models",
                    "--mirror", str(mirror)]
            for flag, data in (([], "link"), (["--copy"], "copy")):
                argv = want + ["--data-dir", str(tmp_path / name / data)] + flag
                assert main(argv) == 0 and main(argv) == 0
    finally:
        if env is not None:
            os.environ[tdl.MIRROR_ENV] = env
    for data in ("link", "copy"):
        ours, ref = tmp_path / "ours" / data, tmp_path / "ref" / data
        assert _files(ours) == _files(ref) and len(_files(ref)) == 3
        for top in ("examples/demo", "bop_datasets/ycbv", "megapose-models"):
            assert (ours / top).is_symlink() == (ref / top).is_symlink() == (data == "link")
            if data == "link":
                assert os.readlink(ours / top) == os.readlink(ref / top)
        for rel in _files(ref):
            assert (ours / rel).read_text() == (ref / rel).read_text() == str(rel)


# ----------------------------------------------------------------- resources

def test_resources_keys_and_units(caplog):
    """`get_device_memory` has JAX's keys in GiB; a CPU device reports
    nothing (zeros, as JAX's CPU backend); `get_total_memory` is this
    process's resident set in GiB, as JAX reads it; `log_memory` writes
    JAX's line."""
    ours = tres.get_device_memory("cpu")
    ref = jres.get_device_memory()
    assert ours == ref == {"bytes_in_use_gib": 0.0, "peak_bytes_in_use_gib": 0.0,
                           "bytes_limit_gib": 0.0}
    rss = tres.get_total_memory()
    with open("/proc/self/status") as f:
        kib = int(next(line for line in f if line.startswith("VmRSS:")).split()[1])
    assert 0.01 < rss < 64 and abs(rss - kib / 2**20) < 0.1
    assert abs(rss - jres.get_total_memory()) < 0.1
    logger = logging.getLogger("test_torch_tools.resources")
    with caplog.at_level(logging.INFO, logger=logger.name):
        tres.log_memory(logger, prefix="step 3: ", device="cpu")
        jres.log_memory(logger, prefix="step 3: ")
    ours_line, ref_line = [r.getMessage() for r in caplog.records]
    strip = lambda s: s.rsplit("host_rss=", 1)[0]  # noqa: E731  (the RSS moves between calls)
    assert strip(ours_line) == strip(ref_line) == "step 3: device=0.00GiB (peak 0.00) "


# ------------------------------------------ run directories of the new backbones

TINY = ["--data", "synth", "--synth-set", "textured", "--epoch-size", "4", "--batch-size", "2",
        "--image-size", "48", "64", "--render-size", "32", "48", "--device", "cpu"]


@pytest.fixture(scope="module")
def backbone_runs(tmp_path_factory):
    """`run_pose_training` run directories: an EfficientNet-B3 refiner and
    coarse classifier, a FlowNetS refiner (1 epoch of 2 steps each)."""
    from happypose_tpu_torch.scripts import run_pose_training

    root = tmp_path_factory.mktemp("backbone_runs")
    for name, extra in (("b3_refiner", ["--backbone", "efficientnet_b3"]),
                        ("b3_coarse", ["--backbone", "efficientnet_b3", "--model-type", "coarse",
                                       "--coarse-hypotheses", "3"]),
                        ("flownet_refiner", ["--backbone", "flownet"])):
        assert run_pose_training.main(["--run-dir", str(root / name), "--epochs", "1"]
                                      + extra + TINY) == 0
    return root


def test_new_backbones_train_resume_and_reload(backbone_runs, tmp_path):
    """Each run directory names its backbone; `--resume` trains a second
    epoch from it; `spec_from_checkpoints` + `load_named_model` rebuild
    both models from `config.json` (no `KeyError` for the new names) with
    the saved weights."""
    import shutil

    from happypose_tpu_torch.scripts import run_pose_training
    from happypose_tpu_torch.training.synth_data import make_synth_mesh_db
    from happypose_tpu_torch.utils.load_model import (
        load_named_model, read_state_dict, spec_from_checkpoints,
    )

    for name, backbone in (("b3_refiner", "efficientnet_b3"), ("b3_coarse", "efficientnet_b3"),
                           ("flownet_refiner", "flownet")):
        cfg = json.loads((backbone_runs / name / "config.json").read_text())
        assert cfg["backbone"] == backbone and cfg["render_size"] == [32, 48]
        (line,) = [json.loads(x) for x in (backbone_runs / name / "log.txt").read_text().splitlines()]
        assert np.isfinite(line["loss"]) and line["skipped_nonfinite"] == 0
    run = tmp_path / "resumed"
    shutil.copytree(backbone_runs / "flownet_refiner", run)
    assert run_pose_training.main(["--run-dir", str(run), "--epochs", "2", "--resume",
                                   "--backbone", "flownet"] + TINY) == 0
    assert [json.loads(x)["epoch"] for x in (run / "log.txt").read_text().splitlines()] == [0, 1]
    for dirs in ({"refiner": backbone_runs / "b3_refiner", "coarse": backbone_runs / "b3_coarse"},
                 {"refiner": backbone_runs / "flownet_refiner"}):
        spec = spec_from_checkpoints(dirs)
        est = load_named_model(spec, make_synth_mesh_db("textured"), n_points=64, device="cpu",
                               checkpoint_dirs=dirs)
        for role, run_dir in dirs.items():
            model = est.refiner_model if role == "refiner" else est.coarse_model
            assert model.cfg.backbone == json.loads((run_dir / "config.json").read_text())["backbone"]
            saved = read_state_dict(run_dir)
            assert all(torch.equal(model.state_dict()[k], v) for k, v in saved.items())


def test_new_backbones_serve_through_the_clis(backbone_runs, tmp_path):
    """`eval_refiner_checkpoint` and `eval_coarse_checkpoint` read the
    EfficientNet-B3 runs, and `run_accuracy_demo` serves both flavours from
    them (B3 refiner + coarse; FlowNetS refiner alone): finite summaries."""
    from happypose_tpu_torch.datasets.bop import SceneObservation, write_bop_models, write_bop_scene
    from happypose_tpu_torch.meshes.database import MeshDataBase
    from happypose_tpu_torch.scripts import eval_coarse_checkpoint, eval_refiner_checkpoint
    from happypose_tpu_torch.training.synth_data import make_synth_mesh_db

    assert eval_refiner_checkpoint.main([
        "--run-dir", str(backbone_runs / "b3_refiner"), "--n-batches", "1", "--batch-size", "2",
        "--image-size", "48", "64", "--n-iterations", "1", "--device", "cpu",
        "--out", str(tmp_path / "refiner.json")]) == 0
    summary = json.loads((tmp_path / "refiner.json").read_text())
    assert summary["n_samples"] == 2 and np.isfinite(summary["add_after"])

    db = make_synth_mesh_db("textured")
    write_bop_models(tmp_path / "models", MeshDataBase({"obj_000001": db.meshes["box"]}))
    TWO = np.eye(4, dtype=np.float32)
    TWO[2, 3] = 0.5
    write_bop_scene(tmp_path / "test", 1, [SceneObservation(
        rgb=np.full((48, 64, 3), 90, np.uint8),
        K=np.asarray([[120.0, 0, 32], [0, 120.0, 24], [0, 0, 1]], np.float32),
        obj_labels=["obj_000001"], TWO=TWO[None], bboxes=np.asarray([[20.0, 12, 44, 36]], np.float32),
        visib_fract=np.ones(1, np.float32))])
    out = tmp_path / "coarse.json"
    assert eval_coarse_checkpoint.main([
        "--coarse-dir", str(backbone_runs / "b3_coarse"), "--split-dir", str(tmp_path / "test"),
        "--models-dir", str(tmp_path / "models"), "--so3-grid", "72", "--device", "cpu",
        "--out", str(out)]) == 0
    assert json.loads(out.read_text())["summary"]["n_detections"] == 1

    common = ["--synth-set", "textured", "--image-size", "48", "64", "--batch-size", "2",
              "--n-scenes", "2", "--so3-grid", "72", "--n-hypotheses", "1",
              "--n-refiner-iterations", "1", "--device", "cpu"]
    for dirs in (["--refiner-dir", str(backbone_runs / "b3_refiner"),
                  "--coarse-dir", str(backbone_runs / "b3_coarse")],
                 ["--refiner-dir", str(backbone_runs / "flownet_refiner")]):
        out = tmp_path / "demo.json"
        assert tdemo.main(dirs + common + ["--out", str(out)]) == 0
        summary = json.loads(out.read_text())
        assert summary["n_scenes"] == 2 and summary["coarse"] == ("--coarse-dir" in dirs)
        assert all(np.isfinite(v) for v in summary.values() if isinstance(v, float))
