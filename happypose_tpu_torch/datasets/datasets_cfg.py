"""String registry for scene / object datasets.

Parity target: happypose/toolbox/datasets/datasets_cfg.py
(`make_scene_dataset` :66-246, `make_object_dataset` :248-435) — the
reference's ~400-line if/elif chain over hardcoded BOP splits. Here the
same naming conventions resolve data-driven against one root directory
(``HAPPYPOSE_DATA_DIR``, layout produced by `scripts/download.py`):

Scene datasets (`make_scene_dataset`):
  "<ds>.bop19"        BOP test split, filtered to test_targets_bop19.json
  "<ds>.pbr"          train_pbr split
  "<ds>.<split>"      any split directory (e.g. "ycbv.train_real")
  "webdataset.<dir>"  webdataset shard directory (`WebSceneDataset`)
  "deepim.modelnet-<category>-<split>"  DeepIM-ModelNet frames
                      (`<root>/modelnet`)
  "<path>"            any explicit BOP split directory

Object datasets (`make_object_dataset`):
  "<ds>.cad" / "<ds>" BOP models dir (models_info symmetries)
  "gso.normalized"    GoogleScannedObjects (normalized meshes, scaled 0.1)
  "shapenet"          ShapeNetCore normalized models
  "meshdir.<path>"    any directory of mesh files
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional, Union

# BOP test splits that are not named plain "test"
_BOP_TEST_SPLIT = {
    "tless": "test_primesense",
    "hb": "test_primesense",
    "tyol": "test",
}
# per-dataset label prefixes the reference applies (datasets_cfg.py:72-107)
BOP_DATASETS = (
    "lm", "lmo", "tless", "tudl", "icbin", "itodd", "hb", "ycbv", "hope",
)


def _data_dir(override: Optional[Union[str, Path]]) -> Path:
    return Path(
        override or os.environ.get("HAPPYPOSE_DATA_DIR", "local_data")
    )


def keep_bop19_targets(ds, targets_path: Path):
    """Filter a BOPSceneDataset's frame index to the BOP19 test targets
    (reference `keep_bop19`, datasets_cfg.py:52-63)."""
    import json

    targets = json.loads(Path(targets_path).read_text())
    wanted = {(int(t["scene_id"]), int(t["im_id"])) for t in targets}
    ds.frames = [f for f in ds.frames if f in wanted]
    return ds


def make_scene_dataset(
    ds_name: str,
    data_dir: Optional[Union[str, Path]] = None,
    load_depth: bool = False,
    n_frames: Optional[int] = None,
):
    from happypose_tpu_torch.datasets.bop import BOPSceneDataset

    root = _data_dir(data_dir)

    if ds_name.startswith("webdataset."):
        from happypose_tpu_torch.datasets.web_scene_dataset import WebSceneDataset

        return WebSceneDataset(ds_name.split(".", 1)[1])

    if ds_name.startswith("deepim.modelnet-"):
        from happypose_tpu_torch.datasets.deepim_modelnet import DeepImModelNetDataset

        _, category, split = ds_name.split(".", 1)[1].split("-")
        return DeepImModelNetDataset(
            root / "modelnet", category, split=split, load_depth=load_depth
        )

    if "." in ds_name and not os.path.sep in ds_name:
        name, split = ds_name.split(".", 1)
        bop_dir = root / "bop_datasets" / name
        if split == "bop19":
            real_split = _BOP_TEST_SPLIT.get(name, "test")
            ds = BOPSceneDataset(
                bop_dir / real_split, load_depth=load_depth
            )
            targets = bop_dir / "test_targets_bop19.json"
            if targets.exists():
                keep_bop19_targets(ds, targets)
            return _truncate(ds, n_frames)
        if split == "pbr":
            split = "train_pbr"
        return _truncate(
            BOPSceneDataset(bop_dir / split, load_depth=load_depth), n_frames
        )

    # explicit path to a split directory
    return _truncate(
        BOPSceneDataset(ds_name, load_depth=load_depth), n_frames
    )


def _truncate(ds, n_frames: Optional[int]):
    if n_frames is not None:
        ds.frames = ds.frames[:n_frames]
    return ds


def make_object_dataset(
    ds_name: str, data_dir: Optional[Union[str, Path]] = None
):
    from happypose_tpu_torch.datasets.bop import BOPObjectDataset
    from happypose_tpu_torch.datasets.object_datasets import (
        GoogleScannedObjectDataset,
        MeshDirDataset,
        ShapeNetObjectDataset,
    )

    root = _data_dir(data_dir)

    if ds_name.startswith("meshdir."):
        return MeshDirDataset(ds_name.split(".", 1)[1])
    if ds_name.startswith("gso"):
        return GoogleScannedObjectDataset(root / "google_scanned_objects")
    if ds_name.startswith("shapenet"):
        return ShapeNetObjectDataset(root / "shapenetcorev2")

    name = ds_name.split(".", 1)[0]  # "<ds>.cad" and "<ds>" both -> models
    models = root / "bop_datasets" / name / "models"
    if not models.exists() and Path(ds_name).exists():
        models = Path(ds_name)
    return BOPObjectDataset(models)
