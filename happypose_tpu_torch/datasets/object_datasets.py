"""Non-BOP object dataset loaders: GSO, ShapeNet, plain mesh directories.

Parity targets: happypose/toolbox/datasets/
{gso_dataset.py, shapenet_object_dataset.py, urdf_dataset.py} — directory
conventions for the novel-object training corpora (the reference trains
MegaPose on >20k of these meshes). Loading is lazy: `MeshDataBase` is built
from a label->path map and meshes decode on first access (native fastply
when possible), so a 20k-object registry doesn't parse 20k files upfront.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Union

from happypose_tpu_torch.meshes.database import MeshDataBase
from happypose_tpu_torch.meshes.io import Mesh, load_mesh


class LazyMeshDict(dict):
    """dict[label] -> Mesh, decoding from disk on first access."""

    def __init__(self, paths: Dict[str, Path], scale: float = 1.0):
        super().__init__()
        self._paths = paths
        self._scale = scale

    def keys(self):
        return self._paths.keys()

    def __contains__(self, k):
        return k in self._paths

    def __len__(self):
        return len(self._paths)

    def __missing__(self, label: str) -> Mesh:
        mesh = load_mesh(self._paths[label])
        if self._scale != 1.0:
            mesh = mesh.scaled(self._scale)
        self[label] = mesh
        return mesh


def _db_from_paths(paths: Dict[str, Path], scale: float) -> MeshDataBase:
    db = MeshDataBase.__new__(MeshDataBase)
    db.labels = sorted(paths.keys())
    db.label_to_id = {l: i for i, l in enumerate(db.labels)}
    db.meshes = LazyMeshDict(paths, scale)
    db.symmetries = {}
    db.scales = {}
    return db


class GoogleScannedObjectDataset:
    """GSO layout: <root>/models_normalized/<obj_id>/meshes/model.obj
    (reference gso_dataset.py; labels `gso_<obj_id>`)."""

    def __init__(self, root: Union[str, Path], split: str = "orig"):
        root = Path(root)
        paths = {}
        for d in sorted((root / "models_normalized").glob("*")):
            obj = d / "meshes" / "model.obj"
            if obj.exists():
                paths[f"gso_{d.name}"] = obj
        self.mesh_db = _db_from_paths(paths, scale=1.0)
        self.labels: List[str] = self.mesh_db.labels


class ShapeNetObjectDataset:
    """ShapeNetCore layout: <root>/<synset>/<source_id>/models/
    model_normalized.obj (reference shapenet_object_dataset.py; labels
    `shapenet_<synset>_<source>`)."""

    def __init__(self, root: Union[str, Path]):
        root = Path(root)
        paths = {}
        for synset in sorted(root.glob("[0-9]*")):
            for src in sorted(synset.glob("*")):
                obj = src / "models" / "model_normalized.obj"
                if obj.exists():
                    paths[f"shapenet_{synset.name}_{src.name}"] = obj
        self.mesh_db = _db_from_paths(paths, scale=1.0)
        self.labels: List[str] = self.mesh_db.labels


class MeshDirDataset:
    """Any directory of .ply/.obj meshes; labels = file stems (the plain
    RigidObjectDataset entry point, reference object_dataset.py:146)."""

    def __init__(self, root: Union[str, Path], scale: float = 1.0):
        root = Path(root)
        paths = {
            p.stem: p
            for p in sorted(root.iterdir())
            if p.suffix.lower() in (".ply", ".obj")
        }
        self.mesh_db = _db_from_paths(paths, scale)
        self.labels: List[str] = self.mesh_db.labels
