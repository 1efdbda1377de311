"""DeepIM-ModelNet dataset (PyTorch port's copy of
`happypose_tpu/datasets/deepim_modelnet.py`): novel-object refiner
evaluation with provided initial pose estimates. Host-side numpy.

Per-frame files
``data/real/{category}/{split}/{obj_id}_{im_id:04d}-{color,depth,label,pose}``
hold the observation and the ground-truth pose; the matching
``data/rendered/.../{obj_id}_{im_id:04d}_0-pose.txt`` holds DeepIM's
initial estimate; ``model_set/{category}_{split}.txt`` lists object ids;
the intrinsics are the fixed LINEMOD-style K.

The JAX package opens the PNG files with PIL; the port reads them with
its own codec (`utils/png.py`): colour RGB or RGBA (the first three
channels are kept), depth 16-bit grey in mm, label 8-bit grey. A layout
the codec does not read raises its `ValueError`.

Frames come back as `SceneObservation`s with poses in the camera frame
(`TWC = I`), plus `TWO_init` rows for refiner-only evaluation.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Union

import numpy as np

from happypose_tpu_torch.datasets.bop import SceneObservation
from happypose_tpu_torch.utils.png import read_png

# fixed intrinsics of the DeepIM ModelNet renders
MODELNET_K = np.asarray(
    [[572.4114, 0.0, 325.2611], [0.0, 573.57043, 242.04899], [0.0, 0.0, 1.0]],
    np.float32,
)


def parse_pose(pose_str: str) -> np.ndarray:
    """The last three lines of the file are the 3x4 row-major pose."""
    rows = pose_str.strip().split("\n")[-3:]
    T = np.eye(4, dtype=np.float32)
    for r in range(3):
        T[r, :] = np.asarray([float(x) for x in rows[r].split()])
    return T


def bbox_from_label_mask(label: np.ndarray, obj_value: int = 1) -> np.ndarray:
    """xyxy bbox of the object pixels in a label image (zeros if none)."""
    ys, xs = np.where(label == obj_value)
    if len(xs) == 0:
        return np.zeros(4, np.float32)
    return np.asarray([xs.min(), ys.min(), xs.max(), ys.max()], np.float32)


@dataclass
class _Frame:
    obj_id: str
    im_id: int


class DeepImModelNetDataset:
    """ModelNet test frames + DeepIM initial estimates.

    `self.frames` lists (scene_id, view_id) like `BOPSceneDataset` so it
    plugs into `DistributedSceneSampler` / `PredictionRunner`; scene_id is
    a per-object integer index, the string object id is the label.
    """

    def __init__(
        self,
        modelnet_dir: Union[str, Path],
        category: str,
        split: str = "test",
        n_objects: int = 70,
        n_images_per_object: int = 50,
        load_depth: bool = False,
        label_format: str = "{label}",
    ):
        self.root = Path(modelnet_dir)
        self.data_dir = self.root / "modelnet_render_v1" / "data"
        self.category = category
        self.split = split
        self.load_depth = load_depth
        self.label_format = label_format

        ids_file = self.root / "model_set" / f"{category}_{split}.txt"
        self.object_ids: List[str] = ids_file.read_text().splitlines()[:n_objects]
        self._frames: List[_Frame] = [
            _Frame(obj_id, im_id)
            for obj_id in self.object_ids
            for im_id in range(n_images_per_object)
        ]
        self.frames = [(self.object_ids.index(f.obj_id), f.im_id) for f in self._frames]

    def __len__(self) -> int:
        return len(self._frames)

    def _path(self, kind: str, f: _Frame, rendered: bool = False) -> Path:
        sub = "rendered" if rendered else "real"
        suffix = "_0" if rendered else ""
        return (
            self.data_dir / sub / self.category / self.split
            / f"{f.obj_id}_{f.im_id:04d}{suffix}-{kind}"
        )

    def __getitem__(self, idx: int) -> SceneObservation:
        f = self._frames[idx]
        rgb = read_png(self._path("color.png", f))[..., :3]
        depth: Optional[np.ndarray] = None
        if self.load_depth:
            depth = np.asarray(read_png(self._path("depth.png", f)), np.float32) / 1000.0
        label_im = read_png(self._path("label.png", f))
        # pose files store the camera-from-object transform of the frame
        TCO = parse_pose(self._path("pose.txt", f).read_text())
        TCO_init = parse_pose(self._path("pose.txt", f, rendered=True).read_text())
        label = self.label_format.format(label=f.obj_id)
        return SceneObservation(
            rgb=rgb,
            K=MODELNET_K.copy(),
            depth=depth,
            TWC=np.eye(4, dtype=np.float32),
            obj_labels=[label],
            TWO=TCO[None],
            TWO_init=TCO_init[None],
            bboxes=bbox_from_label_mask(label_im)[None],
            visib_fract=np.ones(1, np.float32),
            scene_id=self.object_ids.index(f.obj_id),
            view_id=f.im_id,
        )
