"""Pose-training batches from a scene dataset (PyTorch port of
`happypose_tpu/datasets/pose_dataset.py`).

Parity target: the reference's toolbox/datasets/pose_dataset.py:108-357
(`PoseDataset`): pick a visible object a frame (visibility, area and label
filters), crop the frame to the training aspect, jitter its colours, and
emit fixed-shape batches (images, K, object ids, TCO). Frames and objects
are drawn from `np.random.RandomState(seed)`, so the port picks the JAX
package's frames and objects for a seed; the colour jitter's draws come from
a `torch.Generator` on the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from happypose_tpu_torch.datasets.augmentations import (
    crop_resize_to_aspect,
    rgb_jitter,
    sample_rgb_jitter,
)
from happypose_tpu_torch.datasets.bop import SceneObservation
from happypose_tpu_torch.meshes.database import MeshDataBase
from happypose_tpu_torch.training.forward_loss import PoseTrainingBatch
from happypose_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def valid_objects(
    obs: SceneObservation,
    mesh_db: MeshDataBase,
    keep_labels: Optional[Sequence[str]] = None,
    min_visib_fract: float = 0.1,
    min_area: float = 64.0,
) -> List[int]:
    """Indices of the frame's objects a training sample may show: known to
    the mesh database, kept by `keep_labels`, visible enough, large enough."""
    out = []
    for i, label in enumerate(obs.obj_labels or []):
        if label not in mesh_db.label_to_id:
            continue
        if keep_labels and label not in keep_labels:
            continue
        if obs.visib_fract is not None and obs.visib_fract[i] < min_visib_fract:
            continue
        bb = obs.bboxes[i]
        if (bb[2] - bb[0]) * (bb[3] - bb[1]) < min_area:
            continue
        out.append(i)
    return out


def to_images(frames: torch.Tensor) -> torch.Tensor:
    """uint8 frames [B, H, W, 3] -> float images [B, 3, H, W] in [0, 1]."""
    return frames.permute(0, 3, 1, 2).to(torch.float32) / 255.0


def rank_slice(batch_size: int, rank_block: Tuple[int, int]) -> slice:
    """The rows of a global batch that rank `rank_block[0]` of
    `rank_block[1]` makes: its contiguous block."""
    rank, world = rank_block
    if batch_size % world:
        raise ValueError(f"batch size {batch_size} does not divide by {world} ranks")
    n = batch_size // world
    return slice(rank * n, (rank + 1) * n)


@dataclass
class PoseDataset:
    """An infinite, shuffled iterator of `PoseTrainingBatch`es on `device`.

    `device_cache` stages the split's uint8 frames on the device once and
    gathers each batch there by index (a split of 4096 frames at 240x320
    takes 0.9 GB); it needs frames of one shape and uint8, and otherwise
    reads from the host as without it.

    `rank_block` = (rank, world) makes this process's contiguous block of
    each global batch of `batch_size` (data-parallel training): every rank
    draws the same picks and jitter and stages only its block's frames."""

    scene_ds: object  # BOPSceneDataset, WebSceneDataset: len() and [i] -> SceneObservation
    mesh_db: MeshDataBase
    batch_size: int = 16
    resolution: tuple = (240, 320)
    min_visib_fract: float = 0.1
    min_area: float = 64.0
    keep_labels: Optional[Sequence[str]] = None
    apply_rgb_augmentation: bool = True
    # JAX's two fields, which it declares and never reads: its batches, as
    # these, get no depth and no background augmentation. The port takes
    # the value that says so and raises on the other (`__post_init__`)
    apply_depth_augmentation: bool = False
    apply_background_augmentation: bool = False
    seed: int = 0
    device_cache: bool = False
    device: str = "cuda"
    rank_block: Tuple[int, int] = (0, 1)

    def __post_init__(self):
        for name in ("apply_depth_augmentation", "apply_background_augmentation"):
            if getattr(self, name):
                raise ValueError(f"PoseDataset({name}=True): its batches get no such "
                                 "augmentation (the JAX package declares the field and "
                                 "never reads it)")

    def _build_device_cache(self) -> Optional[torch.Tensor]:
        """[N, H, W, 3] uint8 tensor of every frame on the device, or None
        where the frames are not uniform uint8."""
        n = len(self.scene_ds)
        first = [self.scene_ds[i].rgb for i in range(min(n, 4))]
        if len({x.shape for x in first}) != 1 or first[0].dtype != np.uint8:
            logger.warning("device_cache: frames differ in shape or are not uint8; "
                           "batches are read from the host")
            return None
        frames = np.stack([self.scene_ds[i].rgb for i in range(n)])
        return torch.from_numpy(frames).to(self.device)

    def __iter__(self) -> Iterator[PoseTrainingBatch]:
        dev = torch.device(self.device)
        rng = np.random.RandomState(self.seed)
        generator = torch.Generator(device=dev).manual_seed(self.seed)
        n = len(self.scene_ds)
        frames_dev = self._build_device_cache() if self.device_cache else None
        block = rank_slice(self.batch_size, self.rank_block)
        while True:
            images, frame_idx, Ks, ids, TCOs = [], [], [], [], []
            while len(Ks) < self.batch_size:
                fi = int(rng.randint(n))
                obs = self.scene_ds[fi]
                cand = valid_objects(obs, self.mesh_db, self.keep_labels,
                                     self.min_visib_fract, self.min_area)
                if not cand:
                    continue
                j = cand[rng.randint(len(cand))]
                if frames_dev is None:
                    images.append(obs.rgb)
                else:
                    frame_idx.append(fi)
                Ks.append(obs.K)
                ids.append(self.mesh_db.id_of(obs.obj_labels[j]))
                TCOs.append(obs.TWO[j])
            images, frame_idx, Ks, ids, TCOs = (
                x[block] for x in (images, frame_idx, Ks, ids, TCOs))
            if frames_dev is None:
                frames = torch.from_numpy(np.stack(images)).to(dev)
            else:  # gather on the device: a batch's indices cross, not its images
                frames = frames_dev[torch.tensor(frame_idx, device=dev)]
            imgs, K = crop_resize_to_aspect(
                to_images(frames), torch.from_numpy(np.stack(Ks)).to(dev), self.resolution)
            if self.apply_rgb_augmentation:
                jitter = sample_rgb_jitter(generator, self.batch_size)
                imgs = rgb_jitter(imgs, {k: v[block] for k, v in jitter.items()})
            yield PoseTrainingBatch(
                images=imgs,
                K=K,
                obj_ids=torch.tensor(ids, dtype=torch.int64, device=dev),
                TCO_gt=torch.from_numpy(np.stack(TCOs).astype(np.float32)).to(dev),
            )
