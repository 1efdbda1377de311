"""Datasets: BOP scene and object readers, training iterators, augmentations."""

from happypose_tpu_torch.datasets.bop import (
    BOPObjectDataset,
    BOPSceneDataset,
    SceneObservation,
)
from happypose_tpu_torch.datasets.datasets_cfg import (
    make_object_dataset,
    make_scene_dataset,
)
from happypose_tpu_torch.datasets.samplers import DistributedSceneSampler

__all__ = [
    "BOPObjectDataset",
    "BOPSceneDataset",
    "SceneObservation",
    "DistributedSceneSampler",
    "make_object_dataset",
    "make_scene_dataset",
]
