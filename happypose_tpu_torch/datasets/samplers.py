"""Deterministic frame sharding across processes/hosts.

Parity target: happypose/toolbox/datasets/samplers.py:38-52
(`DistributedSceneSampler`: permute frame indices with a fixed seed, then
np.array_split per rank)."""

from __future__ import annotations

from typing import List

import numpy as np


class DistributedSceneSampler:
    """Static, deterministic split of frame indices per rank."""

    def __init__(self, n_frames: int, num_replicas: int, rank: int,
                 shuffle: bool = True, seed: int = 0):
        indices = np.arange(n_frames)
        if shuffle:
            indices = np.random.RandomState(seed).permutation(indices)
        self.indices: List[int] = np.array_split(indices, num_replicas)[rank].tolist()

    def __iter__(self):
        return iter(self.indices)

    def __len__(self):
        return len(self.indices)


class PartialSampler:
    """First-epoch-size sample of a dataset (reference samplers.py:20-35)."""

    def __init__(self, n_frames: int, epoch_size: int, seed: int = 0):
        epoch_size = min(epoch_size, n_frames)
        self.indices = np.random.RandomState(seed).permutation(n_frames)[
            :epoch_size
        ].tolist()

    def __iter__(self):
        return iter(self.indices)

    def __len__(self):
        return len(self.indices)


class RandomIterableSceneDataset:
    """Infinite uniform-random frame stream over one scene dataset.

    Parity: toolbox/datasets/scene_dataset.py:466-489
    (`RandomIterableSceneDataset`). Deterministic per seed."""

    def __init__(self, scene_ds, seed: int = 0):
        self.scene_ds = scene_ds
        self.rng = np.random.RandomState(seed)

    def __iter__(self):
        while True:
            yield self.scene_ds[int(self.rng.randint(len(self.scene_ds)))]


class IterableMultiSceneDataset:
    """Infinite random mixing of several iterable scene datasets.

    Parity: toolbox/datasets/scene_dataset.py:492-522
    (`IterableMultiSceneDataset`): each step picks a child stream uniformly
    and yields its next sample — the reference's mechanism for training on
    a mixture (e.g. pbr + real splits)."""

    def __init__(self, iterable_datasets: List, seed: int = 0):
        self.datasets = iterable_datasets
        self.rng = np.random.RandomState(seed)

    def __iter__(self):
        iters = [iter(ds) for ds in self.datasets]
        while True:
            yield next(iters[int(self.rng.randint(len(iters)))])
