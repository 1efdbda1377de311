"""Streaming pose-training batches from WebDataset tar shards (PyTorch
port of `happypose_tpu/datasets/streaming_pose_dataset.py`).

Parity target: the reference's megapose/training/train_megapose.py:96-229
(a webdataset pipeline behind DataLoader worker processes) and
toolbox/datasets/web_scene_dataset.py:54-252: training data larger than
host or device memory.

A worker thread (`utils/prefetch.py`) decodes shard samples into chunks of
`chunk_frames` uint8 frames with a table of their (frame, object) samples,
`prefetch_chunks` ahead. The training iterator moves one chunk to the
device at a time and gathers batches there by index, as `PoseDataset`'s
device cache does, while the next chunk decodes on the host. The picks
follow the JAX package's `np.random.RandomState` streams, so the port
yields the JAX package's samples for a seed; the colour jitter's draws come
from a `torch.Generator`. Call `stop()` (in a `finally`) to end the thread;
a decode error is raised in the training loop.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from happypose_tpu_torch.datasets.augmentations import (
    crop_resize_to_aspect,
    rgb_jitter,
    sample_rgb_jitter,
)
from happypose_tpu_torch.datasets.pose_dataset import rank_slice, to_images, valid_objects
from happypose_tpu_torch.datasets.web_scene_dataset import IterableWebSceneDataset
from happypose_tpu_torch.meshes.database import MeshDataBase
from happypose_tpu_torch.training.forward_loss import PoseTrainingBatch
from happypose_tpu_torch.utils.prefetch import PrefetchIterator


@dataclass
class Chunk:
    """One decoded chunk: frames and the flat (frame, object) sample table."""

    frames: np.ndarray  # [N, H, W, 3] uint8
    sample_frame: np.ndarray  # [S] frame index of each sample
    sample_K: np.ndarray  # [S, 3, 3]
    sample_obj_id: np.ndarray  # [S] mesh-database ids
    sample_TCO: np.ndarray  # [S, 4, 4]


@dataclass
class StreamingPoseDataset:
    """Infinite pose-training batches on `device` from a directory of WDS
    shards. Each chunk is staged on the device once and sampled for
    `samples_per_chunk_pass * n_samples / batch_size` batches; the shard
    order reshuffles every pass over the stream."""

    shards_dir: str
    mesh_db: MeshDataBase
    batch_size: int = 16
    resolution: tuple = (240, 320)
    chunk_frames: int = 512
    prefetch_chunks: int = 2
    samples_per_chunk_pass: float = 1.0
    min_visib_fract: float = 0.1
    min_area: float = 64.0
    keep_labels: Optional[Sequence[str]] = None
    apply_rgb_augmentation: bool = True
    seed: int = 0
    device: str = "cuda"
    rank_block: Tuple[int, int] = (0, 1)  # (rank, world): this process's block of a batch
    _chunks: Optional[PrefetchIterator] = field(default=None, repr=False)

    def __post_init__(self):
        if not sorted(Path(self.shards_dir).glob("*.tar")):
            raise FileNotFoundError(
                f"no WDS *.tar shards in {self.shards_dir}: the stream would yield nothing")

    def decode_chunks(self) -> Iterator[Chunk]:
        """The chunks, decoded in turn (the worker thread runs this)."""
        stream = iter(IterableWebSceneDataset(
            self.shards_dir, buffer_size=max(32, self.chunk_frames // 4), seed=self.seed))
        while True:
            frames, sf, sK, so, sT = [], [], [], [], []
            while len(frames) < self.chunk_frames:
                obs = next(stream)
                cand = valid_objects(obs, self.mesh_db, self.keep_labels,
                                     self.min_visib_fract, self.min_area)
                if not cand:
                    continue
                for j in cand:
                    sf.append(len(frames))
                    sK.append(obs.K)
                    so.append(self.mesh_db.id_of(obs.obj_labels[j]))
                    sT.append(obs.TWO[j])
                frames.append(obs.rgb)
            yield Chunk(
                frames=np.stack(frames),
                sample_frame=np.asarray(sf, np.int64),
                sample_K=np.stack(sK).astype(np.float32),
                sample_obj_id=np.asarray(so, np.int64),
                sample_TCO=np.stack(sT).astype(np.float32),
            )

    def stop(self) -> None:
        """End the decode thread of the running iteration."""
        if self._chunks is not None:
            self._chunks.close()

    def __iter__(self) -> Iterator[PoseTrainingBatch]:
        dev = torch.device(self.device)
        rng = np.random.RandomState(self.seed + 1)
        generator = torch.Generator(device=dev).manual_seed(self.seed)
        block = rank_slice(self.batch_size, self.rank_block)
        self._chunks = chunks = PrefetchIterator(self.decode_chunks(), self.prefetch_chunks)
        try:
            for chunk in chunks:
                frames_dev = torch.from_numpy(chunk.frames).to(dev)
                S = len(chunk.sample_frame)
                n_batches = max(1, int(self.samples_per_chunk_pass * S) // self.batch_size)
                for _ in range(n_batches):
                    sel = rng.randint(S, size=self.batch_size)[block]
                    frames = frames_dev[torch.from_numpy(chunk.sample_frame[sel]).to(dev)]
                    imgs, K = crop_resize_to_aspect(
                        to_images(frames), torch.from_numpy(chunk.sample_K[sel]).to(dev),
                        self.resolution)
                    if self.apply_rgb_augmentation:
                        jitter = sample_rgb_jitter(generator, self.batch_size)
                        imgs = rgb_jitter(imgs, {k: v[block] for k, v in jitter.items()})
                    yield PoseTrainingBatch(
                        images=imgs,
                        K=K,
                        obj_ids=torch.from_numpy(chunk.sample_obj_id[sel]).to(dev),
                        TCO_gt=torch.from_numpy(chunk.sample_TCO[sel]).to(dev),
                    )
        finally:
            chunks.close()
