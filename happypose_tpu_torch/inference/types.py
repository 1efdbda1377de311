"""Inference data types — fixed-shape dataclasses of tensors with validity
masks (PyTorch port of `happypose_tpu/inference/types.py`)."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from happypose_tpu_torch.utils.profiling import annotate


@dataclass
class ObservationBatch:
    """Observed images + intrinsics: rgb [B, 3, H, W] float in [0, 1],
    K [B, 3, 3], depth [B, 1, H, W] or None."""

    rgb: torch.Tensor
    K: torch.Tensor
    depth: Optional[torch.Tensor] = None

    @property
    def batch_size(self) -> int:
        return self.rgb.shape[0]

    @property
    def images(self) -> torch.Tensor:
        """[B, 3(+1), H, W] with depth as the 4th channel when present."""
        if self.depth is None:
            return self.rgb
        return torch.cat([self.rgb, self.depth], dim=1)

    @staticmethod
    def from_numpy(
        rgb: np.ndarray, K: np.ndarray, depth: Optional[np.ndarray] = None,
        device="cuda",
    ) -> "ObservationBatch":
        """rgb uint8 or float [H, W, 3] or [B, H, W, 3] -> ObservationBatch."""
        with annotate("obs.upload"):
            if rgb.ndim == 3:
                rgb = rgb[None]
            if rgb.dtype == np.uint8:
                rgb = rgb.astype(np.float32) / 255.0
            if K.ndim == 2:
                K = K[None]
            d = None
            if depth is not None:
                if depth.ndim == 2:
                    depth = depth[None]
                d = torch.from_numpy(depth[:, None].astype(np.float32)).to(device)
            return ObservationBatch(
                rgb=torch.from_numpy(np.moveaxis(rgb, -1, 1).astype(np.float32)).to(device),
                K=torch.from_numpy(K.astype(np.float32)).to(device),
                depth=d,
            )


@dataclass
class DetectionBatch:
    """2D detections across a batch of images: boxes [N, 4] (x1, y1, x2,
    y2); obj_ids [N] (index into the mesh database); batch_im_ids [N];
    instance_ids [N] (running index within an (image, object) group);
    scores [N]; valid [N] bool."""

    boxes: torch.Tensor
    obj_ids: torch.Tensor
    batch_im_ids: torch.Tensor
    instance_ids: torch.Tensor
    scores: torch.Tensor
    valid: torch.Tensor

    @property
    def n_rows(self) -> int:
        return self.boxes.shape[0]

    @staticmethod
    def pad(det: "DetectionBatch", n: int) -> "DetectionBatch":
        """At most `n` rows: with more, the `n` best scored are kept (a
        stable descending sort: among equal scores the earlier row wins,
        as `np.argsort(-scores)` does in the JAX package). Fewer rows come
        back as they are: the JAX package pads them up to `n` so that XLA
        compiles one program, which PyTorch has no use for."""
        if det.n_rows <= n:
            return det
        order = torch.sort(det.scores, descending=True, stable=True).indices[:n]
        return DetectionBatch(
            **{f.name: getattr(det, f.name)[order] for f in dataclasses.fields(det)}
        )

    @staticmethod
    def from_numpy(
        boxes: np.ndarray,
        obj_ids: np.ndarray,
        batch_im_ids: Optional[np.ndarray] = None,
        scores: Optional[np.ndarray] = None,
        device="cuda",
    ) -> "DetectionBatch":
        with annotate("obs.upload"):
            n = len(boxes)
            if batch_im_ids is None:
                batch_im_ids = np.zeros((n,), np.int64)
            if scores is None:
                scores = np.ones((n,), np.float32)
            inst = np.zeros((n,), np.int64)
            seen = {}
            for i in range(n):
                key = (int(batch_im_ids[i]), int(obj_ids[i]))
                inst[i] = seen.get(key, 0)
                seen[key] = inst[i] + 1

            def t(x, dtype):
                return torch.from_numpy(np.asarray(x).astype(dtype)).to(device)

            return DetectionBatch(
                boxes=t(boxes, np.float32),
                obj_ids=t(obj_ids, np.int64),
                batch_im_ids=t(batch_im_ids, np.int64),
                instance_ids=t(inst, np.int64),
                scores=t(scores, np.float32),
                valid=torch.ones((n,), dtype=torch.bool, device=device),
            )


@dataclass
class PoseEstimateBatch:
    """Pose hypotheses/estimates: poses [N, 4, 4]; per-instance K [N, 3, 3];
    detection metadata; coarse and scoring-model logits; valid [N] bool."""

    poses: torch.Tensor
    K: torch.Tensor
    obj_ids: torch.Tensor
    batch_im_ids: torch.Tensor
    instance_ids: torch.Tensor
    hypothesis_ids: torch.Tensor
    scores: torch.Tensor  # detection score (carried through)
    coarse_logits: torch.Tensor
    pose_logits: torch.Tensor
    valid: torch.Tensor

    @property
    def n_rows(self) -> int:
        return self.poses.shape[0]

    def select(self, idx: torch.Tensor) -> "PoseEstimateBatch":
        return PoseEstimateBatch(
            **{f.name: getattr(self, f.name)[idx] for f in dataclasses.fields(self)}
        )

    def mask_where(self, keep: torch.Tensor) -> "PoseEstimateBatch":
        """The same rows, valid where they were valid and `keep` holds."""
        return replace_valid(self, self.valid & keep)


def replace_valid(pe: PoseEstimateBatch, valid: torch.Tensor) -> PoseEstimateBatch:
    """`pe` with its validity mask replaced (the other fields are shared)."""
    return dataclasses.replace(pe, valid=valid)


@dataclass(frozen=True)
class InferenceConfig:
    """Pipeline configuration: 5 refiner iterations, 1 CosyPose coarse
    iteration, an SO(3) grid of 576 and 5 kept pose hypotheses (MegaPose:
    each refined, re-scored, then top-1), the batch sizes the hypothesis
    axis is cut into, and whether the final poses are refined against the
    observed depth (`depth_refiner`: "teaserpp", anything else is ICP)."""

    n_refiner_iterations: int = 5
    n_coarse_iterations: int = 1  # CosyPose-style coarse
    n_pose_hypotheses: int = 5
    SO3_grid_size: int = 576
    bsz_images: int = 288  # coarse hypotheses per forward chunk
    bsz_objects: int = 16  # refiner instances per forward chunk
    run_depth_refiner: bool = False
    depth_refiner: Optional[str] = None  # icp
