"""The MegaPose and CosyPose single-view pipelines, the detector wrapper and
their data types."""

from happypose_tpu_torch.inference.types import (
    ObservationBatch,
    DetectionBatch,
    PoseEstimateBatch,
    InferenceConfig,
)
from happypose_tpu_torch.inference.pose_estimator import PoseEstimator

__all__ = [
    "ObservationBatch",
    "DetectionBatch",
    "PoseEstimateBatch",
    "InferenceConfig",
    "PoseEstimator",
]
