"""Models: the CNN backbones, the render-and-compare pose predictor and
the FCOS detector (`models.detector`)."""

from happypose_tpu_torch.models.backbones import (
    EfficientNetB0,
    EfficientNetB3,
    FlowNetS,
    ResNet34,
    WideResNet18,
    WideResNet34,
)
from happypose_tpu_torch.models.pose_predictor import (
    PoseOutputs,
    PosePredictor,
    PosePredictorConfig,
)

__all__ = [
    "EfficientNetB0",
    "EfficientNetB3",
    "FlowNetS",
    "ResNet34",
    "WideResNet18",
    "WideResNet34",
    "PoseOutputs",
    "PosePredictor",
    "PosePredictorConfig",
]
