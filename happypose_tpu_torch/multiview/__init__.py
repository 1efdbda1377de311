"""Multi-view scene reconstruction: RANSAC candidate matching + object-level
bundle adjustment (CosyPose stage 2), PyTorch port of
`happypose_tpu/multiview/`."""

from happypose_tpu_torch.multiview.ransac import (
    MultiviewCandidates,
    multiview_candidate_matching,
)
from happypose_tpu_torch.multiview.bundle_adjustment import MultiviewRefinement

__all__ = [
    "MultiviewCandidates",
    "multiview_candidate_matching",
    "MultiviewRefinement",
]
