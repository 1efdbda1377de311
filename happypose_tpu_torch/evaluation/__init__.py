"""Evaluation: pose-error meters (ADD, ADD-S, AUC) and BOP19 scoring."""

from happypose_tpu_torch.evaluation.meters import (
    PoseErrorMeter,
    compute_auc_posecnn,
    match_poses,
)
from happypose_tpu_torch.evaluation.bop_export import (
    predictions_to_bop_csv,
    save_bop_csv,
)

__all__ = [
    "PoseErrorMeter",
    "compute_auc_posecnn",
    "match_poses",
    "predictions_to_bop_csv",
    "save_bop_csv",
]
