"""Visualization: detection/pose overlays rendered to images."""

from happypose_tpu_torch.visualization.plotter import (
    draw_boxes,
    make_contour_overlay,
    make_pose_overlay,
)

__all__ = ["draw_boxes", "make_contour_overlay", "make_pose_overlay"]
