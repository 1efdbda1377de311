"""Image overlays for qualitative results (numpy; `draw_boxes` draws its
rectangles and text with PIL and imports it there; no GUI deps).

Parity targets: the reference's BokehPlotter detection plots
(happypose/toolbox/visualization/bokeh_plotter.py:38-200)
and the contour overlays used by run_inference_on_example
(toolbox/inference/example_inference_utils.py). Bokeh/meshcat are replaced
by plain rasterized PNGs produced with the framework's own renderer.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def draw_boxes(
    rgb: np.ndarray,  # [H, W, 3] uint8
    boxes: np.ndarray,  # [N, 4] xyxy
    labels: Optional[Sequence[str]] = None,
    color: Tuple[int, int, int] = (0, 255, 0),
    width: int = 2,
) -> np.ndarray:
    """Rectangle overlays (+ optional text labels via PIL)."""
    from PIL import Image, ImageDraw

    im = Image.fromarray(rgb.copy())
    d = ImageDraw.Draw(im)
    for i, b in enumerate(np.asarray(boxes)):
        d.rectangle([float(b[0]), float(b[1]), float(b[2]), float(b[3])],
                    outline=color, width=width)
        if labels is not None:
            d.text((float(b[0]) + 2, float(b[1]) + 2), str(labels[i]),
                   fill=color)
    return np.asarray(im)


def make_contour_overlay(
    rgb: np.ndarray,  # [H, W, 3] uint8
    mask: np.ndarray,  # [H, W] bool (rendered object mask)
    color: Tuple[int, int, int] = (0, 255, 0),
    dilate: int = 1,
) -> np.ndarray:
    """Draw the mask's contour on the image (edge = mask XOR eroded mask)."""
    m = np.asarray(mask, bool)
    er = m.copy()
    for _ in range(max(dilate, 1)):
        er = (
            er
            & np.roll(er, 1, 0) & np.roll(er, -1, 0)
            & np.roll(er, 1, 1) & np.roll(er, -1, 1)
        )
    edge = m & ~er
    out = rgb.copy()
    out[edge] = color
    return out


def make_pose_overlay(
    rgb: np.ndarray,  # [H, W, 3] uint8
    render_rgb: np.ndarray,  # [H, W, 3] float render at predicted pose
    render_mask: np.ndarray,  # [H, W] bool
    alpha: float = 0.6,
) -> np.ndarray:
    """Blend the rendered object over the photo (standard qualitative viz)."""
    out = rgb.astype(np.float32) / 255.0
    r = np.asarray(render_rgb, np.float32)
    m = np.asarray(render_mask, bool)[..., None]
    out = np.where(m, (1 - alpha) * out + alpha * r, out)
    return (np.clip(out, 0, 1) * 255).astype(np.uint8)
