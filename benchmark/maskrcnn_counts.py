"""What the Mask R-CNN cell counts from shapes: the frame's multiply-
accumulates (the published layers at the frame's size and the program's
fixed counts of RoIs), and each hand-written kernel's bytes and operations
for the least time of its roofline. Bytes are a floor: what the call's
inputs must bring from device memory at least once and its outputs must
write once, so that no share can read over 100%.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np

from benchmark import flops

RESNET50 = (3, 4, 6, 3)
ROI_FLOPS_PER_SAMPLE = 8  # four taps weighed and summed (7), the bin's sum (1)


def level_sizes(h: int, w: int):
    """(H, W) of P2-P6 of a frame padded to a multiple of 32."""
    hp, wp = -(-h // 32) * 32, -(-w // 32) * 32
    sizes = [(hp // s, wp // s) for s in (4, 8, 16, 32)]
    return sizes + [(-(-sizes[-1][0] // 2), -(-sizes[-1][1] // 2))]


def frame_macs(cfg: Dict, h: int, w: int) -> Dict[str, int]:
    """MACs of one frame by part: the ResNet50 trunk, the FPN (laterals and
    3x3 outputs at P2-P5), the RPN head at P2-P6, the box head on the
    proposals' slots, the mask branch on the detections' slots."""
    c, K = cfg["fpn_channels"], cfg["n_classes"]
    A = len(cfg["aspect_ratios"])
    sizes = level_sizes(h, w)
    pix = [a * b for a, b in sizes]
    hp, wp = -(-h // 32) * 32, -(-w // 32) * 32
    trunk = flops.resnet_macs(RESNET50, True, 3, hp, wp, 0)
    fpn = sum(p * c * cin for p, cin in zip(pix[:4], (256, 512, 1024, 2048)))
    fpn += sum(9 * c * c * p for p in pix[:4])
    rpn = sum(p * (9 * c * c + c * A + c * 4 * A) for p in pix)
    R, rep = cfg["rpn_post_nms_top_n"], cfg["representation_size"]
    box = R * (c * cfg["box_roi_size"] ** 2 * rep + rep * rep + rep * K + rep * 4 * K)
    D, m = cfg["detections_per_img"], cfg["mask_roi_size"]
    mask, cin = 0, c
    for width in cfg["mask_layers"]:
        mask += D * m * m * 9 * cin * width
        cin = width
    mask += D * m * m * cin * cin * 4  # the 2x2 transposed conv of stride 2
    mask += D * (2 * m) ** 2 * cin * K
    return {"trunk": trunk, "fpn": fpn, "rpn": rpn, "box": box, "mask": mask}


def nms_bytes(n: int, batch: int = 1) -> int:
    """NMS over n candidates: the boxes (16 bytes), groups (4) and flags
    (1) read once, the [n, ceil(n / 64)] bitmask of 64-bit words written
    once."""
    return batch * (21 * n + 8 * n * math.ceil(n / 64))


def _touched(starts, bins, size: int, S: int, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per RoI along one axis: the samples' coordinates and whether each is
    inside (-1, n], and the indices of the rows or columns its taps read."""
    k = np.arange(size * S)
    v = starts[:, None] + (k // S)[None] * bins[:, None] + ((k % S) + 0.5)[None] * bins[:, None] / S
    inside = (v >= -1.0) & (v <= n)
    v = np.clip(v, 0, None)
    lo = np.minimum(np.floor(v).astype(np.int64), n - 1)
    hi = np.minimum(lo + 1, n - 1)
    return inside, np.stack([lo, hi], -1)


def roi_align_work(level_hw: Sequence[Tuple[int, int]], scales: Sequence[float], channels: int,
                   rois: np.ndarray, levels: np.ndarray, size: int,
                   S: int) -> Tuple[int, int]:
    """(bytes, flops) of one RoIAlign call over rois [R, 4] at levels [R]:
    the outputs written once, and each feature value that some RoI's taps
    touch read once (the union over the call's RoIs, each level's values
    counted once); flops `ROI_FLOPS_PER_SAMPLE` a sample."""
    R = len(rois)
    n_bytes = 4 * R * channels * size * size
    for lvl, ((H, W), scale) in enumerate(zip(level_hw, scales)):
        sel = levels == lvl
        if not sel.any():
            continue
        b = rois[sel].astype(np.float64) * scale
        rw = np.maximum(b[:, 2] - b[:, 0], 1.0) / size
        rh = np.maximum(b[:, 3] - b[:, 1], 1.0) / size
        iy, ty = _touched(b[:, 1], rh, size, S, H)
        ix, tx = _touched(b[:, 0], rw, size, S, W)
        hit = np.zeros((H, W), bool)
        for r in range(len(b)):
            rows, cols = np.unique(ty[r][iy[r]]), np.unique(tx[r][ix[r]])
            hit[np.ix_(rows, cols)] = True
        n_bytes += 4 * channels * int(hit.sum())
    return n_bytes, R * channels * size * size * S * S * ROI_FLOPS_PER_SAMPLE
