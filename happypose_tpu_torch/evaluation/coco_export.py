"""COCO-format detection export.

Parity target: happypose/pose_estimators/megapose/
evaluation/bop.py:68-103 (`convert_results_to_coco`) — detection results
(bbox xywh + score + per-category id + segmentation) serialized as the
COCO json the BOP challenge's detection track consumes. The reference
polygonizes masks through bop_toolkit's pycocotools bridge; here masks are
encoded as uncompressed COCO RLE (column-major run lengths), which every
COCO consumer accepts and needs no external dependency.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np


def binary_mask_to_rle(mask: np.ndarray) -> Dict:
    """Uncompressed COCO RLE: column-major run lengths starting with the
    count of 0s."""
    mask = np.asarray(mask, np.uint8)
    H, W = mask.shape
    flat = mask.T.reshape(-1)  # column-major
    # run-length encode
    change = np.nonzero(np.diff(flat))[0] + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [flat.size]])
    runs = (ends - starts).tolist()
    counts = runs if flat[0] == 0 else [0] + runs
    return {"counts": counts, "size": [int(H), int(W)]}


def rle_to_binary_mask(rle: Dict) -> np.ndarray:
    """Inverse of `binary_mask_to_rle` (test oracle + consumers)."""
    H, W = rle["size"]
    flat = np.zeros(H * W, np.uint8)
    pos, val = 0, 0
    for run in rle["counts"]:
        flat[pos : pos + run] = val
        pos += run
        val = 1 - val
    return flat.reshape(W, H).T.astype(bool)


def detections_to_coco(
    boxes_xyxy: np.ndarray,  # [N, 4]
    scores: np.ndarray,  # [N]
    category_ids: np.ndarray,  # [N] int (BOP obj ids)
    scene_ids: np.ndarray,  # [N]
    view_ids: np.ndarray,  # [N]
    masks: Optional[np.ndarray] = None,  # [N, H, W] bool
    times: Optional[np.ndarray] = None,  # [N] seconds
) -> List[Dict]:
    """COCO annotation dicts (bbox in xywh, optional RLE segmentation)."""
    out = []
    for n in range(len(boxes_xyxy)):
        x1, y1, x2, y2 = (float(v) for v in boxes_xyxy[n])
        rec: Dict = {
            "scene_id": int(scene_ids[n]),
            "image_id": int(view_ids[n]),
            "category_id": int(category_ids[n]),
            "bbox": [x1, y1, x2 - x1, y2 - y1],
            "score": float(scores[n]),
        }
        if masks is not None:
            rec["segmentation"] = binary_mask_to_rle(masks[n])
        if times is not None:
            rec["time"] = float(times[n])
        out.append(rec)
    return out


def save_coco_json(path: Union[str, Path], records: List[Dict]) -> None:
    Path(path).write_text(json.dumps(records))


def load_coco_json(path: Union[str, Path]) -> List[Dict]:
    return json.loads(Path(path).read_text())
