"""BOP challenge result export.

Parity target: happypose/pose_estimators/megapose/evaluation/
bop.py:68-160 (`convert_results_to_bop`): one csv row per estimate with
scene_id, im_id, obj_id, score, R (9 floats, row-major), t (mm), time.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np


def predictions_to_bop_csv(
    poses: np.ndarray,  # [N, 4, 4] (meters)
    obj_ids: np.ndarray,  # [N] BOP object ids (1-based dataset convention)
    scene_ids: np.ndarray,  # [N]
    view_ids: np.ndarray,  # [N]
    scores: np.ndarray,  # [N]
    times: Optional[np.ndarray] = None,  # [N] seconds, -1 if unknown
) -> List[str]:
    """Render csv lines (no header) in the bop_toolkit inout format."""
    n = len(poses)
    times = times if times is not None else np.full(n, -1.0)
    lines = []
    for i in range(n):
        R = np.asarray(poses[i][:3, :3], np.float64).reshape(-1)
        t_mm = np.asarray(poses[i][:3, 3], np.float64) * 1000.0
        lines.append(
            "{scene},{im},{obj},{score:.8f},{R},{t},{time:.6f}".format(
                scene=int(scene_ids[i]),
                im=int(view_ids[i]),
                obj=int(obj_ids[i]),
                score=float(scores[i]),
                R=" ".join(f"{x:.8f}" for x in R),
                t=" ".join(f"{x:.8f}" for x in t_mm),
                time=float(times[i]),
            )
        )
    return lines


def save_bop_csv(
    path: Union[str, Path],
    poses: np.ndarray,
    obj_ids: np.ndarray,
    scene_ids: np.ndarray,
    view_ids: np.ndarray,
    scores: np.ndarray,
    times: Optional[np.ndarray] = None,
) -> None:
    lines = predictions_to_bop_csv(
        poses, obj_ids, scene_ids, view_ids, scores, times
    )
    header = "scene_id,im_id,obj_id,score,R,t,time"
    Path(path).write_text("\n".join([header] + lines) + "\n")


def load_bop_csv(path: Union[str, Path]) -> Dict[str, np.ndarray]:
    """Read a BOP csv back into arrays (poses in meters)."""
    rows = Path(path).read_text().strip().splitlines()
    if rows and rows[0].startswith("scene_id"):
        rows = rows[1:]
    n = len(rows)
    poses = np.tile(np.eye(4, dtype=np.float64), (n, 1, 1))
    scene = np.zeros(n, np.int64)
    im = np.zeros(n, np.int64)
    obj = np.zeros(n, np.int64)
    score = np.zeros(n, np.float64)
    time_ = np.zeros(n, np.float64)
    for i, row in enumerate(rows):
        parts = row.split(",")
        scene[i], im[i], obj[i] = int(parts[0]), int(parts[1]), int(parts[2])
        score[i] = float(parts[3])
        R = np.fromstring(parts[4], sep=" ").reshape(3, 3)
        t = np.fromstring(parts[5], sep=" ") / 1000.0
        poses[i, :3, :3] = R
        poses[i, :3, 3] = t
        time_[i] = float(parts[6])
    return {
        "poses": poses, "scene_ids": scene, "view_ids": im, "obj_ids": obj,
        "scores": score, "times": time_,
    }


def load_external_detections(
    path: Union[str, Path], label_format: str = "obj_{:06d}"
) -> Dict[tuple, dict]:
    """Load BOP-challenge-format detections (e.g. CNOS / default detections).

    Parity target: `load_external_detections`
    (happypose/pose_estimators/megapose/evaluation/
    bop.py:233-296): a json list of records with scene_id, image_id,
    category_id, bbox (x, y, w, h) and score, converted to per-frame
    (x1, y1, x2, y2) boxes + labels. Returns the `external_detections`
    mapping consumed by `PredictionRunner`: {(scene_id, view_id):
    {"boxes", "labels", "scores"}}."""
    import json

    recs = json.loads(Path(path).read_text())
    per_frame: Dict[tuple, dict] = {}
    for r in recs:
        key = (int(r["scene_id"]), int(r["image_id"]))
        x, y, w, h = (float(v) for v in r["bbox"])
        d = per_frame.setdefault(
            key, {"boxes": [], "labels": [], "scores": []}
        )
        d["boxes"].append([x, y, x + w, y + h])
        d["labels"].append(label_format.format(int(r["category_id"])))
        d["scores"].append(float(r.get("score", 1.0)))
    for d in per_frame.values():
        d["boxes"] = np.asarray(d["boxes"], np.float32)
        d["scores"] = np.asarray(d["scores"], np.float32)
    return per_frame


def load_bop_targets(path: Union[str, Path]) -> List[dict]:
    """Read a BOP test-targets json (test_targets_bop19.json)."""
    import json

    return json.loads(Path(path).read_text())


def keep_best_detections(
    detections: Dict[tuple, dict],
    targets: List[dict],
    label_format: str = "obj_{:06d}",
) -> Dict[tuple, dict]:
    """Filter external detections to the eval targets: per (scene, image,
    object) keep only the `inst_count` best-scored detections.

    Parity target: `keep_best_detections`
    (happypose/pose_estimators/megapose/evaluation/
    bop.py:299-336). Detections of objects not listed as targets for the
    frame are dropped."""
    budget: Dict[tuple, int] = {}
    for t in targets:
        key = (
            int(t["scene_id"]),
            int(t["im_id"]),
            label_format.format(int(t["obj_id"])),
        )
        budget[key] = int(t.get("inst_count", 1))
    out: Dict[tuple, dict] = {}
    for (scene_id, view_id), d in detections.items():
        order = np.argsort(-d["scores"])
        remaining = dict(budget)
        keep = []
        for i in order:
            key = (scene_id, view_id, d["labels"][i])
            if remaining.get(key, 0) > 0:
                remaining[key] -= 1
                keep.append(int(i))
        if keep:
            keep = sorted(keep)
            out[(scene_id, view_id)] = {
                "boxes": d["boxes"][keep],
                "labels": [d["labels"][i] for i in keep],
                "scores": d["scores"][keep],
            }
    return out
