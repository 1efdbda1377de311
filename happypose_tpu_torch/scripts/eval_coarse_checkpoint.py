"""Held-out evaluation of a coarse hypothesis classifier on a BOP split.

PyTorch port of `happypose_tpu/scripts/eval_coarse_checkpoint.py` (parity
target: the coarse model's role in the pipeline, score detection x
SO(3)-grid hypotheses and keep the top K). The pipeline needs a near-true
viewpoint to survive into the top K, so the metric is symmetry-aware
rotation recall@K: for each ground-truth object (its box as detection),
score the whole grid and check whether one of the top K hypotheses lies
within --rot-thresh-deg of the ground-truth rotation (min over the object's
symmetries). `best_achievable` is the grid's own covering error on the
same objects, the floor no classifier beats. The coarse model comes from a
run directory of the port (`config.json` + `state_dict.pt`) or of the JAX
package (`checkpoint.msgpack`) and runs on `--device` (default `cuda`).

Usage:
  python -m happypose_tpu_torch.scripts.eval_coarse_checkpoint \
      --coarse-dir <run_dir> --split-dir <bop_split> --models-dir <models> \
      --out eval_coarse.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from happypose_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--coarse-dir", type=Path, required=True)
    p.add_argument("--split-dir", type=Path, required=True)
    p.add_argument("--models-dir", type=Path, required=True)
    p.add_argument("--so3-grid", type=int, default=576)
    p.add_argument("--n-frames", type=int, default=0, help="0 = all")
    p.add_argument("--rot-thresh-deg", type=float, default=30.0)
    p.add_argument("--min-visib", type=float, default=0.3)
    p.add_argument("--out", type=Path, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device of the model and the renders")
    args = p.parse_args(argv)

    from happypose_tpu_torch.datasets.bop import BOPObjectDataset, BOPSceneDataset
    from happypose_tpu_torch.inference.pose_estimator import PoseEstimator
    from happypose_tpu_torch.inference.types import (
        DetectionBatch, InferenceConfig, ObservationBatch,
    )
    from happypose_tpu_torch.models.pose_predictor import PosePredictor
    from happypose_tpu_torch.utils.load_model import config_from_run_dir, read_state_dict

    dev = torch.device(args.device)
    mesh_db = BOPObjectDataset(args.models_dir).mesh_db
    scene_ds = BOPSceneDataset(args.split_dir)
    model = PosePredictor(config_from_run_dir(args.coarse_dir, coarse=True))
    model.load_state_dict(read_state_dict(args.coarse_dir))
    meshes = mesh_db.batched(n_points=256, device=dev)
    estimator = PoseEstimator(
        refiner=None, coarse=model.to(dev).eval(), assets=mesh_db.render_assets(device=dev),
        meshes=meshes, cfg=dataclasses.replace(InferenceConfig(), SO3_grid_size=args.so3_grid),
    )
    grid_R = estimator.SO3_grid.cpu().numpy()  # [M, 3, 3]
    M = grid_R.shape[0]
    n_frames = len(scene_ds) if args.n_frames == 0 else min(args.n_frames, len(scene_ds))
    label_to_id = mesh_db.label_to_id
    # symmetry rotations per object id
    sym_all = meshes.symmetries[..., :3, :3].cpu().numpy()  # [n_obj, S, 3, 3]
    symm_all = meshes.symmetries_mask.cpu().numpy()

    per_det = []
    for fi in range(n_frames):
        obs = scene_ds[fi]
        if obs.obj_labels is None:
            continue
        keep = [
            j for j, label in enumerate(obs.obj_labels)
            if label in label_to_id
            and (obs.visib_fract is None or obs.visib_fract[j] >= args.min_visib)
        ]
        if not keep:
            continue
        D = len(keep)
        det = DetectionBatch.from_numpy(
            np.stack([obs.bboxes[j] for j in keep]).astype(np.float32),
            np.asarray([label_to_id[obs.obj_labels[j]] for j in keep]), device=dev)
        # one CUDA graph a detection count, as JAX's script jits the stage
        coarse = estimator.forward_coarse_jit(
            ObservationBatch.from_numpy(obs.rgb, obs.K, device=dev), det)
        logits = coarse.coarse_logits.reshape(D, M).cpu().numpy()

        for d, j in enumerate(keep):
            R_gt = obs.TWO[j][:3, :3]
            oid = label_to_id[obs.obj_labels[j]]
            Rs = sym_all[oid][symm_all[oid]]  # [S, 3, 3]
            # symmetry-aware geodesic distance of every grid rotation: trace(R_hyp^T
            # (R_gt Rs)) -> angle, min over symmetries
            R_eq = np.einsum("ij,sjk->sik", R_gt, Rs)
            tr = np.trace(np.einsum("mji,sjk->msik", grid_R, R_eq), axis1=2, axis2=3)  # [M, S]
            ang = np.degrees(np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0))).min(axis=1)
            order = np.argsort(-logits[d])
            per_det.append({
                "frame": fi,
                "label": obs.obj_labels[j],
                "best_achievable_deg": float(ang.min()),
                "top1_deg": float(ang[order[0]]),
                "top5_deg": float(ang[order[:5]].min()),
                "rank_of_best": int(np.where(order == int(np.argmin(ang)))[0][0]),
            })
        if (fi + 1) % 16 == 0:
            logger.info(f"{fi + 1}/{n_frames} frames, {len(per_det)} detections")

    t = args.rot_thresh_deg
    arr = lambda k: np.asarray([r[k] for r in per_det])  # noqa: E731
    summary = {
        "n_detections": len(per_det),
        "so3_grid": M,
        "rot_thresh_deg": t,
        "best_achievable_med_deg": float(np.median(arr("best_achievable_deg"))),
        "top1_recall": float(np.mean(arr("top1_deg") < t)),
        "top5_recall": float(np.mean(arr("top5_deg") < t)),
        "top1_med_deg": float(np.median(arr("top1_deg"))),
        "top5_med_deg": float(np.median(arr("top5_deg"))),
        "rank_of_best_med": float(np.median(arr("rank_of_best"))),
    }
    logger.info(json.dumps(summary, indent=1))
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"summary": summary, "per_detection": per_det}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
