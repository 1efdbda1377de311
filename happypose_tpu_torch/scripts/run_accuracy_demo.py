"""End-to-end accuracy demo: the full MegaPose pipeline on held-out
synthetic scenes, scored at the reference's end-to-end test tolerance
(PyTorch port of `happypose_tpu/scripts/run_accuracy_demo.py`).

Pipeline: SO(3)-grid coarse classification -> top-K hypotheses ->
N-iteration render-and-compare refinement -> coarse re-scoring -> top-1;
the success metric is `||log6(T^-1 T_hat)|| < 0.3`. Detections are the
ground truth's projected-point boxes.

Needs a trained refiner and, optionally, a trained coarse classifier: run
directories of the port written by `run_pose_training` on the SAME
`--synth-set` / `--mesh-files` registry (`config.json` + `state_dict.pt`),
or the JAX package's (`checkpoint.msgpack`). Without a coarse run
directory the pipeline runs the CosyPose flavour (detection-box z-up +
autodepth init -> refiner), a refiner-only demo. Every render goes through
the hand-written rasterizer on `--device` (default `cuda`).

Usage:
  python -m happypose_tpu_torch.scripts.run_accuracy_demo \\
      --refiner-dir /tmp/refiner --coarse-dir /tmp/coarse \\
      --synth-set textured --mesh-files <mesh.ply> --out /tmp/demo.json
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from happypose_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

TOLERANCE = 0.3  # log6 norm of the reference's end-to-end test


def build_model(run_dir: Path, coarse: bool, device):
    """The pose model of a run directory of the port, in eval mode on
    `device`: a refiner, or with `coarse` a hypothesis classifier."""
    from happypose_tpu_torch.models.pose_predictor import PosePredictor
    from happypose_tpu_torch.utils.load_model import config_from_run_dir, read_state_dict

    model = PosePredictor(config_from_run_dir(run_dir, coarse=coarse))
    model.load_state_dict(read_state_dict(run_dir))
    return model.to(device).eval()


def scene_batch(assets, K1, n_objects: int, batch_size: int, resolution, seed: int,
                force_obj_ids: Optional[torch.Tensor] = None):
    """One batch of held-out synthetic scenes, drawn from `seed` on the
    device of `K1` (a `torch.Generator`, so not JAX's scenes)."""
    from happypose_tpu_torch.training.synth_data import make_synth_batch, sample_synth_scenes

    g = torch.Generator(device=K1.device).manual_seed(seed)
    return make_synth_batch(assets, K1, sample_synth_scenes(
        g, n_objects, batch_size, resolution, force_obj_ids=force_obj_ids))


def evaluate_batch(estimator, batch) -> Dict[str, np.ndarray]:
    """Run the pipeline on a batch's scenes from their ground-truth boxes;
    the final top-1 pose of each scene and its errors against the ground
    truth: `log6`, rotation (degrees), translation and ADD (m)."""
    from happypose_tpu_torch.inference.types import DetectionBatch, ObservationBatch
    from happypose_tpu_torch.lib3d.camera import masked_boxes_from_uv, project_points_robust
    from happypose_tpu_torch.lib3d.distances import compute_ADD_L1_loss
    from happypose_tpu_torch.lib3d.rotations import geodesic_distance, log_SE3_norm

    bm = estimator.meshes
    dev = batch.K.device
    inst = bm.select(batch.obj_ids)
    uv = project_points_robust(inst.points, batch.K, batch.TCO_gt)
    boxes = masked_boxes_from_uv(uv, inst.points_mask)
    det = DetectionBatch.from_numpy(
        boxes=boxes.cpu().numpy(), obj_ids=batch.obj_ids.cpu().numpy(),
        batch_im_ids=np.arange(batch.TCO_gt.shape[0]), device=dev,
    )
    final = estimator.run_inference_pipeline(ObservationBatch(rgb=batch.images, K=batch.K),
                                             det)["final"]
    # final is top-1 per detection: recover per-image rows
    keep = final.valid
    T = final.poses[keep]
    im_ids = final.batch_im_ids[keep]
    G = batch.TCO_gt[im_ids]
    inst_k = bm.select(batch.obj_ids[im_ids])
    out = {
        "poses": T,
        "batch_im_ids": im_ids,
        "log6": log_SE3_norm(T, G),
        "rot_deg": geodesic_distance(T[:, :3, :3], G[:, :3, :3]) * 180.0 / np.pi,
        "trans_m": torch.sqrt(((T[:, :3, 3] - G[:, :3, 3]) ** 2).sum(dim=-1)),
        "add_m": compute_ADD_L1_loss(G, T, inst_k.points, inst_k.points_mask),
    }
    return {k: v.cpu().numpy() for k, v in out.items()}


def summarize(per_batch: List[Dict[str, np.ndarray]], args) -> dict:
    """The JAX package's summary keys over every scored scene."""
    cat = {k: np.concatenate([b[k] for b in per_batch])
           for k in ("log6", "rot_deg", "trans_m", "add_m")}
    log6 = cat["log6"]
    return {
        "n_scenes": int(log6.size),
        "tolerance": TOLERANCE,
        "frac_within_tolerance": float((log6 < TOLERANCE).mean()),
        "log6_median": float(np.median(log6)),
        "log6_mean": float(log6.mean()),
        "rot_deg_median": float(np.median(cat["rot_deg"])),
        "trans_m_median": float(np.median(cat["trans_m"])),
        "add_m_median": float(np.median(cat["add_m"])),
        "so3_grid": args.so3_grid,
        "n_hypotheses": args.n_hypotheses,
        "n_refiner_iterations": args.n_refiner_iterations,
        "coarse": args.coarse_dir is not None,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--refiner-dir", type=Path, required=True)
    p.add_argument("--coarse-dir", type=Path, default=None)
    p.add_argument("--synth-set", default="textured")
    p.add_argument("--mesh-files", type=Path, nargs="*", default=None)
    p.add_argument("--max-faces", type=int, default=0)
    p.add_argument("--n-scenes", type=int, default=64)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--image-size", type=int, nargs=2, default=(120, 160))
    p.add_argument("--so3-grid", type=int, default=576)
    p.add_argument("--n-hypotheses", type=int, default=5)
    p.add_argument("--n-refiner-iterations", type=int, default=5)
    p.add_argument("--only-labels", nargs="*", default=None,
                   help="restrict eval scenes to these labels (e.g. mesh0 "
                        "to score only the real mesh, not the symmetric "
                        "sphere)")
    p.add_argument("--seed", type=int, default=777)
    p.add_argument("--out", type=Path, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device of the models, the renders and the scenes")
    args = p.parse_args(argv)

    from happypose_tpu_torch.inference.pose_estimator import PoseEstimator
    from happypose_tpu_torch.inference.types import InferenceConfig
    from happypose_tpu_torch.training.synth_data import make_synth_mesh_db

    dev = torch.device(args.device)
    db = make_synth_mesh_db(args.synth_set, args.mesh_files, max_faces=args.max_faces)
    assets = db.render_assets(device=dev)
    H, W = args.image_size
    K1 = torch.tensor([[300.0, 0, W / 2], [0, 300.0, H / 2], [0, 0, 1.0]], device=dev)
    estimator = PoseEstimator(
        refiner=build_model(args.refiner_dir, coarse=False, device=dev),
        coarse=(build_model(args.coarse_dir, coarse=True, device=dev)
                if args.coarse_dir is not None else None),
        assets=assets,
        meshes=db.batched(n_points=256, device=dev),
        cfg=InferenceConfig(
            n_refiner_iterations=args.n_refiner_iterations,
            n_pose_hypotheses=args.n_hypotheses,
            SO3_grid_size=args.so3_grid,
        ),
    )
    only_ids = (
        None if args.only_labels is None
        else np.asarray([db.id_of(label) for label in args.only_labels], np.int64)
    )

    per_batch = []
    n_batches = -(-args.n_scenes // args.batch_size)
    for b in range(n_batches):
        forced = None
        if only_ids is not None:
            rs = np.random.RandomState(args.seed + b)
            forced = torch.from_numpy(
                only_ids[rs.randint(0, len(only_ids), args.batch_size)]).to(dev)
        batch = scene_batch(assets, K1, len(db.labels), args.batch_size, (H, W),
                            args.seed + b, forced)
        per_batch.append(evaluate_batch(estimator, batch))
        logger.info(f"batch {b}: median log6 {float(np.median(per_batch[-1]['log6'])):.3f}")

    summary = summarize(per_batch, args)
    logger.info(json.dumps(summary, indent=1))
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
