"""Measure the refinement of a trained refiner run directory.

PyTorch port of `happypose_tpu/scripts/eval_refiner_checkpoint.py`:
held-out synthetic scenes from the mesh registry the run was trained on,
initial poses from the training noise model (`--init-mode noise`) or the
nearest SO(3)-grid rotation with autodepth translation from the projected
ground-truth box (`--init-mode grid`, what the coarse stage hands the
refiner), then the pose errors before and after refinement: translation,
rotation, ADD and the reference's `log6` magnitude. With `--split-dir` and
`--models-dir` the frames come from a BOP split instead (held-out recorded
frames through `PoseDataset`, no colour jitter). Writes
`<run-dir>/refiner_eval.json`. Runs on `--device` (default `cuda`): a
batch's initial poses and refinement are one CUDA graph a batch shape
(JAX's jitted `refine`), with the pose noise drawn before it and handed in.

Usage:
  python -m happypose_tpu_torch.scripts.eval_refiner_checkpoint \
      --run-dir /tmp/refiner --n-batches 8 --n-iterations 3
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from happypose_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def make_refine(model, assets, meshes, n_iterations: int, init_mode: str = "noise",
                grid_R: Optional[torch.Tensor] = None):
    """`refine(batch, noise) -> (TCO_init, TCO_refined)` (JAX's jitted
    `refine`) through one CUDA graph a batch shape (on CPU tensors, the
    same path with a plain call): the initial poses, from `noise` (the
    `sample_pose_noise` draw, `init_mode` "noise") or from the nearest
    rotation of `grid_R` with autodepth from the projected ground-truth box
    ("grid"; `noise` is None), then `n_iterations` of `model` (eval mode)."""
    from happypose_tpu_torch.lib3d.pose_init import TCO_init_from_boxes_autodepth_with_R
    from happypose_tpu_torch.lib3d.transforms import apply_pose_noise, transform_pts
    from happypose_tpu_torch.utils.cuda_graphs import GraphCache, storage_of

    def init_poses(batch, inst, noise):
        if init_mode == "noise":
            return apply_pose_noise(batch.TCO_gt, *noise)
        # nearest grid rotation (plain angle) + autodepth from the projected gt box
        tr = torch.einsum("mji,bji->bm", grid_R, batch.TCO_gt[:, :3, :3])
        ang = torch.arccos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0))
        R_init = grid_R[ang.argmin(dim=-1)]
        uv = torch.einsum("bij,bpj->bpi", batch.K, transform_pts(batch.TCO_gt, inst.points))
        uv = uv[..., :2] / torch.clamp(uv[..., 2:3], min=1e-6)
        mask = inst.points_mask[..., None]
        boxes = torch.cat([
            torch.where(mask, uv, torch.full_like(uv, 1e6)).amin(dim=1),
            torch.where(mask, uv, torch.full_like(uv, -1e6)).amax(dim=1),
        ], dim=-1)
        return TCO_init_from_boxes_autodepth_with_R(
            boxes, inst.points, batch.K, R_init, inst.points_mask)

    def body(batch, noise):
        inst = meshes.select(batch.obj_ids)
        TCO_init = init_poses(batch, inst, noise)
        out = model.eval()(batch.images, batch.K, batch.obj_ids, TCO_init, assets, inst,
                           n_iterations=n_iterations)
        return TCO_init, out.TCO_output[-1]

    graphs = GraphCache("eval")

    def refine(batch, noise):
        return graphs(("refine", storage_of(model)), body, (batch, noise),
                      captured=(model, assets, meshes, grid_R))

    return refine


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--run-dir", type=Path, required=True)
    p.add_argument("--n-batches", type=int, default=8)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--n-iterations", type=int, default=3)
    p.add_argument("--image-size", type=int, nargs=2, default=(120, 160))
    p.add_argument("--seed", type=int, default=12345)
    p.add_argument("--split-dir", type=Path, default=None,
                   help="evaluate on a BOP split instead of synth scenes")
    p.add_argument("--models-dir", type=Path, default=None,
                   help="BOP models dir (required with --split-dir)")
    p.add_argument("--out", type=Path, default=None, help="also write the summary json here")
    p.add_argument("--init-mode", choices=["noise", "grid"], default="noise",
                   help="initial poses: ground truth + training noise, or the nearest "
                        "SO(3)-grid rotation with autodepth translation from the "
                        "projected ground-truth box")
    p.add_argument("--so3-grid", type=int, default=576)
    p.add_argument("--device", default="cuda",
                   help="torch device of the model, the renders and the data")
    args = p.parse_args(argv)
    if args.split_dir is not None and args.models_dir is None:
        p.error("--split-dir needs --models-dir")

    from happypose_tpu_torch.lib3d.distances import compute_ADD_L1_loss
    from happypose_tpu_torch.lib3d.rotations import geodesic_distance, log_SE3_norm
    from happypose_tpu_torch.lib3d.so3_grid import load_SO3_grid
    from happypose_tpu_torch.lib3d.transforms import sample_pose_noise
    from happypose_tpu_torch.models.pose_predictor import PosePredictor
    from happypose_tpu_torch.training.synth_data import (
        make_synth_batch, make_synth_mesh_db, sample_synth_scenes,
    )
    from happypose_tpu_torch.utils.load_model import config_from_run_dir, read_state_dict

    dev = torch.device(args.device)
    cfg_saved = json.loads((args.run_dir / "config.json").read_text())
    split_batches = None
    if args.split_dir is not None:
        # held-out BOP frames: refine noised ground truth of recorded frames
        from happypose_tpu_torch.datasets.bop import BOPObjectDataset, BOPSceneDataset
        from happypose_tpu_torch.datasets.pose_dataset import PoseDataset

        db = BOPObjectDataset(args.models_dir).mesh_db
        split_batches = iter(PoseDataset(
            BOPSceneDataset(args.split_dir, cache_frames=True), db, batch_size=args.batch_size,
            resolution=tuple(args.image_size), apply_rgb_augmentation=False, seed=args.seed,
            device=str(dev)))
    else:
        # the mesh registry the run was trained on
        db = make_synth_mesh_db(
            cfg_saved.get("synth_set", "debug"), cfg_saved.get("mesh_files") or None,
            max_faces=int(cfg_saved.get("max_faces") or 0),
        )
    assets = db.render_assets(device=dev)
    bm = db.batched(n_points=256, device=dev)
    H, W = args.image_size
    K1 = torch.tensor([[300.0, 0, W / 2], [0, 300.0, H / 2], [0, 0, 1.0]], device=dev)

    model = PosePredictor(config_from_run_dir(args.run_dir, coarse=False))
    model.load_state_dict(read_state_dict(args.run_dir))
    model.to(dev).eval()
    grid_R = torch.from_numpy(load_SO3_grid(args.so3_grid)).to(dev)

    refine = make_refine(model, assets, bm, args.n_iterations, args.init_mode, grid_R)
    stats = {k: [] for k in ("t_before", "t_after", "r_before", "r_after", "log6_before",
                             "log6_after", "add_before", "add_after")}
    with torch.no_grad():
        for b in range(args.n_batches):
            g = torch.Generator(device=dev).manual_seed(args.seed + b)
            if split_batches is not None:
                batch = next(split_batches)
            else:
                batch = make_synth_batch(assets, K1, sample_synth_scenes(
                    g, n_objects=len(db.labels), batch_size=args.batch_size, resolution=(H, W)))
            inst = bm.select(batch.obj_ids)
            # the draw `add_pose_noise(g, ...)` makes, before the graph
            noise = (sample_pose_noise(g, batch.TCO_gt.shape[0]) if args.init_mode == "noise"
                     else None)
            TCO_init, TCO_ref = refine(batch, noise)
            gt = batch.TCO_gt
            for tag, T in (("before", TCO_init), ("after", TCO_ref)):
                stats[f"t_{tag}"].append(torch.linalg.vector_norm(T[:, :3, 3] - gt[:, :3, 3], dim=-1))
                stats[f"r_{tag}"].append(geodesic_distance(T[:, :3, :3], gt[:, :3, :3]) * 180 / np.pi)
                stats[f"log6_{tag}"].append(log_SE3_norm(T, gt))
                stats[f"add_{tag}"].append(compute_ADD_L1_loss(gt, T, inst.points, inst.points_mask))
    values = {k: torch.cat(v).cpu().numpy() for k, v in stats.items()}
    summary = {k: float(v.mean()) for k, v in values.items()}
    summary.update({f"median_{k}": float(np.median(v)) for k, v in values.items()})
    summary.update(n_samples=args.n_batches * args.batch_size, n_iterations=args.n_iterations,
                   data=str(args.split_dir) if args.split_dir else "synth",
                   init_mode=args.init_mode)
    logger.info(json.dumps(summary, indent=1))
    (args.run_dir / "refiner_eval.json").write_text(json.dumps(summary))
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
