"""Multi-view scene-reconstruction evaluation (PyTorch port of
`happypose_tpu/scripts/run_multiview_eval.py`): group the frames of a
scene into one view set, take single-view candidates per view, fuse them
with RANSAC matching and bundle adjustment, and report the per-view pose
errors of the candidates and of the fused scene.

Works on any BOP split whose scenes have several views with world-frame
camera poses (`cam_R_w2c`). `--synthesize` first writes such a scene
(4 views around 3 objects at 240x320, one `render_scenes` call a view and
one more a visible object, each a launch of the hand-written rasterizer on
the card); `--record-dr N` records N domain-randomized multi-view scenes
with the batched recorder. Candidates are the ground truth plus seeded
noise, or with `--checkpoints` the single-view pipeline's predictions from
run directories of the port or the JAX package (`refiner/`, `coarse/`).
Everything runs on `--device` (default `cuda`; nothing falls back to the
CPU).

Usage:
  python -m happypose_tpu_torch.scripts.run_multiview_eval \
      --out-dir /tmp/mv --synthesize --n-views 4 [--ba-solver schur]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from happypose_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def synthesize_multiview_scene(out_dir: Path, n_views: int, seed: int = 0, device="cuda"):
    """Record a BOP scene with n_views cameras around 3 world objects."""
    import torch
    from scipy.spatial.transform import Rotation as ScipyRot

    from happypose_tpu_torch.datasets.bop import SceneObservation, write_bop_scene
    from happypose_tpu_torch.lib3d.multiview_geom import look_at_R
    from happypose_tpu_torch.meshes.database import MeshDataBase
    from happypose_tpu_torch.meshes.io import (
        make_box_mesh, make_uv_sphere, position_colored, save_ply,
    )
    from happypose_tpu_torch.ops.scene_renderer import render_scenes

    rng = np.random.RandomState(seed)
    models = out_dir / "models"
    models.mkdir(parents=True, exist_ok=True)
    meshes_mm = {
        1: position_colored(make_uv_sphere(40.0, 16, 24)),
        2: position_colored(make_box_mesh((35.0, 25.0, 45.0))),
        3: position_colored(make_box_mesh((50.0, 20.0, 30.0))),
    }
    for oid, m in meshes_mm.items():
        save_ply(models / f"obj_{oid:06d}.ply", m)
    (models / "models_info.json").write_text(json.dumps(
        {str(i): {"diameter": float(m.diameter)} for i, m in meshes_mm.items()}
    ))

    db = MeshDataBase(meshes={
        f"obj_{i:06d}": m.scaled(0.001) for i, m in meshes_mm.items()
    })
    assets = db.render_assets(device=device)
    H, W = 240, 320
    K = np.eye(3, dtype=np.float32)
    K[0, 0] = K[1, 1] = 400.0
    K[0, 2], K[1, 2] = W / 2, H / 2

    n_obj = 3
    TWO = np.tile(np.eye(4, dtype=np.float32), (n_obj, 1, 1))
    TWO[:, :3, :3] = ScipyRot.random(n_obj, random_state=seed).as_matrix()
    TWO[:, :3, 3] = rng.uniform(-0.08, 0.08, (n_obj, 3))
    # cameras on an arc, each aimed at the world origin (look-at; host math)
    TWC = np.tile(np.eye(4, dtype=np.float32), (n_views, 1, 1))
    for v in range(n_views):
        ang = 0.25 * (v - (n_views - 1) / 2)
        pos = np.asarray(
            [0.55 * np.sin(ang), 0.0, -0.55 * np.cos(ang)], np.float32
        )
        R = look_at_R(
            torch.from_numpy(pos)[None], torch.from_numpy(np.zeros((1, 3), np.float32)),
            torch.from_numpy(np.asarray([[0.0, -1.0, 0.0]], np.float32)),
        ).numpy()[0]
        TWC[v, :3, :3] = R
        TWC[v, :3, 3] = pos

    def render(ids, TCO):
        n = len(ids)
        return render_scenes(
            assets, torch.as_tensor(ids, dtype=torch.int64, device=device),
            torch.zeros(n, dtype=torch.int64, device=device),
            torch.as_tensor(TCO, device=device),
            torch.as_tensor(np.tile(K[None], (n, 1, 1)), device=device),
            torch.ones(n, dtype=torch.bool, device=device), n_scenes=1, resolution=(H, W),
        )

    frames = []
    for v in range(n_views):
        TCO = np.einsum(
            "ij,ojk->oik", np.linalg.inv(TWC[v]), TWO
        ).astype(np.float32)
        out = render(np.arange(n_obj), TCO)
        depth = out.depth[0].cpu().numpy()
        labels, TCOs, bboxes = [], [], []
        for o in range(n_obj):
            solo = render([o], TCO[o: o + 1])
            m = solo.mask[0].cpu().numpy() & (
                np.abs(solo.depth[0].cpu().numpy() - depth) < 1e-4
            )
            if m.sum() < 32:
                continue
            ys, xs = np.where(m)
            labels.append(db.labels[o])
            TCOs.append(TCO[o])
            bboxes.append([xs.min(), ys.min(), xs.max(), ys.max()])
        frames.append(SceneObservation(
            rgb=(out.rgb[0].cpu().numpy() * 255).astype(np.uint8),
            K=K, TWC=TWC[v], obj_labels=labels, TWO=np.stack(TCOs),
            bboxes=np.asarray(bboxes, np.float32),
            visib_fract=np.ones(len(labels), np.float32),
            scene_id=0, view_id=v,
        ))
    write_bop_scene(out_dir / "scenes", 0, frames)
    return out_dir


def record_dr_multiview(
    models_dir: Path, out_dir: Path, n_scenes: int, n_views: int,
    seed: int = 0, device="cuda",
) -> None:
    """Record multi-view DR scenes (shared world layout, V cameras,
    world-fixed light) with the batched recorder; one BOP scene dir per
    scene."""
    from happypose_tpu_torch.datasets.bop import (
        BOPObjectDataset, SceneObservation, write_bop_scene,
    )
    from happypose_tpu_torch.datasets.scene_record import BatchedSceneRecorder
    from happypose_tpu_torch.datasets.scene_synth import SceneSynthConfig

    mesh_db = BOPObjectDataset(models_dir).mesh_db
    cfg = SceneSynthConfig(border_check=False)
    rec = BatchedSceneRecorder(mesh_db, cfg, seed=seed, device=device)
    groups = rec.record_multiview(n_scenes, n_views)
    for sid, views in enumerate(groups):
        frames = [
            SceneObservation(
                rgb=f.rgb, K=f.K, depth=f.depth, obj_labels=f.labels,
                TWO=f.TCO, bboxes=f.bboxes, visib_fract=f.visib_fract,
                scene_id=sid, view_id=v, TWC=f.TWC,
            )
            for v, f in enumerate(views)
        ]
        write_bop_scene(out_dir, sid, frames)
    logger.info(f"recorded {len(groups)} multi-view scenes to {out_dir}")


def _rot_err(T, gt):
    c = (np.trace(T[:3, :3].T @ gt[:3, :3]) - 1.0) / 2.0
    return float(np.arccos(np.clip(c, -1.0, 1.0)))


def _pipeline_candidates(obs_list, estimator, mesh_db, device="cuda"):
    """Single-view pipeline predictions (gt detections) -> candidates."""
    from happypose_tpu_torch.evaluation.prediction_runner import PredictionRunner

    runner = PredictionRunner(
        scene_ds=obs_list, estimator=estimator, mesh_db=mesh_db,
        detection_type="gt", device=device,
    )
    preds = runner.get_predictions()["final"]
    out = {}
    for r in preds:
        out[int(r["view_id"])] = r
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out-dir", type=Path, required=True)
    p.add_argument("--synthesize", action="store_true",
                   help="noise-free golden multiview scene (CI fixture)")
    p.add_argument("--record-dr", type=int, default=0, metavar="N_SCENES",
                   help="record N domain-randomized multi-view scenes "
                        "with the batched recorder (needs --models-dir)")
    p.add_argument("--models-dir", type=Path, default=None,
                   help="BOP models dir (defaults to <out-dir>/models)")
    p.add_argument("--scenes-dir", type=Path, default=None,
                   help="BOP scenes root (defaults to <out-dir>/scenes)")
    p.add_argument("--checkpoints", type=Path, default=None,
                   help="runs dir with refiner/ (and coarse/): candidates "
                        "come from the trained single-view pipeline "
                        "instead of gt+noise")
    p.add_argument("--n-refiner-iterations", type=int, default=5)
    p.add_argument("--n-views", type=int, default=4)
    p.add_argument("--candidate-noise-deg", type=float, default=1.0)
    p.add_argument("--candidate-noise-t", type=float, default=0.003)
    p.add_argument("--known-cameras", action="store_true")
    p.add_argument("--ba-solver", choices=["dense", "schur"],
                   default="dense",
                   help="bundle-adjustment solver (schur = block "
                        "elimination, scales to large scenes)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device of the renders, the pipeline, matching and BA")
    args = p.parse_args(argv)
    device = args.device

    from scipy.spatial.transform import Rotation as ScipyRot

    from happypose_tpu_torch.datasets.bop import BOPObjectDataset, BOPSceneDataset
    from happypose_tpu_torch.multiview import MultiviewCandidates
    from happypose_tpu_torch.multiview.scene_predictor import MultiviewScenePredictor

    models_dir = args.models_dir or (args.out_dir / "models")
    scenes_dir = args.scenes_dir or (args.out_dir / "scenes")
    if args.synthesize:
        synthesize_multiview_scene(args.out_dir, args.n_views, device=device)
    if args.record_dr:
        record_dr_multiview(
            models_dir, scenes_dir, args.record_dr, args.n_views,
            seed=args.seed, device=device,
        )

    obj_ds = BOPObjectDataset(models_dir)
    scene_ds = BOPSceneDataset(scenes_dir)
    bm = obj_ds.mesh_db.batched(n_points=128, device=device)
    rng = np.random.RandomState(1)

    estimator = None
    if args.checkpoints is not None:
        import dataclasses

        from happypose_tpu_torch.utils.load_model import (
            load_named_model, spec_from_checkpoints,
        )

        dirs = {
            kind: args.checkpoints / kind
            for kind in ("refiner", "coarse")
            if (args.checkpoints / kind).exists()
        }
        spec = spec_from_checkpoints(dirs)
        spec = dataclasses.replace(spec, inference_cfg=dataclasses.replace(
            spec.inference_cfg,
            n_refiner_iterations=args.n_refiner_iterations,
        ))
        estimator = load_named_model(
            spec, obj_ds.mesh_db, checkpoint_dirs=dirs, device=device
        )

    # group frames by scene; run matching + BA per scene
    by_scene = {}
    for idx in range(len(scene_ds)):
        obs = scene_ds[idx]
        by_scene.setdefault(obs.scene_id, []).append(obs)

    agg = dict(t_before=[], t_after=[], r_before=[], r_after=[],
               n_scenes=0, ba_losses=[])
    for sid, obs_list in sorted(by_scene.items()):
        pipe_preds = (
            _pipeline_candidates(obs_list, estimator, obj_ds.mesh_db, device)
            if estimator is not None else None
        )
        poses, view_ids, obj_ids, gt_poses = [], [], [], {}
        K_per_view, TWC_gt = [], []
        vmap = {}
        for obs in obs_list:
            v = vmap.setdefault(obs.view_id, len(vmap))
            K_per_view.append(obs.K)
            TWC_gt.append(obs.TWC)
            for j, label in enumerate(obs.obj_labels):
                oid = obj_ds.mesh_db.id_of(label)
                gt_poses[(v, oid)] = obs.TWO[j]
            if pipe_preds is not None:
                r = pipe_preds.get(obs.view_id)
                if r is None:
                    continue
                for o in range(len(r["obj_ids"])):
                    poses.append(np.asarray(r["poses"][o]))
                    view_ids.append(v)
                    obj_ids.append(int(r["obj_ids"][o]))
            else:
                for j, label in enumerate(obs.obj_labels):
                    noise = np.eye(4)
                    noise[:3, :3] = ScipyRot.from_rotvec(rng.normal(
                        0, np.deg2rad(args.candidate_noise_deg), 3
                    )).as_matrix()
                    noise[:3, 3] = rng.normal(0, args.candidate_noise_t, 3)
                    poses.append(obs.TWO[j] @ noise)
                    view_ids.append(v)
                    obj_ids.append(obj_ds.mesh_db.id_of(label))
        if not poses:
            continue
        cands = MultiviewCandidates(
            poses=np.asarray(poses, np.float32),
            view_ids=np.asarray(view_ids),
            obj_ids=np.asarray(obj_ids),
            scores=np.ones(len(poses), np.float32),
        )
        predictor = MultiviewScenePredictor(
            bm, score_th=0.0, n_ransac_iter=30, dist_threshold=0.02,
            n_min_inliers=2, ba_solver=args.ba_solver, device=device,
        )
        state = predictor.predict_scene_state(
            cands, np.stack(K_per_view),
            known_TWC=np.stack(TWC_gt) if args.known_cameras else None,
        )
        if state is None:
            logger.info(f"scene {sid}: no reconstruction")
            continue
        agg["n_scenes"] += 1
        agg["ba_losses"].append(float(state.ba_loss))
        for v, pred in state.predictions_per_view().items():
            for o in range(len(pred["obj_ids"])):
                gt = gt_poses.get((v, int(pred["obj_ids"][o])))
                if gt is None:
                    continue
                T = pred["TCO"][o]
                agg["t_after"].append(np.linalg.norm(T[:3, 3] - gt[:3, 3]))
                agg["r_after"].append(_rot_err(T, gt))
        for i in range(len(cands)):
            gt = gt_poses.get(
                (int(cands.view_ids[i]), int(cands.obj_ids[i]))
            )
            if gt is None:
                continue
            T = cands.poses[i]
            agg["t_before"].append(np.linalg.norm(T[:3, 3] - gt[:3, 3]))
            agg["r_before"].append(_rot_err(T, gt))

    if agg["n_scenes"] == 0:
        logger.info("no scene reconstructed")
        return 1
    summary = {
        "n_scenes": agg["n_scenes"],
        "candidates": "pipeline" if estimator is not None else "gt+noise",
        "ba_loss_mean": float(np.mean(agg["ba_losses"])),
        "mean_trans_err_candidates": float(np.mean(agg["t_before"])),
        "mean_trans_err_fused": float(np.mean(agg["t_after"])),
        "median_rot_err_deg_candidates": float(
            np.degrees(np.median(agg["r_before"]))
        ),
        "median_rot_err_deg_fused": float(
            np.degrees(np.median(agg["r_after"]))
        ),
        "median_trans_err_candidates": float(np.median(agg["t_before"])),
        "median_trans_err_fused": float(np.median(agg["t_after"])),
    }
    logger.info(json.dumps(summary, indent=1))
    args.out_dir.mkdir(parents=True, exist_ok=True)
    (args.out_dir / "multiview_summary.json").write_text(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
