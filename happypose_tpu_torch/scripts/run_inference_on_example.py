"""Run the pose pipeline on one example; write poses, an overlay and a 3D
scene (PyTorch port of `happypose_tpu/scripts/run_inference_on_example.py`).

Parity target: happypose/pose_estimators/megapose/scripts/
run_inference_on_example.py (load example -> detections -> pose estimates ->
json + overlay visualization).

Example dir layout (a tiny BOP-like directory):
  <example>/models/obj_*.ply + models_info.json
  <example>/scene/000000/{rgb/000000.png, scene_camera.json,
                           scene_gt.json, scene_gt_info.json}

Usage:
  python -m happypose_tpu_torch.scripts.run_inference_on_example \
      --example-dir <example> --make-example [--device cuda]

Everything runs on `--device` (default `cuda`); on a machine without a card
the script fails with PyTorch's own error unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import numpy as np

from happypose_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def make_example(example_dir: Path, device="cuda") -> None:
    """Synthesize an example: a mesh dir + one rendered observation."""
    import torch

    from happypose_tpu_torch.datasets.bop import SceneObservation, write_bop_scene
    from happypose_tpu_torch.meshes.database import MeshDataBase
    from happypose_tpu_torch.meshes.io import make_box_mesh, make_uv_sphere, save_ply
    from happypose_tpu_torch.ops.rasterizer_fused import render_batch_fused

    models = example_dir / "models"
    models.mkdir(parents=True, exist_ok=True)
    save_ply(models / "obj_000001.ply",
             make_uv_sphere(radius=40.0, n_lat=16, n_lon=24))
    save_ply(models / "obj_000002.ply", make_box_mesh((35.0, 25.0, 45.0)))
    (models / "models_info.json").write_text(json.dumps({
        "1": {"diameter": 80.0,
              "symmetries_continuous": [{"axis": [0, 0, 1],
                                         "offset": [0, 0, 0]}]},
        "2": {"diameter": 123.7},
    }))

    db = MeshDataBase(meshes={
        "obj_000001": make_uv_sphere(radius=0.04, n_lat=16, n_lon=24),
        "obj_000002": make_box_mesh((0.035, 0.025, 0.045)),
    })
    assets = db.render_assets(device=device)
    H, W = 240, 320
    K = np.eye(3, dtype=np.float32)
    K[0, 0] = K[1, 1] = 400.0
    K[0, 2], K[1, 2] = W / 2, H / 2
    TCO = np.eye(4, dtype=np.float32)
    TCO[:3, 3] = [0.01, -0.02, 0.5]
    out = render_batch_fused(
        assets, torch.tensor([1], device=device),
        torch.from_numpy(TCO)[None].to(device),
        torch.from_numpy(K)[None].to(device), resolution=(H, W),
    )
    mask = out.mask[0].cpu().numpy()
    ys, xs = np.where(mask)
    obs = SceneObservation(
        rgb=(out.rgb[0].cpu().numpy() * 255).astype(np.uint8),
        K=K, depth=out.depth[0].cpu().numpy(),
        obj_labels=["obj_000002"], TWO=TCO[None],
        bboxes=np.asarray([[xs.min(), ys.min(), xs.max(), ys.max()]],
                          np.float32),
        visib_fract=np.asarray([1.0]), scene_id=0, view_id=0,
    )
    write_bop_scene(example_dir / "scene", 0, [obs])
    logger.info(f"example written to {example_dir}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--example-dir", type=Path, required=True)
    parser.add_argument("--make-example", action="store_true")
    parser.add_argument("--model", default="megapose-RGB")
    parser.add_argument("--so3-grid", type=int, default=72)
    parser.add_argument("--checkpoints", type=Path, default=None,
                        help="dir containing refiner/ and coarse/ run dirs; "
                             "with --model from-checkpoints their configs "
                             "make the spec")
    parser.add_argument("--out-dir", type=Path, default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = args.device

    if args.make_example:
        make_example(args.example_dir, device=device)

    import torch

    from happypose_tpu_torch.datasets.bop import BOPObjectDataset, BOPSceneDataset
    from happypose_tpu_torch.inference.types import DetectionBatch, ObservationBatch
    from happypose_tpu_torch.ops.rasterizer_fused import render_batch_fused
    from happypose_tpu_torch.utils.load_model import (
        NAMED_MODELS, load_named_model, spec_from_checkpoints,
    )
    from happypose_tpu_torch.utils.png import write_png
    from happypose_tpu_torch.visualization import (
        make_contour_overlay, make_pose_overlay,
    )
    from happypose_tpu_torch.visualization.gltf_export import export_scene_glb

    obj_ds = BOPObjectDataset(args.example_dir / "models")
    scene_ds = BOPSceneDataset(args.example_dir / "scene")
    obs = scene_ds[0]

    ckpt_dirs = None
    if args.checkpoints:
        ckpt_dirs = {
            kind: args.checkpoints / kind
            for kind in ("refiner", "coarse")
            if (args.checkpoints / kind).exists()
        }
    if args.model == "from-checkpoints":
        if not ckpt_dirs:
            parser.error("--model from-checkpoints requires --checkpoints")
        spec = spec_from_checkpoints(ckpt_dirs)
    else:
        spec = NAMED_MODELS[args.model]
    # small SO(3) grid for quick runs; the changed spec is handed on, the
    # registry stays as it is
    spec = dataclasses.replace(
        spec,
        inference_cfg=dataclasses.replace(
            spec.inference_cfg, SO3_grid_size=args.so3_grid,
            bsz_images=min(spec.inference_cfg.bsz_images, args.so3_grid),
        ),
    )
    estimator = load_named_model(
        spec, obj_ds.mesh_db, checkpoint_dirs=ckpt_dirs, device=device
    )

    ob = ObservationBatch.from_numpy(obs.rgb, obs.K, device=device)
    det = DetectionBatch.from_numpy(
        obs.bboxes, obj_ds.mesh_db.ids_of(obs.obj_labels), device=device
    )
    logger.info("running inference pipeline ...")
    results = estimator.run_inference_pipeline(ob, det)
    final = results["final"]
    valid = final.valid.cpu().numpy()
    poses = final.poses.cpu().numpy()[valid]
    obj_ids = final.obj_ids.cpu().numpy()[valid]

    out_dir = args.out_dir or (args.example_dir / "outputs")
    out_dir.mkdir(parents=True, exist_ok=True)
    records = [
        {"label": obj_ds.mesh_db.labels[int(o)], "TWO": p.tolist()}
        for o, p in zip(obj_ids, poses)
    ]
    (out_dir / "object_data.json").write_text(json.dumps(records, indent=1))

    # overlay visualization with the port's renderer
    render = render_batch_fused(
        estimator.assets, torch.from_numpy(obj_ids).to(device),
        torch.from_numpy(poses).to(device),
        torch.from_numpy(np.tile(obs.K[None], (len(poses), 1, 1))).to(device),
        resolution=obs.rgb.shape[:2],
    )
    render_rgb = render.rgb.cpu().numpy()
    render_mask = render.mask.cpu().numpy()
    overlay = obs.rgb
    for i in range(len(poses)):
        overlay = make_pose_overlay(overlay, render_rgb[i], render_mask[i])
        overlay = make_contour_overlay(overlay, render_mask[i])
    write_png(out_dir / "all_results.png", overlay)

    # 3D scene export (meshcat-viewer equivalent): predicted objects in the
    # camera frame + the camera at the origin, as a standalone .glb
    export_scene_glb(
        out_dir / "scene.glb", obj_ds.mesh_db,
        [obj_ds.mesh_db.labels[int(o)] for o in obj_ids], poses,
        camera_poses=np.eye(4)[None],
    )
    logger.info(
        f"wrote {out_dir}/object_data.json, all_results.png, scene.glb"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
