"""Record a synthetic multi-object dataset in BOP layout on the card.

PyTorch port of `happypose_tpu/scripts/record_synthetic_dataset.py`
(parity targets: the reference's pybullet `BopRecordingScene`,
cosypose/recording/bop_recording_scene.py:26-271, and its BlenderProc PBR
pipeline, megapose/scripts/generate_shapenet_pbr.py).
`datasets/scene_synth.py` samples resting or free poses, spherical cameras,
lights, materials and backgrounds; `datasets/scene_record.py` renders,
shadows, shades, composites and annotates a batch of scenes in two launches
of the rasterizer kernel. Frames are written in BOP layout
(`<out-dir>/000000/...`), so every reader of the port takes them; `--wds`
also writes tar shards (`<out-dir>/wds/`), `--write-models` the models
(`<out-dir>/models/`). Runs on `--device` (default `cuda`).

Usage:
  python -m happypose_tpu_torch.scripts.record_synthetic_dataset \
      --out-dir /tmp/synth --n-frames 2048 --write-models [--wds]
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np

from happypose_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def builtin_mesh_db(name: str, seed: int = 0):
    """A built-in object set under BOP labels: "debug" (a UV sphere and a
    box, plain colours), "textured" (the synthetic training set of
    `training/synth_data.py`: a procedurally textured UV sphere and a
    position-coloured box) or "r03" (a randomly textured UV sphere, a
    position-coloured box and cylinder)."""
    from happypose_tpu_torch.meshes.database import MeshDataBase
    from happypose_tpu_torch.meshes.io import (
        make_box_mesh, make_cylinder_mesh, make_procedural_texture, make_random_texture,
        make_uv_sphere, position_colored,
    )

    if name == "debug":
        return MeshDataBase(meshes={
            # dense enough that baked vertex colours keep texture detail
            "obj_000001": make_uv_sphere(0.04, 24, 32, with_uv=True),
            "obj_000002": make_box_mesh((0.035, 0.025, 0.045)),
        })
    if name == "textured":
        sphere = make_uv_sphere(0.04, 16, 24, with_uv=True)
        sphere.texture = make_procedural_texture(256, seed=1)
        return MeshDataBase(meshes={
            "obj_000001": sphere,
            "obj_000002": position_colored(make_box_mesh((0.035, 0.025, 0.045))),
        })
    if name == "r03":
        rs = np.random.RandomState(seed + 101)
        sphere = make_uv_sphere(0.04, 24, 32, with_uv=True)
        sphere.texture = make_random_texture(rs, 128)
        return MeshDataBase(meshes={
            "obj_000001": sphere,
            "obj_000002": position_colored(make_box_mesh((0.035, 0.025, 0.045))),
            "obj_000003": position_colored(make_cylinder_mesh(0.022, 0.07)),
        })
    raise ValueError(f"unknown built-in set {name!r}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--models-dir", type=Path, default=None,
                   help="BOP models dir; defaults to a built-in set")
    p.add_argument("--builtin-set", choices=("debug", "textured", "r03"), default="debug",
                   help="built-in object set when --models-dir is absent")
    p.add_argument("--out-dir", type=Path, required=True)
    p.add_argument("--n-frames", type=int, default=20)
    p.add_argument("--n-objects-interval", type=int, nargs=2, default=(2, 4))
    p.add_argument("--proba-falling", type=float, default=0.5)
    p.add_argument("--resolution", type=int, nargs=2, default=(240, 320))
    p.add_argument("--batch-scenes", type=int, default=16, help="scenes rendered a batch")
    p.add_argument("--no-domain-rand", action="store_true")
    p.add_argument("--no-border-check", action="store_true")
    p.add_argument("--no-floor", action="store_true", help="drop the shadow-receiving ground plane")
    p.add_argument("--no-shadows", action="store_true")
    p.add_argument("--max-faces", type=int, default=0,
                   help="decimate meshes above this face count (0 = keep)")
    p.add_argument("--textures-on-objects", action="store_true",
                   help="give every object with uv a procedural texture")
    p.add_argument("--randomize-object-textures", action="store_true",
                   help="re-draw object textures every batch")
    p.add_argument("--blur-sigma-max", type=float, default=None,
                   help="cap the per-scene depth-of-field blur sigma (0 disables)")
    p.add_argument("--noise-std-max", type=float, default=None,
                   help="cap the per-scene sensor-noise std (0 disables)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--write-models", action="store_true",
                   help="also write <out-dir>/models in BOP layout")
    p.add_argument("--wds", action="store_true", help="also write <out-dir>/wds tar shards")
    p.add_argument("--wds-only", action="store_true",
                   help="write only the tar shards, no BOP png tree")
    p.add_argument("--shard-size", type=int, default=64)
    p.add_argument("--device", default="cuda", help="torch device of the renders")
    args = p.parse_args(argv)

    from happypose_tpu_torch.datasets.bop import (
        BOPObjectDataset, SceneObservation, write_bop_models, write_bop_scene,
    )
    from happypose_tpu_torch.datasets.scene_record import BatchedSceneRecorder
    from happypose_tpu_torch.datasets.scene_synth import SceneSynthConfig
    from happypose_tpu_torch.meshes.io import decimate_mesh, make_random_texture

    if args.models_dir:
        mesh_db = BOPObjectDataset(args.models_dir).mesh_db
    else:
        mesh_db = builtin_mesh_db(args.builtin_set, args.seed)
    if args.max_faces:
        for label, m in mesh_db.meshes.items():
            if len(m.faces) > args.max_faces:
                mesh_db.meshes[label] = decimate_mesh(m, args.max_faces)
    if args.textures_on_objects:
        rs = np.random.RandomState(args.seed)
        for label in mesh_db.labels:
            m = mesh_db.meshes[label]
            if m.vertex_uv is not None:
                m.texture = make_random_texture(rs, 128)
    if args.write_models:
        write_bop_models(args.out_dir / "models", mesh_db)
        logger.info(f"wrote models to {args.out_dir}/models")
    if args.n_frames <= 0:
        return 0

    cfg = SceneSynthConfig(
        n_objects_interval=tuple(args.n_objects_interval),
        proba_falling=args.proba_falling,
        resolution=tuple(args.resolution),
        border_check=not args.no_border_check,
        domain_randomization=not args.no_domain_rand,
    )
    if args.blur_sigma_max is not None:
        cfg.blur_sigma_interval = (0.0, args.blur_sigma_max)
    if args.noise_std_max is not None:
        cfg.noise_std_interval = (0.0, args.noise_std_max)
    rec = BatchedSceneRecorder(
        mesh_db, cfg, seed=args.seed, batch_scenes=args.batch_scenes,
        floor=not args.no_floor, shadows=not args.no_shadows,
        randomize_object_textures=args.randomize_object_textures, device=args.device,
    )
    t0 = time.time()
    recorded = rec.record(args.n_frames, progress_every=16)
    dt = time.time() - t0
    # BOP's scene_gt is camera-frame (cam_R_m2c); the world goes to
    # scene_camera through TWC (cam_R_w2c)
    frames = [
        SceneObservation(rgb=f.rgb, K=f.K, depth=f.depth, obj_labels=f.labels, TWO=f.TCO,
                         bboxes=f.bboxes, visib_fract=f.visib_fract, scene_id=0, view_id=i,
                         TWC=f.TWC)
        for i, f in enumerate(recorded)
    ]
    if not args.wds_only:
        write_bop_scene(args.out_dir, 0, frames)
    if args.wds or args.wds_only:
        from happypose_tpu_torch.datasets.web_scene_dataset import write_scene_ds_as_wds

        shards = write_scene_ds_as_wds(frames, args.out_dir / "wds", shard_size=args.shard_size)
        logger.info(f"wrote {len(shards)} wds shards")
    logger.info(f"wrote {len(frames)} frames to {args.out_dir} ({dt:.1f} s of recording, "
                f"{len(frames) / max(dt, 1e-9):.1f} frames/s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
