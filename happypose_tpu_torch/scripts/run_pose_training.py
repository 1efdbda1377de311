"""Train a pose model (refiner or coarse classifier) on one device, or
data-parallel with `--dp`.

PyTorch port of `happypose_tpu/scripts/run_pose_training.py` (parity
targets: the reference's train_megapose.py:96-459 and
cosypose/training/train_pose.py:252-520): epochs of steps, a JSON-lines log
(`log.txt`, one line an epoch with the JAX package's keys), checkpoints
that are run directories of the port (`utils/checkpoint.py`), resume
and warm start (`--resume`, `--init-from`: from the port's run directories
or the JAX package's `checkpoint.msgpack`, its Adam state included), the refiner's iteration curriculum and in-training evaluation.

On the card the step is one CUDA graph replay (`training/trainer.py`;
each curriculum change builds a step, and so a key, of its own), the
synthetic batch another (`training/synth_data.py`), and the in-training
evaluation a third; the loop reads the step's metrics once a step.

Data: `--data synth` renders random scenes through the rasterizer on
`--device` (default `cuda`; the hand-written kernel there, its plain
version on the CPU). `--data <dir>` trains on a BOP split with the models
of `--models-dir` (`datasets/pose_dataset.py`, its frames staged on the
device when the split has at most 4400), and with `--stream` on the WDS
shards under `<dir>` or `<dir>/wds` (`datasets/streaming_pose_dataset.py`);
its batches are drawn in the JAX package's order (one for the model's
initialization, then the eval batch, then training).

`--dp` trains data-parallel over the ranks of the process group, one
process a device (`torchrun --nproc-per-node N`; without a launcher a group
of one rank): `--batch-size` is the global batch, as in JAX; every rank
draws the same global batch and step draws from the shared seeds and
makes only its contiguous block; BatchNorm statistics, gradients, loss and
metrics are averaged over the ranks (`training/trainer.py`); epoch metrics
go through `reduce_dict`; only rank 0 writes the log and checkpoints.

Usage:
  python -m happypose_tpu_torch.scripts.run_pose_training \
      --run-dir /tmp/run --model-type refiner --data synth \
      --epochs 2 --epoch-size 64 --batch-size 8
  torchrun --standalone --nproc-per-node 2 -m happypose_tpu_torch.scripts.run_pose_training \
      --run-dir /tmp/run --dp ...
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from happypose_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def make_pose_dataset(args, mesh_db, dev, rank_block=(0, 1)):
    """The training batches of `--data <dir>`: the WDS shards under it with
    `--stream`, else its BOP frames through `PoseDataset`; this rank's
    block of each batch (`rank_block` = (rank, world))."""
    from happypose_tpu_torch.datasets.bop import BOPSceneDataset
    from happypose_tpu_torch.datasets.pose_dataset import PoseDataset
    from happypose_tpu_torch.datasets.streaming_pose_dataset import StreamingPoseDataset

    data_dir = Path(args.data)
    common = dict(batch_size=args.batch_size, resolution=tuple(args.image_size),
                  apply_rgb_augmentation=not args.no_augment, device=str(dev),
                  rank_block=rank_block)
    if args.stream:
        wds_dir = next((d for d in (data_dir, data_dir / "wds") if list(d.glob("*.tar"))), None)
        if wds_dir is None:
            raise SystemExit(f"--stream: no WDS *.tar shards under {data_dir} "
                             f"(or {data_dir / 'wds'})")
        logger.info(f"streaming WDS input from {wds_dir}")
        return StreamingPoseDataset(str(wds_dir), mesh_db, chunk_frames=args.stream_chunk,
                                    **common)
    scene_ds = BOPSceneDataset(data_dir, cache_frames=True)
    # a uint8 frame of 480x640 is 0.9 MB: 4400 frames take about 4 GB on the device
    return PoseDataset(scene_ds, mesh_db, device_cache=len(scene_ds) <= 4400, **common)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--run-dir", type=Path, required=True)
    p.add_argument("--model-type", choices=["refiner", "coarse"], default="refiner")
    p.add_argument("--backbone", default="wide_resnet18")
    p.add_argument("--data", default="synth",
                   help="'synth', or a BOP split directory (with --models-dir)")
    p.add_argument("--models-dir", type=Path, default=None,
                   help="BOP models dir (required for --data <dir>)")
    p.add_argument("--synth-set", default="debug", choices=["debug", "textured", "mesh_only"],
                   help="synthetic mesh registry (textured = procedural textures)")
    p.add_argument("--mesh-files", type=Path, nargs="*", default=None,
                   help="extra mesh files added to the synth registry (mm -> m, "
                        "procedural texture when UVs exist)")
    p.add_argument("--max-faces", type=int, default=0,
                   help="decimate synth meshes above this face count (0 = keep)")
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--epoch-size", type=int, default=64)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--n-warmup-steps", type=int, default=50)
    p.add_argument("--n-iterations", type=int, default=1)
    p.add_argument("--coarse-negatives", choices=["grid", "multiview"], default="grid",
                   help="coarse negatives: random SO(3)-grid rotations sharing the "
                        "positive's translation, or the reference's sphere-26 multiview")
    p.add_argument("--coarse-hypotheses", type=int, default=8,
                   help="hypotheses per sample for --coarse-negatives grid")
    p.add_argument("--add-iteration-epoch-interval", type=int, default=0,
                   help="add one refiner iteration every K epochs (up to "
                        "--n-iterations-max; the reference's curriculum)")
    p.add_argument("--n-iterations-max", type=int, default=3)
    p.add_argument("--render-size", type=int, nargs=2, default=(120, 160))
    p.add_argument("--image-size", type=int, nargs=2, default=(120, 160))
    p.add_argument("--eval-every", type=int, default=0,
                   help="epochs between in-training refiner evals (0 = off)")
    p.add_argument("--save-every", type=int, default=10,
                   help="epochs between checkpoint writes (the final epoch always "
                        "saves; 0 = final epoch only)")
    p.add_argument("--no-augment", action="store_true",
                   help="no colour jitter of the observed images in split training")
    p.add_argument("--stream", action="store_true",
                   help="stream training frames from the WDS tar shards under --data "
                        "(<data>/*.tar or <data>/wds/*.tar) through chunks staged on the device")
    p.add_argument("--stream-chunk", type=int, default=512,
                   help="frames a streamed chunk")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--init-from", type=Path, default=None,
                   help="warm-start weights from another run dir; optimizer state and "
                        "epoch counter start fresh")
    p.add_argument("--dp", action="store_true",
                   help="data-parallel over the ranks of the process group (torchrun)")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--profile", action="store_true",
                   help="capture a torch.profiler trace of the first epoch to "
                        "<run-dir>/trace/trace.json")
    p.add_argument("--device", default="cuda",
                   help="torch device of the model, the renders and the data")
    args = p.parse_args(argv)

    if args.data != "synth" and args.models_dir is None:
        p.error("--data <dir> needs --models-dir")
    if args.stream and args.data == "synth":
        p.error("--stream reads the WDS shards of a recorded split: give --data <dir>")

    dev = torch.device(args.device)
    mesh = None
    own_group = args.dp and not torch.distributed.is_initialized()
    if args.dp:
        from happypose_tpu_torch.parallel import make_mesh

        mesh = make_mesh(device_type=dev.type)
    rank_block = (mesh.get_local_rank("dp"), mesh.size()) if mesh is not None else (0, 1)
    db = pose_ds = None
    if args.data != "synth":
        from happypose_tpu_torch.datasets.bop import BOPObjectDataset

        db = BOPObjectDataset(args.models_dir).mesh_db
        pose_ds = make_pose_dataset(args, db, dev, rank_block)
    try:
        return train(args, dev, db, pose_ds, mesh)
    finally:
        if hasattr(pose_ds, "stop"):  # the stream's decode thread
            pose_ds.stop()
        if own_group:  # a group the caller made stays the caller's
            torch.distributed.destroy_process_group()


def train(args, dev, db, pose_ds, mesh=None) -> int:
    """The training loop of `main`: synthetic batches when `pose_ds` is
    None, else `pose_ds`'s over the mesh database `db`; data-parallel over
    `mesh`'s "dp" axis when one is given (each rank's block of the global
    batch and of its draws)."""
    from happypose_tpu_torch.parallel import reduce_dict
    from happypose_tpu_torch.parallel.distributed import is_main_process
    from happypose_tpu_torch.lib3d.rotations import geodesic_distance
    from happypose_tpu_torch.lib3d.transforms import apply_pose_noise, sample_pose_noise
    from happypose_tpu_torch.models.pose_predictor import PosePredictor, PosePredictorConfig
    from happypose_tpu_torch.training import TrainState, make_optimizer, make_train_step
    from happypose_tpu_torch.training.trainer import split_batch_for_mesh
    from happypose_tpu_torch.training.forward_loss import (
        make_coarse_grid_loss_fn, make_coarse_loss_fn, make_refiner_loss_fn,
    )
    from happypose_tpu_torch.training.synth_data import (
        make_synth_batch, make_synth_mesh_db, sample_synth_scenes,
    )
    from happypose_tpu_torch.utils.checkpoint import (
        has_checkpoint, load_checkpoint, save_checkpoint,
    )
    from happypose_tpu_torch.utils.cuda_graphs import GraphCache, storage_of
    from happypose_tpu_torch.utils.load_model import read_state_dict
    from happypose_tpu_torch.utils.profiling import device_trace
    from happypose_tpu_torch.utils.random import generator_for

    world = 1 if mesh is None else mesh.size()
    if args.batch_size % world:
        raise SystemExit(f"--dp: --batch-size {args.batch_size} does not divide by {world} ranks")

    def shard(tree):  # this rank's block of a global batch's tensors
        return tree if mesh is None else split_batch_for_mesh(tree, mesh)

    # ---- data ----
    if args.data == "synth":
        db = make_synth_mesh_db(args.synth_set, args.mesh_files, max_faces=args.max_faces)
        H, W = args.image_size
        K1 = torch.tensor([[300.0, 0, W / 2], [0, 300.0, H / 2], [0, 0, 1.0]], device=dev)

        def synth_batch(epoch, i):
            scenes = sample_synth_scenes(
                generator_for("synth", epoch, i, device=dev), n_objects=len(db.labels),
                batch_size=args.batch_size, resolution=(H, W))
            return make_synth_batch(assets, K1, shard(scenes))

        def batches(epoch):
            for i in range(args.epoch_size // args.batch_size):
                yield synth_batch(epoch, i)
    else:
        data_it = iter(pose_ds)
        next(data_it)  # the JAX package initializes its model on this batch: the same picks follow

        def batches(epoch):
            for _ in range(args.epoch_size // args.batch_size):
                yield next(data_it)

        def synth_batch(epoch, i):  # the in-training eval's held-out batch
            return next(data_it)

    assets = db.render_assets(device=dev)
    bm = db.batched(n_points=256, device=dev)

    # ---- model ----
    cfg = PosePredictorConfig(
        backbone=args.backbone,
        render_size=tuple(args.render_size),
        compute_dtype="bfloat16" if args.bf16 else "float32",
        predict_pose_update=args.model_type == "refiner",
        predict_rendered_views_logits=args.model_type == "coarse",
        bn_axis_name="dp" if mesh is not None else None,
    )
    model = PosePredictor(cfg).init_weights(torch.Generator().manual_seed(0))
    if args.init_from is not None:
        model.load_state_dict(read_state_dict(args.init_from))
        logger.info(f"warm-started weights from {args.init_from}")
    model.to(dev)

    def build_loss(n_iterations):
        if args.model_type == "refiner":
            return make_refiner_loss_fn(model, assets, bm, n_iterations=n_iterations)
        if args.coarse_negatives == "grid":
            return make_coarse_grid_loss_fn(model, assets, bm, n_hypotheses=args.coarse_hypotheses)
        return make_coarse_loss_fn(model, assets, bm)

    total_steps = args.epochs * (args.epoch_size // args.batch_size)
    state = TrainState(model, make_optimizer(
        model.parameters(), lr=args.lr, n_warmup_steps=args.n_warmup_steps,
        total_steps=total_steps))
    start_epoch = 0
    if args.resume and has_checkpoint(args.run_dir):
        state, start_epoch = load_checkpoint(args.run_dir, state)
        logger.info(f"resumed from epoch {start_epoch}")

    cur_iters = args.n_iterations
    loss_fn = build_loss(cur_iters)
    step_fn = make_train_step(loss_fn, mesh=mesh)

    # in-training eval: refine noised ground truth on a fixed held-out batch,
    # through its graph (JAX's jitted `eval_fn`); the noise is drawn once
    eval_fn = None
    if args.eval_every and args.model_type == "refiner":
        eval_batch = synth_batch(999983, 0)
        eval_noise = shard(sample_pose_noise(
            generator_for("eval", 424242, device=dev), args.batch_size))
        eval_graphs = GraphCache("eval")

        def eval_errors(batch, noise):
            TCO_init = apply_pose_noise(batch.TCO_gt, *noise)
            out = model.eval()(batch.images, batch.K, batch.obj_ids, TCO_init, assets,
                               bm.select(batch.obj_ids), n_iterations=2)
            T, gt = out.TCO_output[-1], batch.TCO_gt
            return torch.stack([
                torch.linalg.vector_norm(T[:, :3, 3] - gt[:, :3, 3], dim=-1).mean(),
                geodesic_distance(T[:, :3, :3], gt[:, :3, :3]).mean() * (180.0 / np.pi)])

        def eval_fn():
            trans, rot = eval_graphs(("eval", storage_of(model)), eval_errors,
                                     (eval_batch, eval_noise), captured=(model, assets, bm)).tolist()
            return {"eval_trans_err": trans, "eval_rot_err_deg": rot}

    main_process = is_main_process()
    if main_process:
        args.run_dir.mkdir(parents=True, exist_ok=True)
    log_path = args.run_dir / "log.txt"
    for epoch in range(start_epoch, args.epochs):
        if args.add_iteration_epoch_interval and args.model_type == "refiner":
            want = min(args.n_iterations + epoch // args.add_iteration_epoch_interval,
                       args.n_iterations_max)
            if want != cur_iters:
                cur_iters = want
                logger.info(f"curriculum: n_iterations -> {cur_iters}")
                loss_fn = build_loss(cur_iters)
                step_fn = make_train_step(loss_fn, mesh=mesh)
        t0 = time.time()
        epoch_metrics = []
        trace_dir = (args.run_dir / "trace"
                     if args.profile and epoch == start_epoch and main_process else None)
        with device_trace(trace_dir):
            for i, batch in enumerate(batches(epoch)):
                # the draws of the global batch (a sampler reads only the leading
                # size and the device of `TCO_gt`), this rank's rows of them
                global_like = batch._replace(TCO_gt=batch.TCO_gt.repeat(world, 1, 1))
                draws = shard(loss_fn.sample(generator_for("step", epoch, i, device=dev),
                                             global_like))
                epoch_metrics.append(step_fn(state, batch, draws))
        avg = {k: float(np.mean([m[k] for m in epoch_metrics])) for k in epoch_metrics[0]}
        avg.update(time=time.time() - t0)
        if eval_fn is not None and (epoch + 1) % args.eval_every == 0:
            avg.update(eval_fn())
        if mesh is not None:
            avg = {k: float(v) for k, v in reduce_dict(avg, mesh, "dp").items()}
        avg["epoch"] = epoch
        if main_process:
            with open(log_path, "a") as f:
                f.write(json.dumps(avg) + "\n")
        logger.info(f"epoch {epoch}: loss={avg['loss']:.4f} ({avg['time']:.1f}s)")
        if (args.save_every and (epoch + 1) % args.save_every == 0) or epoch + 1 == args.epochs:
            save_checkpoint(args.run_dir, state, epoch + 1,
                            config=vars(args) | {"cfg": str(cfg)})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
