"""Train the detector on a BOP split (or a recorded synthetic one).

PyTorch port of `happypose_tpu/scripts/run_detector_training.py` (parity
target: the reference's cosypose/training/train_detector.py:119-386, Mask
R-CNN under DDP): the FCOS + mask detector (`models/detector.py`) trained
with `training/detector_loss.py` by plain Adam (no clip, no schedule),
BatchNorm in train mode (Flax's update of the running statistics), epochs
of batches drawn with `np.random.RandomState(0)` as in the JAX package, a
JSON-lines log (`log.txt`), checkpoints in the run-directory format of
`utils/checkpoint.py` (which `load_detector(run_dir, n_classes)` and
`run_eval --detections detector` read; `--resume` also continues a run of
the JAX package from its `checkpoint.msgpack`) and an optional mAP@0.5 on
a few frames. A batch is a frame cropped to the aspect of `--image-size`, its
boxes moved with the crop, and box-filling masks at a quarter of the
resolution; the colours are jittered unless `--no-augment`. The split's
uint8 frames are staged on `--device` (default `cuda`) once. On the card
the step is one CUDA graph replay (`training/trainer.py`), the batch copied
into its inputs, and the evaluation's forward another (the detector's
forward graph of `inference/detector.py`); the postprocess, its NMS on
`ops.nms`, runs after it.

Usage:
  python -m happypose_tpu_torch.scripts.run_detector_training \
      --run-dir /tmp/det --split-dir <bop>/test --models-dir <bop>/models \
      --epochs 2 --epoch-size 32 --batch-size 2
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
import weakref
from typing import Callable, NamedTuple

import numpy as np
import torch

from happypose_tpu_torch.utils.cuda_graphs import GraphCache, storage_of
from happypose_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# The evaluation's forward graphs, one cache a model (JAX's jitted
# `eval_forward`), keyed by the model's mode and its weights' storage
_eval_graphs: "weakref.WeakKeyDictionary[torch.nn.Module, GraphCache]" = \
    weakref.WeakKeyDictionary()


def eval_forward(model, x: torch.Tensor):
    """`model(x)` in eval mode through its graph of `x`'s shape."""
    graphs = _eval_graphs.setdefault(model, GraphCache("eval"))
    return graphs(("forward", model.training, storage_of(model)), model, (x,))

MAX_CACHED_FRAMES = 4400  # split size up to which frames are staged on the device


class BatchMaker:
    """Detector training batches from a scene dataset: `make(rng)` draws
    `batch_size` frames with objects from `rng` (numpy) and returns the
    images [B, 3, H, W] on `device` and their `DetectionTargets`."""

    def __init__(self, scene_ds, label_to_id, image_size, batch_size, max_gt, device):
        self.scene_ds = scene_ds
        self.label_to_id = label_to_id
        self.image_size = tuple(image_size)
        self.batch_size = batch_size
        self.max_gt = max_gt
        self.device = torch.device(device)
        self.frames = None
        n = len(scene_ds)
        if n <= MAX_CACHED_FRAMES and len({scene_ds[i].rgb.shape for i in range(min(n, 4))}) == 1:
            self.frames = torch.from_numpy(np.stack([scene_ds[i].rgb for i in range(n)])).to(
                self.device)

    def make(self, rng: np.random.RandomState):
        from happypose_tpu_torch.datasets.augmentations import crop_resize_to_aspect
        from happypose_tpu_torch.datasets.pose_dataset import to_images
        from happypose_tpu_torch.training.detector_loss import DetectionTargets

        B, G = self.batch_size, self.max_gt
        H, W = self.image_size
        imgs, Ks, boxes, lab, valid, fidx = [], [], [], [], [], []
        while len(Ks) < B:
            fi = int(rng.randint(len(self.scene_ds)))
            obs = self.scene_ds[fi]
            if not obs.obj_labels:
                continue
            if self.frames is None:
                imgs.append(obs.rgb)
            else:
                fidx.append(fi)
            Ks.append(obs.K)
            b = np.zeros((G, 4), np.float32)
            c = np.zeros((G,), np.int64)
            v = np.zeros((G,), bool)
            for j, label in enumerate(obs.obj_labels[:G]):
                b[j] = obs.bboxes[j]
                c[j] = self.label_to_id[label]
                v[j] = True
            boxes.append(b)
            lab.append(c)
            valid.append(v)
        if self.frames is None:
            frames = torch.from_numpy(np.stack(imgs)).to(self.device)
        else:
            frames = self.frames[torch.tensor(fidx, device=self.device)]
        K = torch.from_numpy(np.stack(Ks)).to(self.device)
        x, K2 = crop_resize_to_aspect(to_images(frames), K, (H, W))
        # the crop scales uniformly and shifts: boxes follow K's change
        sx = K2[:, 0, 0] / K[:, 0, 0]
        offx = (K2[:, 0, 2] - K[:, 0, 2] * sx).cpu().numpy()
        offy = (K2[:, 1, 2] - K[:, 1, 2] * sx).cpu().numpy()
        sx = sx.cpu().numpy()
        b = np.stack(boxes)
        b[:, :, 0::2] = b[:, :, 0::2] * sx[:, None, None] + offx[:, None, None]
        b[:, :, 1::2] = b[:, :, 1::2] * sx[:, None, None] + offy[:, None, None]
        # coarse box-filling masks at prototype resolution
        m = np.zeros((B, G, H // 4, W // 4), bool)
        for i in range(B):
            for j in range(G):
                if valid[i][j]:
                    x1, y1, x2, y2 = (b[i, j] / 4).astype(int)
                    m[i, j, max(y1, 0): y2, max(x1, 0): x2] = True
        targets = DetectionTargets(boxes=torch.from_numpy(b), labels=torch.from_numpy(np.stack(lab)),
                                   masks=torch.from_numpy(m), valid=torch.from_numpy(np.stack(valid)))
        return x, targets.to(self.device)


def eval_map(model, maker: BatchMaker, n_frames: int) -> float:
    """Detection mAP@0.5 on a fixed handful of batches (RandomState(12345))."""
    from happypose_tpu_torch.evaluation.detection_meters import DetectionMeter
    from happypose_tpu_torch.models.detector import detector_postprocess

    meter = DetectionMeter(iou_threshold=0.5)
    rng = np.random.RandomState(12345)
    model.eval()
    with torch.no_grad():
        for _ in range(max(1, n_frames // maker.batch_size)):
            x, targets = maker.make(rng)
            post = detector_postprocess(eval_forward(model, x), score_threshold=0.3,
                                        iou_threshold=0.5, max_detections=maker.max_gt * 2)
            post = {k: v.cpu().numpy() for k, v in post.items()}
            t = targets.to("cpu")
            for i in range(x.shape[0]):
                keep, gt_keep = post["valid"][i], t.valid[i].numpy()
                meter.add(post["boxes"][i][keep], post["labels"][i][keep], post["scores"][i][keep],
                          t.boxes[i].numpy()[gt_keep], t.labels[i].numpy()[gt_keep])
    return meter.summary()["mAP"]


class DetectorTrainer(NamedTuple):
    model: torch.nn.Module
    state: object  # training.trainer.TrainState
    loss: Callable  # (batch, draws) -> (loss, metrics)
    step: Callable  # (state, batch, draws) -> metrics


def make_detector_trainer(n_classes: int, fpn_channels: int, lr: float, device,
                          seed: int = 0) -> DetectorTrainer:
    """The model, train state and step that `main` trains: an `FCOSDetector`
    seeded with `seed` on `device`, plain Adam (optax.adam: no warmup, no
    schedule, no clip) and `detector_loss` with BatchNorm in train mode."""
    from happypose_tpu_torch.models.detector import DetectorConfig, FCOSDetector
    from happypose_tpu_torch.training.detector_loss import detector_loss
    from happypose_tpu_torch.training.forward_loss import LossFn
    from happypose_tpu_torch.training.trainer import TrainState, make_optimizer, make_train_step

    model = FCOSDetector(DetectorConfig(n_classes=n_classes, fpn_channels=fpn_channels))
    model.init_weights(torch.Generator().manual_seed(seed)).to(device)
    state = TrainState(model, make_optimizer(model.parameters(), lr=lr, n_warmup_steps=0,
                                             clip_grad_norm=None))

    def loss(batch, draws):
        x, targets = batch
        return detector_loss(model.train()(x), targets, n_classes)

    return DetectorTrainer(model, state, loss,
                           make_train_step(LossFn(sample=lambda g, b: {}, loss=loss)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--run-dir", type=Path, required=True)
    p.add_argument("--split-dir", type=Path, required=True)
    p.add_argument("--models-dir", type=Path, default=None,
                   help="BOP models dir: the class of a label is its object id there "
                        "(default: the split's labels, sorted)")
    p.add_argument("--image-size", type=int, nargs=2, default=(240, 320))
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--epoch-size", type=int, default=32)
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--max-gt", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--fpn-channels", type=int, default=64)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--save-every", type=int, default=5,
                   help="epochs between checkpoint writes; the final epoch always saves")
    p.add_argument("--eval-interval", type=int, default=0,
                   help="every N epochs, log mAP@0.5 on a few training frames (0 = off)")
    p.add_argument("--eval-frames", type=int, default=8)
    p.add_argument("--no-augment", action="store_true",
                   help="no colour jitter (brightness, contrast, saturation, sharpness)")
    p.add_argument("--device", default="cuda", help="torch device of the model and the data")
    args = p.parse_args(argv)

    from happypose_tpu_torch.datasets.augmentations import rgb_jitter, sample_rgb_jitter
    from happypose_tpu_torch.datasets.bop import BOPObjectDataset, BOPSceneDataset
    from happypose_tpu_torch.utils.checkpoint import (
        has_checkpoint, load_checkpoint, save_checkpoint,
    )

    dev = torch.device(args.device)
    scene_ds = BOPSceneDataset(args.split_dir, cache_frames=True)
    if args.models_dir:
        label_to_id = BOPObjectDataset(args.models_dir).mesh_db.label_to_id
    else:
        labels = sorted({l for i in range(len(scene_ds)) for l in (scene_ds[i].obj_labels or [])})
        label_to_id = {l: i for i, l in enumerate(labels)}
    n_classes = len(label_to_id)
    maker = BatchMaker(scene_ds, label_to_id, args.image_size, args.batch_size, args.max_gt, dev)

    trainer = make_detector_trainer(n_classes, args.fpn_channels, args.lr, dev)
    state, step = trainer.state, trainer.step
    start_epoch = 0
    if args.resume and has_checkpoint(args.run_dir):
        state, start_epoch = load_checkpoint(args.run_dir, state)
    rng = np.random.RandomState(0)
    maker.make(rng)  # the JAX package initializes its model on this batch: the same picks follow
    aug = torch.Generator(device=dev).manual_seed(7)
    args.run_dir.mkdir(parents=True, exist_ok=True)
    for epoch in range(start_epoch, args.epochs):
        t0 = time.time()
        losses = []
        for _ in range(args.epoch_size // args.batch_size):
            x, targets = maker.make(rng)
            if not args.no_augment:
                x = rgb_jitter(x, sample_rgb_jitter(aug, x.shape[0]))
            losses.append(step(state, (x, targets), {})["loss"])
        rec = {"epoch": epoch, "loss": float(np.mean(losses)), "time": time.time() - t0}
        if args.eval_interval and (epoch + 1) % args.eval_interval == 0:
            rec["mAP@0.5"] = eval_map(trainer.model, maker, args.eval_frames)
        with open(args.run_dir / "log.txt", "a") as f:
            f.write(json.dumps(rec) + "\n")
        logger.info(f"epoch {epoch}: loss={rec['loss']:.4f}"
                    + (f" mAP@0.5={rec['mAP@0.5']:.3f}" if "mAP@0.5" in rec else ""))
        if (args.save_every and (epoch + 1) % args.save_every == 0) or epoch + 1 == args.epochs:
            save_checkpoint(args.run_dir, state, epoch + 1, config=vars(args))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
