"""Per-frame prediction loop + evaluation orchestration (PyTorch port of
`happypose_tpu/evaluation/prediction_runner.py`).

Parity targets:
- `PredictionRunner.get_predictions` (frame shard -> ObservationTensor ->
  gt/external detections -> run_inference_pipeline -> tagged predictions):
  happypose/pose_estimators/megapose/evaluation/prediction_runner.py:52-291
- `run_eval`: megapose/evaluation/evaluation.py:79-277.

Results gather into plain numpy dicts. Detections are cut to
`max_detections` rows a frame and never padded. Every time that is recorded
(`time` of a frame, the two totals of `run_eval`) is read after
`torch.cuda.synchronize()` when the runner's device is the card: CUDA
calls return before the work is done.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from happypose_tpu_torch.datasets.bop import BOPSceneDataset, SceneObservation
from happypose_tpu_torch.datasets.samplers import DistributedSceneSampler
from happypose_tpu_torch.inference.pose_estimator import PoseEstimator
from happypose_tpu_torch.inference.types import DetectionBatch, ObservationBatch
from happypose_tpu_torch.meshes.database import MeshDataBase
from happypose_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def boxes_to_frame(boxes: np.ndarray, K_frame: np.ndarray, K_det: np.ndarray) -> np.ndarray:
    """Boxes [N, 4] predicted in the detector's aspect crop (intrinsics
    `K_det`), mapped back to the frame (intrinsics `K_frame`)."""
    s = float(K_det[0, 0]) / float(K_frame[0, 0])
    offx = float(K_det[0, 2]) - float(K_frame[0, 2]) * s
    offy = float(K_det[1, 2]) - float(K_frame[1, 2]) * s
    boxes = np.array(boxes, copy=True)
    boxes[:, 0::2] = (boxes[:, 0::2] - offx) / s
    boxes[:, 1::2] = (boxes[:, 1::2] - offy) / s
    return boxes


@dataclass
class PredictionRunner:
    """Runs the inference pipeline over a (sharded) scene dataset on
    `device` (the estimator's and the detector's device)."""

    scene_ds: BOPSceneDataset
    estimator: Optional[PoseEstimator]  # None: only the detector path is used
    mesh_db: MeshDataBase
    detection_type: str = "gt"  # gt | detector | external
    min_visib_fract: float = 0.05
    max_detections: int = 8
    external_detections: Optional[Dict] = None  # keyed (scene_id, view_id)
    detector: Optional[object] = None  # inference.detector.Detector
    detection_th: float = 0.3
    one_instance_per_class: bool = False
    n_replicas: int = 1
    rank: int = 0
    max_frames: Optional[int] = None  # truncate the split (smoke runs)
    device: str = "cuda"

    def synchronize(self) -> None:
        """Wait for the card (nothing to wait for on the CPU)."""
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)

    def _detections_from_detector(
        self, obs: SceneObservation
    ) -> Optional[DetectionBatch]:
        """Run the trained detector on the frame at its training resolution
        and map boxes back to the original image (the reference's
        `detection_type="detector"` path, prediction_runner.py:98-105)."""
        from happypose_tpu_torch.datasets.augmentations import crop_resize_to_aspect

        H, W = getattr(self.detector, "image_size", (240, 320))
        frame = ObservationBatch.from_numpy(obs.rgb, obs.K, device=self.device)
        x_r, K2 = crop_resize_to_aspect(frame.rgb, frame.K, target_hw=(H, W))
        det, _ = self.detector.get_detections(
            ObservationBatch(rgb=x_r, K=K2),
            detection_th=self.detection_th,
            one_instance_per_class=self.one_instance_per_class,
            max_detections=self.max_detections,
        )
        if det.n_rows == 0:
            return None
        # invert the aspect crop: boxes were predicted in the resized frame
        return DetectionBatch.from_numpy(
            boxes=boxes_to_frame(
                det.boxes.cpu().numpy(), obs.K, K2[0].cpu().numpy()
            ),
            obj_ids=det.obj_ids.cpu().numpy(),
            scores=det.scores.cpu().numpy(),
            device=self.device,
        )

    def _detections_for(self, obs: SceneObservation) -> Optional[DetectionBatch]:
        if self.detection_type == "gt":
            if obs.obj_labels is None:
                return None
            keep = [
                i
                for i in range(len(obs.obj_labels))
                if (obs.visib_fract is None or obs.visib_fract[i] > self.min_visib_fract)
                and obs.obj_labels[i] in self.mesh_db.label_to_id
            ]
            if not keep:
                return None
            boxes = obs.bboxes[keep]
            ids = self.mesh_db.ids_of([obs.obj_labels[i] for i in keep])
            return DetectionBatch.from_numpy(
                boxes=boxes, obj_ids=ids, device=self.device
            )
        if self.detection_type == "detector":
            return self._detections_from_detector(obs)
        if self.detection_type == "external":
            det = self.external_detections.get((obs.scene_id, obs.view_id))
            if det is None:
                return None
            return DetectionBatch.from_numpy(
                boxes=np.asarray(det["boxes"], np.float32),
                obj_ids=self.mesh_db.ids_of(det["labels"]),
                scores=np.asarray(det.get("scores"), np.float32)
                if "scores" in det
                else None,
                device=self.device,
            )
        raise ValueError(self.detection_type)

    def get_predictions(self) -> Dict[str, List[dict]]:
        """Returns {"final": [per-frame dicts], ...} with numpy results.

        The result is cached on the runner: the pipeline over the split is
        the expensive part of an eval, and both the metrics and the BOP csv
        read it."""
        if getattr(self, "_cached_predictions", None) is not None:
            return self._cached_predictions
        sampler = DistributedSceneSampler(
            len(self.scene_ds), self.n_replicas, self.rank, shuffle=False
        )
        out: Dict[str, List[dict]] = {"final": []}
        for idx in sampler:
            if (
                self.max_frames is not None
                and len(out["final"]) >= self.max_frames
            ):
                break
            obs = self.scene_ds[idx]
            det = self._detections_for(obs)
            if det is None:
                continue
            det = DetectionBatch.pad(det, self.max_detections)
            obs_batch = ObservationBatch.from_numpy(
                obs.rgb, obs.K, depth=obs.depth, device=self.device
            )
            # one CUDA graph a frame shape, as JAX's runner jits the frame;
            # a sharded coarse stage runs eagerly (JAX's runner does the same)
            graphed = self.estimator.device_mesh is None
            pipeline = (self.estimator.run_inference_pipeline_jit if graphed
                        else self.estimator.run_inference_pipeline)
            n_keys = len(self.estimator._pipeline_jit_cache) if graphed else 0
            self.synchronize()
            t0 = time.time()
            results = pipeline(obs_batch, det)
            final = results["final"]
            self.synchronize()
            elapsed = time.time() - t0
            if graphed and len(self.estimator._pipeline_jit_cache) > n_keys:
                logger.info(f"frame {len(out['final']) + 1}: a new frame graph ({det.n_rows} "
                            f"detections at {tuple(obs_batch.rgb.shape)}; on the card its "
                            f"capture is included) in {elapsed:.1f}s")
            valid = final.valid.cpu().numpy()
            out["final"].append(
                {
                    "scene_id": obs.scene_id,
                    "view_id": obs.view_id,
                    "poses": final.poses.cpu().numpy()[valid],
                    "obj_ids": final.obj_ids.cpu().numpy()[valid],
                    "scores": final.pose_logits.cpu().numpy()[valid],
                    "time": elapsed,
                }
            )
            n_done = len(out["final"])
            if n_done % 8 == 0 or n_done == 1:
                # the first frame's `elapsed` includes the kernels' build,
                # cuDNN's choice of algorithms and the frame's capture; log
                # it so a long quiet start can be told from a hang
                logger.info(
                    f"frame {n_done}: scene {obs.scene_id} view "
                    f"{obs.view_id} in {elapsed:.1f}s"
                )
        self._cached_predictions = out
        return out


def run_eval(
    runner: PredictionRunner,
    meter,
    obj_dataset=None,
    bop19_evaluator=None,
) -> Dict[str, float]:
    """Predictions -> matched against dataset GT via the meter -> summary.

    If a `Bop19Evaluator` is passed, its official VSD/MSSD/MSPD recalls are
    merged into the summary (the reference gets these from the bop_toolkit
    subprocess, megapose/evaluation/bop.py:162-229)."""
    runner.synchronize()
    t0 = time.time()
    preds = runner.get_predictions()
    runner.synchronize()
    t_pred = time.time() - t0
    t0 = time.time()
    frame_index = {
        (s, v): i for i, (s, v) in enumerate(runner.scene_ds.frames)
    }
    for rec in preds["final"]:
        idx = frame_index.get((rec["scene_id"], rec["view_id"]))
        if idx is None:
            continue
        obs = runner.scene_ds[idx]
        if obs.obj_labels is None:
            continue
        gt_ids = runner.mesh_db.ids_of(obs.obj_labels)
        meter.add(
            TCO_pred=rec["poses"],
            pred_obj_ids=rec["obj_ids"],
            pred_scores=rec["scores"],
            pred_group=np.full(len(rec["poses"]), rec["view_id"]),
            TCO_gt=obs.TWO,
            gt_obj_ids=gt_ids,
            gt_group=np.full(len(gt_ids), rec["view_id"]),
        )
        if bop19_evaluator is not None:
            bop19_evaluator.add_image(
                TCO_pred=rec["poses"],
                pred_obj_ids=rec["obj_ids"],
                pred_scores=rec["scores"],
                TCO_gt=obs.TWO,
                gt_obj_ids=gt_ids,
                K=obs.K,
                gt_visib_fract=obs.visib_fract,
                depth_test=obs.depth,
                im_width=obs.rgb.shape[1],
            )
    summary = meter.summary()
    if bop19_evaluator is not None:
        summary.update(bop19_evaluator.summary())
    runner.synchronize()
    t_metrics = time.time() - t0
    summary["eval_seconds_predictions"] = t_pred
    summary["eval_seconds_metrics"] = t_metrics
    logger.info(
        f"eval timing: predictions {t_pred:.1f}s, "
        f"metrics (meter+bop19) {t_metrics:.1f}s"
    )
    return summary
