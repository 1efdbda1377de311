"""Detector wrapper: model outputs -> DetectionBatch for the pose pipeline
(PyTorch port of `happypose_tpu/inference/detector.py`): score threshold,
label mapping, one_instance_per_class filtering, instance-id assignment.
The model's forward runs as one CUDA graph per image shape (`_forward`, the
counterpart of the JAX wrapper's jitted forward); the postprocess, whose
NMS reads to the host, runs after it. They run under the spans
`detector.forward` and `detector.postprocess` (the read-back and the rows
included)."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from happypose_tpu_torch.inference.types import DetectionBatch, ObservationBatch
from happypose_tpu_torch.models.detector import DetectorOutputs, FCOSDetector, detector_postprocess
from happypose_tpu_torch.utils.cuda_graphs import GraphCache, storage_of
from happypose_tpu_torch.utils.profiling import annotate


class Detector:
    """Owns an `FCOSDetector` in eval mode and the resolution it runs at
    (`image_size`, (H, W)); detections land on the model's device."""

    def __init__(self, model: FCOSDetector, image_size: Tuple[int, int] = (240, 320)):
        self.model = model.eval()
        self.image_size = image_size
        self._forward_graphs = GraphCache("detector")

    def _forward(self, rgb: torch.Tensor) -> DetectorOutputs:
        """`self.model(rgb)` through its graph of `rgb`'s shape (on a CPU
        tensor: the same path with a plain call)."""
        key = ("forward", self.model.training, storage_of(self.model))
        return self._forward_graphs(key, self.model, (rgb,), captured=(self.model,))

    @torch.inference_mode()
    def get_detections(
        self,
        observation: ObservationBatch,
        detection_th: float = 0.3,
        one_instance_per_class: bool = False,
        max_detections: int = 32,
        iou_threshold: float = 0.5,
    ) -> Tuple[DetectionBatch, Dict[str, np.ndarray]]:
        """Run the detector on `observation.rgb`; returns (DetectionBatch,
        {"masks": [N, Hm, Wm] bool}). Labels are the detector's class
        indices, used as object ids."""
        with annotate("detector.forward"):
            out = self._forward(observation.rgb)
        with annotate("detector.postprocess"):
            post = detector_postprocess(
                out,
                score_threshold=detection_th,
                iou_threshold=iou_threshold,
                max_detections=max_detections,
            )
            boxes, scores, labels, valid, masks = (
                post[k].cpu().numpy() for k in ("boxes", "scores", "labels", "valid", "masks")
            )
            device = observation.rgb.device

            rows_boxes, rows_ids, rows_im, rows_scores, rows_masks = [], [], [], [], []
            for b in range(boxes.shape[0]):
                keep = np.where(valid[b])[0]
                if one_instance_per_class:
                    # keep the best-scored instance per class, in slot order
                    best: Dict[int, int] = {}
                    for i in keep:
                        c = int(labels[b, i])
                        if c not in best or scores[b, i] > scores[b, best[c]]:
                            best[c] = i
                    keep = np.asarray(sorted(best.values()), int)
                for i in keep:
                    rows_boxes.append(boxes[b, i])
                    rows_ids.append(labels[b, i])
                    rows_im.append(b)
                    rows_scores.append(scores[b, i])
                    rows_masks.append(masks[b, i])
            if not rows_boxes:
                det = DetectionBatch.from_numpy(
                    boxes=np.zeros((0, 4), np.float32), obj_ids=np.zeros((0,), np.int64),
                    device=device,
                )
                return det, {"masks": np.zeros((0, 1, 1), bool)}
            det = DetectionBatch.from_numpy(
                boxes=np.stack(rows_boxes),
                obj_ids=np.asarray(rows_ids, np.int64),
                batch_im_ids=np.asarray(rows_im, np.int64),
                scores=np.asarray(rows_scores, np.float32),
                device=device,
            )
            return det, {"masks": np.stack(rows_masks)}
