"""Detector wrapper: model outputs -> DetectionBatch for the pose pipeline
(PyTorch port of `happypose_tpu/inference/detector.py`): score threshold,
label mapping, one_instance_per_class filtering, instance-id assignment.
The model is the port's FCOS (`models.detector.FCOSDetector`) or Mask
R-CNN (`models.mask_rcnn.MaskRCNN`). Its forward runs as one CUDA graph per
image shape (`_forward`, the counterpart of the JAX wrapper's jitted
forward). FCOS's postprocess, whose NMS reads to the host, runs after it;
Mask R-CNN's graph holds its whole forward, NMS and mask paste included.
Each model's post-processing is chosen once, when the wrapper is made
(`_postprocess`). The host then reads the detections, makes the rows (the
same code for both models) and reads the kept rows' masks. They run under the spans
`detector.forward` and `detector.postprocess` (the read-back and the rows
included)."""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from happypose_tpu_torch.inference.types import DetectionBatch, ObservationBatch
from happypose_tpu_torch.models.detector import DetectorOutputs, FCOSDetector, detector_postprocess
from happypose_tpu_torch.models.mask_rcnn import MaskRCNN, MaskRCNNOutputs
from happypose_tpu_torch.utils.cuda_graphs import GraphCache, storage_of
from happypose_tpu_torch.utils.profiling import annotate


class Detector:
    """Owns an `FCOSDetector` or a `MaskRCNN` in eval mode and the resolution
    it runs at (`image_size`, (H, W)); detections land on the model's
    device."""

    def __init__(self, model: Union[FCOSDetector, MaskRCNN],
                 image_size: Tuple[int, int] = (240, 320)):
        self.model = model.eval()
        self.image_size = image_size
        self._forward_graphs = GraphCache("detector")
        self._postprocess = model.postprocess if isinstance(model, MaskRCNN) \
            else self._fcos_postprocess

    @staticmethod
    def _fcos_postprocess(out: DetectorOutputs, score_threshold: float,
                          iou_threshold: Optional[float] = None,
                          max_detections: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """FCOS's `detector_postprocess`, its NMS at 0.5 and 32 detections
        unless given."""
        return detector_postprocess(
            out,
            score_threshold=score_threshold,
            iou_threshold=0.5 if iou_threshold is None else iou_threshold,
            max_detections=32 if max_detections is None else max_detections,
        )

    def _forward(self, rgb: torch.Tensor) -> Union[DetectorOutputs, MaskRCNNOutputs]:
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
        max_detections: Optional[int] = None,
        iou_threshold: Optional[float] = None,
    ) -> Tuple[DetectionBatch, Dict[str, np.ndarray]]:
        """Run the detector on `observation.rgb`; returns (DetectionBatch,
        {"masks": [N, Hm, Wm] bool, "outputs": the forward's outputs}).
        Labels are the detector's class indices (Mask R-CNN's minus the
        background), used as object ids. `max_detections` and
        `iou_threshold` are the NMS's (FCOS: 32 and 0.5 by default); Mask
        R-CNN's NMS runs at its config's threshold, so it keeps at most the
        first `max_detections` of its config's `detections_per_img` and
        raises on another threshold. Its masks are at the frame's size."""
        with annotate("detector.forward"):
            out = self._forward(observation.rgb)
        with annotate("detector.postprocess"):
            post = self._postprocess(out, detection_th, iou_threshold=iou_threshold,
                                     max_detections=max_detections)
            boxes, scores, labels, valid = (
                post[k].cpu().numpy() for k in ("boxes", "scores", "labels", "valid")
            )
            device = observation.rgb.device

            rows_im, rows_slot = [], []
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
                rows_im += [b] * len(keep)
                rows_slot += [int(i) for i in keep]
            if not rows_im:
                det = DetectionBatch.from_numpy(
                    boxes=np.zeros((0, 4), np.float32), obj_ids=np.zeros((0,), np.int64),
                    device=device,
                )
                return det, {"masks": np.zeros((0, 1, 1), bool), "outputs": out}
            im, slot = np.asarray(rows_im, np.int64), np.asarray(rows_slot, np.int64)
            masks = post["masks"][torch.from_numpy(im).to(post["masks"].device),
                                  torch.from_numpy(slot).to(post["masks"].device)]
            det = DetectionBatch.from_numpy(
                boxes=boxes[im, slot],
                obj_ids=labels[im, slot].astype(np.int64),
                batch_im_ids=im,
                scores=scores[im, slot].astype(np.float32),
                device=device,
            )
            return det, {"masks": masks.cpu().numpy(), "outputs": out}
