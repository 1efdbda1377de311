"""Detector wrapper: model outputs -> DetectionBatch for the pose pipeline
(PyTorch port of `happypose_tpu/inference/detector.py`): score threshold,
label mapping, one_instance_per_class filtering, instance-id assignment.
The model is the port's FCOS (`models.detector.FCOSDetector`) or Mask
R-CNN (`models.mask_rcnn.MaskRCNN`). Its forward and its fixed-slot
detections, NMS included, run as one CUDA graph per image shape, NMS
threshold and budget (`_detect`, the counterpart of the JAX wrapper's
jitted forward): FCOS's `detector_postprocess` follows its forward there,
and Mask R-CNN's forward holds its own NMS and mask paste; that body is
the one place the two models are told apart. The host then applies the
score threshold, reads the detections, makes the rows and reads the kept
rows' masks, the same code for both models. They run under
the spans `detector.forward` (the replay) and `detector.postprocess` (the
threshold, the read-back and the rows)."""

from __future__ import annotations

import math
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
        self._graphs = GraphCache("detector")

    def _detect(self, rgb: torch.Tensor, iou_threshold: Optional[float] = None,
                max_detections: Optional[int] = None
                ) -> Tuple[Union[DetectorOutputs, MaskRCNNOutputs], Dict[str, torch.Tensor]]:
        """(the forward's outputs, the detections: boxes, scores, labels,
        valid (the NMS's flag) and masks, [B, budget, ...] each, with no
        score threshold), through the graph of `rgb`'s shape and the NMS's
        threshold and budget, which the graph bakes in (on a CPU tensor:
        the same path with a plain call). FCOS's body runs
        `detector_postprocess`, looked up at capture, at the call's
        settings (0.5 and 32 unless given); Mask R-CNN's forward holds its
        NMS, at the settings of `MaskRCNN.nms_settings`."""
        model = self.model
        if isinstance(model, MaskRCNN):
            iou, budget = model.nms_settings(iou_threshold)

            def body(x):
                out = model(x)
                return out, {k: getattr(out, k)
                             for k in ("boxes", "scores", "labels", "valid", "masks")}
        else:
            iou = 0.5 if iou_threshold is None else iou_threshold
            budget = 32 if max_detections is None else max_detections

            def body(x):
                out = model(x)
                return out, detector_postprocess(out, score_threshold=-math.inf,
                                                  iou_threshold=iou, max_detections=budget)
        key = ("detect", iou, budget, model.training, storage_of(model))
        return self._graphs(key, body, (rgb,), captured=(model,))

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
        first `max_detections` of its config's `detections_per_img` (those
        a smaller budget keeps) and raises on another threshold. Its masks
        are at the frame's size. Rows come in (image, slot) order."""
        with annotate("detector.forward"):
            out, post = self._detect(observation.rgb, iou_threshold, max_detections)
        with annotate("detector.postprocess"):
            D = max_detections
            valid = (post["valid"] & (post["scores"] > detection_th))[:, :D].cpu().numpy()
            boxes, scores, labels = (post[k][:, :D].cpu().numpy()
                                     for k in ("boxes", "scores", "labels"))
            im, slot = np.nonzero(valid)
            if one_instance_per_class and len(im):
                # per (image, class) the best score, the lowest slot among equals
                lab = labels[im, slot]
                order = np.lexsort((slot, -scores[im, slot], lab, im))
                im_o, lab_o = im[order], lab[order]
                first = np.r_[True, (im_o[1:] != im_o[:-1]) | (lab_o[1:] != lab_o[:-1])]
                kept = np.sort(order[first])
                im, slot = im[kept], slot[kept]
            device = observation.rgb.device
            if not len(im):
                det = DetectionBatch.from_numpy(
                    boxes=np.zeros((0, 4), np.float32), obj_ids=np.zeros((0,), np.int64),
                    device=device,
                )
                return det, {"masks": np.zeros((0, 1, 1), bool), "outputs": out}
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
