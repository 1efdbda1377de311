"""CosyPose on camera frames: the detector (`Detector.get_detections`, its
forward a CUDA graph) on the frame at the detector's size, then the pose
stages on the frame's detections from the traffic, whole-frame graph
(`PoseEstimator.run_inference_pipeline_jit`: the z-up autodepth init, the
coarse pose model, the refiner), in a closed loop. The detector's seeded
weights find nothing a user would keep, so the pose stage takes the
traffic's boxes; the detector's output is checked all the same.

The comparison takes a sample of the window's frames (the one with the
most detections among them):
- `det_gap`: each detection the program returned against the reference's
  candidate of its class with the nearest box (score over the best score,
  box over the box's size), and the scores of the two kept lists in
  order, over the best score;
- `coarse_gap`: the coarse model's update of the reference's z-up init;
- `refine_gap`: each refiner iteration's update from the program's last
  pose; both over the median update's size.
"""

from __future__ import annotations

import sys
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from benchmark import flops, traffic, world
from benchmark.runners.megapose import N_POSE, pick_sample, render_work, worst
from benchmark.harness import Record
from benchmark.reference import fcos
from benchmark.reference import geometry as G
from benchmark.reference import megapose as ref
from benchmark.reference import nets

BLOCK = 16
ZUP = ((0.0, 1.0, 0.0), (0.0, 0.0, -1.0), (-1.0, 0.0, 0.0))  # BOP'20: object z up


def pose_table(n_inputs: int):
    return nets.effnet_b3_params(n_inputs) + [
        ("pose_fc.weight", (N_POSE, nets.effnet_features()), "pose_head"),
        ("pose_fc.bias", (N_POSE,), "pose_bias")]


class Runner:
    CONTROLS = ("tf32",)

    def __init__(self, cell: Dict, seed: int, device: torch.device):
        cfg, mix = cell["config_spec"], cell["mix_spec"]
        self.cell, self.cfg, self.device = cell, cfg, device
        self.size = tuple(cfg["render_size"])
        self.det_cfg = cfg["detector"]
        n_obj = cfg["objects"]["count"]
        self.objects = world.make_objects(np.random.default_rng([seed % (1 << 63), 1]),
                                          cfg["objects"])
        gen = world.device_generator(seed, device)
        self.P_coarse = world.make_weights(pose_table(6), gen, device, cfg["weights"])
        self.P_refiner = world.make_weights(pose_table(6), gen, device, cfg["weights"])
        self.P_det = world.make_weights(fcos.fcos_params(n_obj, self.det_cfg["fpn_channels"],
                                                         self.det_cfg["n_prototypes"]),
                                        gen, device, cfg["weights"])
        self.traffic = traffic.generate(mix, seed, n_obj)
        self.images = world.make_images(gen, self.traffic["images"], mix["image_size"], device)
        small = F.interpolate(torch.from_numpy(self.images).to(device).permute(0, 3, 1, 2),
                              size=tuple(self.det_cfg["image_size"]), mode="area")
        self.small = small.permute(0, 2, 3, 1).contiguous().cpu().numpy()
        self.meshes = world.reference_meshes(self.objects, device)
        self.points, self.points_mask = world.model_points(self.objects, cfg["n_points"], device)
        self.iters = cfg["n_coarse_iterations"] + cfg["n_refiner_iterations"]
        self.det_flops = 2 * flops.fcos_macs(n_obj, *self.det_cfg["image_size"],
                                             self.det_cfg["fpn_channels"],
                                             self.det_cfg["n_prototypes"])
        self.pose_flops = flops.forward_flops(cfg["backbone"], 6, *self.size, N_POSE)
        self._build_program()

    def _build_program(self):
        from happypose_tpu_torch.inference.types import InferenceConfig
        from happypose_tpu_torch.models.detector import DetectorConfig
        from happypose_tpu_torch.models.pose_predictor import PosePredictorConfig
        from happypose_tpu_torch.utils.load_model import (NamedModelSpec, load_detector,
                                                           load_named_model)

        cfg, d = self.cfg, self.det_cfg
        model = PosePredictorConfig(backbone=cfg["backbone"], render_size=self.size,
                                    render_normals=False, crop_lamb=cfg["crop_lambda"])
        spec = NamedModelSpec(refiner_cfg=model, coarse_cfg=model, inference_cfg=InferenceConfig(
            n_coarse_iterations=cfg["n_coarse_iterations"],
            n_refiner_iterations=cfg["n_refiner_iterations"]))
        self.est = load_named_model(spec, world.program_database(self.objects),
                                    n_points=cfg["n_points"], device=self.device,
                                    state_dicts={"refiner": self.P_refiner, "coarse": self.P_coarse})
        self.detector = load_detector(
            DetectorConfig(n_classes=cfg["objects"]["count"], fpn_channels=d["fpn_channels"],
                           n_prototypes=d["n_prototypes"]),
            state_dict=self.P_det, device=self.device, image_size=tuple(d["image_size"]))

    def warm(self):
        counts = sorted({len(it["obj_ids"]) for it in self.traffic["items"]})
        for c in counts:
            self.run(next(it for it in self.traffic["items"] if len(it["obj_ids"]) == c))
        print(f"benchmark: warmed graph keys for detection counts {counts}", file=sys.stderr)

    def run(self, item) -> Record:
        from happypose_tpu_torch.inference.types import DetectionBatch, ObservationBatch

        d = self.det_cfg
        small = ObservationBatch.from_numpy(self.small[item["image"]], item["K"],
                                            device=self.device)
        found, _ = self.detector.get_detections(small, detection_th=d["detection_th"],
                                                max_detections=d["max_detections"],
                                                iou_threshold=d["iou_threshold"])
        obs = ObservationBatch.from_numpy(self.images[item["image"]], item["K"], device=self.device)
        det = DetectionBatch.from_numpy(item["boxes"], item["obj_ids"], device=self.device)
        res = self.est.run_inference_pipeline_jit(obs, det)
        poses = res["final"].poses.cpu()
        n = len(item["obj_ids"])
        return Record(0.0, 0.0, units=n, ok=bool(torch.isfinite(poses).all()),
                      keep=(item, found, res),
                      model_flops=self.det_flops + n * self.iters * self.pose_flops)

    def release(self):
        del self.est, self.detector
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _scene(self, item):
        img = torch.from_numpy(self.images[item["image"]]).to(self.device).permute(2, 0, 1)[None]
        return ref.Scene(image=img.contiguous(), K=torch.from_numpy(item["K"]).to(self.device)[None],
                         meshes=self.meshes, points=self.points, points_mask=self.points_mask)

    def _inputs(self, item, res):
        """The pose updates' input poses: the reference's z-up init, then the
        program's output of each update before the last."""
        ids = torch.from_numpy(item["obj_ids"]).to(self.device)
        boxes = torch.from_numpy(item["boxes"]).to(self.device)
        n = len(ids)
        R = torch.tensor(ZUP, device=self.device).expand(n, 3, 3)
        with ref.precision(False, self.device):
            init = G.autodepth_init(boxes, self.points[ids], self.points_mask[ids],
                                    torch.from_numpy(item["K"]).to(self.device).expand(n, 3, 3), R)
        outs = [res["coarse"].poses] + [res[f"iteration={k}"].poses
                                        for k in range(1, self.cfg["n_refiner_iterations"] + 1)]
        return ids, [init] + outs[:-1], outs

    def raster_work(self, records):
        """(bytes, pixel tests) of every render of the records' frames: one
        a detection and pose update, at the update's input pose."""
        n_bytes = tests = 0
        for rec in records:
            item, _, res = rec.keep
            scene = self._scene(item)
            ids, inputs, _ = self._inputs(item, res)
            for T_in in inputs:
                b, t = render_work(self.objects, scene, ids, T_in, self.size)
                n_bytes, tests = n_bytes + b, tests + t
        return n_bytes, tests

    def check(self, records, rng: np.random.Generator, control=None) -> Dict:
        sample = pick_sample(records, rng, self.cell["sample"])
        return worst([self.compare(*r.keep, control=control) for r in sample],
                     self.cell["limits"])

    def _detections(self, item, tf32: bool):
        """The reference's candidates and kept detections of the frame."""
        d = self.det_cfg
        img = torch.from_numpy(self.small[item["image"]]).to(self.device).permute(2, 0, 1)[None]
        with ref.precision(tf32, self.device), torch.no_grad():
            out = fcos.forward(self.P_det, img.contiguous(), conv=ref.conv_for(tf32, self.device))
            boxes, scores, labels = (x[0] for x in fcos.candidates(out))
        keep = fcos.nms(boxes, scores, labels, d["iou_threshold"], d["max_detections"])
        return boxes, scores, labels, keep

    def compare(self, item, found, res, control=None) -> Dict[str, float]:
        boxes, scores, labels, keep = self._detections(item, tf32=False)
        if control:
            c_boxes, c_scores, c_labels, c_keep = self._detections(item, tf32=True)
            p_boxes, p_scores, p_labels = c_boxes[c_keep], c_scores[c_keep], c_labels[c_keep]
        else:
            p_boxes, p_scores, p_labels = found.boxes, found.scores, found.obj_ids
        top = scores.max()
        gaps = []
        for b, s, lab in zip(p_boxes, p_scores, p_labels):
            same = labels == lab
            if not bool(same.any()):
                gaps.append(torch.tensor(float("inf")))
                continue
            dist = (boxes[same] - b).abs().amax(-1)
            j = int(dist.argmin())
            size = (boxes[same][j, 2:] - boxes[same][j, :2]).abs().max().clamp(min=1.0)
            gaps.append(torch.maximum((s - scores[same][j]).abs() / top, dist[j] / size).cpu())
        n = min(len(keep), len(p_scores))
        order = (torch.sort(p_scores, descending=True).values[:n].cpu()
                 - torch.sort(scores[keep], descending=True).values[:n].cpu()).abs() / top.cpu()
        det_gap = max([float(g) for g in gaps] + [float(order.max()) if n else 0.0]
                      + [float("inf") if len(keep) != len(p_scores) else 0.0])

        scene = self._scene(item)
        ids, inputs, outs = self._inputs(item, res)
        models = [self.P_coarse] * self.cfg["n_coarse_iterations"] + \
            [self.P_refiner] * self.cfg["n_refiner_iterations"]
        gaps = []
        for P, x, o in zip(models, inputs, outs):
            step = dict(backbone=self.cfg["backbone"], normals=False)
            r = ref.refine(P, scene, ids, x, self.size, BLOCK, **step)
            if control:
                o = ref.refine(P, scene, ids, x, self.size, BLOCK, tf32=True, **step)
            gaps.append(ref.update_gap(x, o, r))
        n_c = self.cfg["n_coarse_iterations"]

        def rel(parts):
            g, s = zip(*parts)
            return float(torch.cat(g).max() / torch.cat(s).median())

        return {"det_gap": det_gap, "coarse_gap": rel(gaps[:n_c]), "refine_gap": rel(gaps[n_c:])}
