"""MegaPose tracking: sessions of camera frames, each frame one refiner
iteration of the session's objects from the poses the previous frame
returned (`PoseEstimator.forward_refiner(obs, estimates, 1)`, the port's
eager path), in a closed loop. A session's first frame starts from the
traffic's poses.

The comparison takes a sample of the window's frames (the one with the
most objects among them) and holds each frame's refined poses to the
reference's iteration from the same input poses (the program's previous
output): `refine_gap`, the largest difference of the update over the
median update's size of the frame.
"""

from __future__ import annotations

import sys
from typing import Dict

import numpy as np
import torch

from benchmark.runners.megapose import MegaPoseWorld, pick_sample, worst
from benchmark.harness import Record
from benchmark.reference import megapose as ref

REFINE_BLOCK = 16


class Runner:
    CONTROLS = ("tf32",)

    def __init__(self, cell: Dict, seed: int, device: torch.device):
        self.w = MegaPoseWorld(cell, seed, device)
        self.cell, self.device = cell, device
        self.traffic = self.w.traffic
        self.est = self.w.program()
        self.poses = None  # the session's current poses, on the device

    def warm(self):
        """One frame of each object count the traffic holds, from its
        session's starting poses, on copies: the sessions start afresh."""
        firsts = {}
        for it in self.traffic["items"]:
            if it["init"] is not None:
                firsts.setdefault(len(it["obj_ids"]), it)
        for k in sorted(firsts):
            self._refine(firsts[k], torch.from_numpy(firsts[k]["init"]).to(self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        print(f"benchmark: warmed object counts {sorted(firsts)}", file=sys.stderr)

    def _refine(self, item, poses):
        from happypose_tpu_torch.inference.types import ObservationBatch, PoseEstimateBatch

        obs = ObservationBatch.from_numpy(self.w.images[item["image"]], item["K"],
                                          device=self.device)
        k, dev = len(item["obj_ids"]), self.device
        zeros_i = torch.zeros(k, dtype=torch.int64, device=dev)
        zeros_f = torch.zeros(k, device=dev)
        est = PoseEstimateBatch(
            poses=poses, K=obs.K.expand(k, 3, 3), obj_ids=torch.from_numpy(item["obj_ids"]).to(dev),
            batch_im_ids=zeros_i, instance_ids=zeros_i, hypothesis_ids=zeros_i,
            scores=torch.ones(k, device=dev), coarse_logits=zeros_f, pose_logits=zeros_f,
            valid=torch.ones(k, dtype=torch.bool, device=dev))
        final, _ = self.est.forward_refiner(obs, est, 1)
        return final.poses

    def run(self, item) -> Record:
        if item["init"] is not None:
            self.poses = torch.from_numpy(item["init"]).to(self.device)
        inputs = self.poses
        self.poses = self._refine(item, inputs)
        host = self.poses.cpu()
        k = len(item["obj_ids"])
        return Record(0.0, 0.0, units=k, ok=bool(torch.isfinite(host).all()),
                      keep=(item, inputs, self.poses),
                      model_flops=k * self.w.forward_flops[9])

    def release(self):
        del self.est
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def raster_work(self, records):
        """(bytes, pixel tests) of the records' renders, one a tracked
        object at its input pose."""
        n_bytes = tests = 0
        for rec in records:
            item, inputs, _ = rec.keep
            ids = torch.from_numpy(item["obj_ids"]).to(self.device)
            b, t = self.w.render_work(self.w.scene(item["image"], item["K"]), ids, inputs)
            n_bytes, tests = n_bytes + b, tests + t
        return n_bytes, tests

    def check(self, records, rng: np.random.Generator, control=None) -> Dict:
        sample = pick_sample(records, rng, self.cell["sample"])
        return worst([self.compare(*r.keep, control=control) for r in sample],
                     self.cell["limits"])

    def compare(self, item, inputs, outputs, control=None) -> Dict[str, float]:
        w = self.w
        scene = w.scene(item["image"], item["K"])
        ids = torch.from_numpy(item["obj_ids"]).to(self.device)
        refined = ref.refine(w.P_refiner, scene, ids, inputs, w.size, REFINE_BLOCK)
        if control:
            outputs = ref.refine(w.P_refiner, scene, ids, inputs, w.size, REFINE_BLOCK, tf32=True)
        gap, size = ref.update_gap(inputs, outputs, refined)
        return {"refine_gap": gap.max() / size.median()}
