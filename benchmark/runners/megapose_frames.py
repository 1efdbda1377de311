"""MegaPose on camera frames: each frame's detections through the port's
whole-frame graph, `PoseEstimator.run_inference_pipeline_jit`, in a closed
loop (the next frame goes in when the last frame's poses are on the host).

The comparison takes a sample of the window's frames (the one with the
most detections among them) and holds every stage that the frame's graph
returned to the reference:
- `coarse_logit_gap`: every grid hypothesis's coarse logit (from its
  autodepth pose, crop and render), and how far below the reference's
  K-th best logit of its detection a kept hypothesis lies (0 where the
  picks are the reference's), over the spread (standard deviation) of the
  reference's logits of the frame;
- `refine_gap`: each refiner iteration's update, from the same input pose
  (iteration 1 from the reference's own hypothesis, the later ones from
  the program's previous iteration), over the median update's size;
- `score_logit_gap`: the scoring logits of the refined poses, and how far
  below the reference's best score of its detection the kept final pose
  lies, over the same spread.
A pick alone would read 0 under the control too (a precision below
float32 rarely swaps a top-5), so each pick is held within the logits'
number.
"""

from __future__ import annotations

import sys
from typing import Dict

import numpy as np
import torch

from benchmark.runners.megapose import MegaPoseWorld, pick_sample, worst
from benchmark.harness import Record
from benchmark.reference import megapose as ref

COARSE_BLOCK, REFINE_BLOCK = 288, 16  # the reference's batches


class Runner:
    CONTROLS = ("tf32",)

    def __init__(self, cell: Dict, seed: int, device: torch.device):
        self.w = MegaPoseWorld(cell, seed, device)
        self.cell, self.device = cell, device
        self.traffic = self.w.traffic
        self.est = self.w.program()
        cfg = self.w.cfg
        self.M, self.H, self.I = cfg["so3_grid_size"], cfg["n_pose_hypotheses"], \
            cfg["n_refiner_iterations"]

    def warm(self):
        """One frame of each detection count the traffic holds (each is a
        graph key: warm-up and capture)."""
        counts = sorted({len(it["obj_ids"]) for it in self.traffic["items"]})
        for d in counts:
            self.run(next(it for it in self.traffic["items"] if len(it["obj_ids"]) == d))
        print(f"benchmark: warmed graph keys for detection counts {counts}", file=sys.stderr)

    def frame_flops(self, d: int) -> float:
        f = self.w.forward_flops
        return d * (self.M * f[1] + self.H * self.I * f[9] + self.H * f[1])

    def run(self, item) -> Record:
        from happypose_tpu_torch.inference.types import DetectionBatch, ObservationBatch

        obs = ObservationBatch.from_numpy(self.w.images[item["image"]], item["K"],
                                          device=self.device)
        det = DetectionBatch.from_numpy(item["boxes"], item["obj_ids"], device=self.device)
        res = self.est.run_inference_pipeline_jit(obs, det, n_refiner_iterations=self.I,
                                                  n_pose_hypotheses=self.H)
        poses, valid = res["final"].poses.cpu(), res["final"].valid.cpu()
        d = len(item["obj_ids"])
        ok = int(valid.sum()) == d and bool(torch.isfinite(poses[valid]).all())
        return Record(0.0, 0.0, units=d, ok=ok, keep=(item, res),
                      model_flops=self.frame_flops(d))

    def release(self):
        del self.est
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def raster_work(self, records):
        """(bytes, pixel tests) of every render of the records' frames: the
        grid hypotheses, each refiner iteration's input and the scoring."""
        n_bytes = tests = 0
        for rec in records:
            item, res = rec.keep
            scene = self.w.scene(item["image"], item["K"])
            coarse = res["coarse"]
            iters = [res[f"iteration={k}"] for k in range(1, self.I + 1)]
            passes = [(coarse.obj_ids, coarse.poses)]
            passes.append((iters[0].obj_ids, coarse.poses[self._selected_rows(item, iters[0])]))
            passes += [(it.obj_ids, it.poses) for it in iters]
            for ids, T in passes:
                b, t = self.w.render_work(scene, ids, T)
                n_bytes, tests = n_bytes + b, tests + t
        return n_bytes, tests

    def _selected_rows(self, item, first):
        """Rows of the coarse hypotheses that the refiner's rows start from."""
        det_of = {int(o): d for d, o in enumerate(item["obj_ids"])}
        det = torch.tensor([det_of[int(o)] for o in first.obj_ids.tolist()], device=self.device)
        return det * self.M + first.hypothesis_ids

    # ---------------------------------------------------------- comparison

    def check(self, records, rng: np.random.Generator, control=None) -> Dict:
        sample = pick_sample(records, rng, self.cell["sample"])
        return worst([self.compare(*r.keep, control=control) for r in sample],
                     self.cell["limits"])

    def compare(self, item, res, control=None) -> Dict[str, float]:
        """The frame's numbers: the program's stages (with `control="tf32"`,
        the reference's own in TF32 at the program's positions) against the
        reference's."""
        w, dev, M, H, I = self.w, self.device, self.M, self.H, self.I
        scene = w.scene(item["image"], item["K"])
        boxes = torch.from_numpy(item["boxes"]).to(dev)
        ids = torch.from_numpy(item["obj_ids"]).to(dev)
        D = len(ids)
        grid = w.grid()
        with ref.precision(False, dev):
            init_ref, hyp_ids = ref.grid_hypotheses(grid, boxes, ids, scene.K, scene)
        coarse_ref = ref.logits(w.P_coarse, scene, hyp_ids, init_ref, w.size, COARSE_BLOCK)
        scale = coarse_ref.std()

        iters = [res[f"iteration={k}"] for k in range(1, I + 1)]
        sel = self._selected_rows(item, iters[0])
        row_det = sel // M
        inputs = [init_ref[sel]] + [it.poses for it in iters[:-1]]
        refined = iters[-1].poses
        score_ref = ref.logits(w.P_coarse, scene, ids[row_det], refined, w.size, COARSE_BLOCK)

        if control:
            coarse = ref.logits(w.P_coarse, scene, hyp_ids, init_ref, w.size, COARSE_BLOCK,
                                tf32=True)
            kept = coarse.view(D, M).topk(H, dim=1).indices + torch.arange(D, device=dev)[:, None] * M
            kept = kept.flatten()
            outs = [ref.refine(w.P_refiner, scene, ids[row_det], x, w.size, REFINE_BLOCK, tf32=True)
                    for x in inputs]
            score = ref.logits(w.P_coarse, scene, ids[row_det], refined, w.size, COARSE_BLOCK,
                               tf32=True)
        else:
            coarse = res["coarse"].coarse_logits
            kept, outs = sel, [it.poses for it in iters]
            score = res["scored"].pose_logits
        final = res["final"].valid
        if control:
            best = torch.full((D,), -torch.inf, device=dev).scatter_reduce(0, row_det, score, "amax")
            final = score == best[row_det]

        gaps, sizes = zip(*(ref.update_gap(x, o, ref.refine(w.P_refiner, scene, ids[row_det], x,
                                                             w.size, REFINE_BLOCK))
                            for x, o in zip(inputs, outs)))
        kth = coarse_ref.view(D, M).topk(H, dim=1).values[:, -1]
        best_score = torch.full((D,), -torch.inf, device=dev).scatter_reduce(
            0, row_det, score_ref, "amax")
        kept_short = (kth[kept // M] - coarse_ref[kept]).clamp(min=0).max()
        final_short = (best_score[row_det] - score_ref)[final].clamp(min=0).max()
        return {
            "coarse_logit_gap": torch.maximum((coarse - coarse_ref).abs().max(), kept_short) / scale,
            "refine_gap": torch.cat(gaps).max() / torch.cat(sizes).median(),
            "score_logit_gap": torch.maximum((score - score_ref).abs().max(), final_short) / scale,
        }
