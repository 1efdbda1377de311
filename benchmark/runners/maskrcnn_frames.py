"""Mask R-CNN on camera frames: each item runs the port's
`Detector.get_detections` (its forward one CUDA graph of the frame's
shape: trunk, RPN, NMS, box stage, NMS, mask stage and paste) on the
480x640 frame with no resize, and reads the kept rows' boxes, scores,
labels and full-resolution masks to the host, in a closed loop. The
traffic's boxes are not used.

The comparison takes a sample of the window's frames (a reservoir drawn
from the seed as the window runs, so that only the sampled frames keep
their outputs on the card). Each number is a largest gap over the frames;
the reference runs on the frame's image and, where a near-tie could flip
a discrete choice, at the program's choices:
- `rpn_gap`: the RPN's objectness and deltas of every anchor, over their
  spread; infinite unless the reference's selection (top-k a level,
  decoding, the level-aware NMS) on the program's numbers keeps the
  program's anchors index for index;
- `box_gap`: the class logits and box deltas at the program's proposals,
  over their spread; infinite unless the reference's selection of
  detections on the program's numbers keeps the program's pairs;
- `det_gap`: the rows the host got (one instance a class, scores over the
  threshold) against the reference's score (over the largest) and box
  (over the box's size) at the program's pairs; infinite where a row's
  label or the rows' count differs;
- `mask_gap`: the mask logits at the program's detections, over their
  spread; infinite where a row's mask on the host differs from the
  reference's paste of the program's probabilities by a pixel further than
  1e-5 from the threshold.
With `control`, the reference takes the program's place: in TF32
("tf32"), or with each RoI read one pyramid level above its own
("level_up").
"""

from __future__ import annotations

import sys
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from benchmark import maskrcnn_counts, traffic, world
from benchmark.harness import Record
from benchmark.reference import maskrcnn as ref
from benchmark.reference import megapose as megapose_ref
from benchmark.runners.megapose import worst

PASTE_MARGIN = 1e-5


class Runner:
    CONTROLS = ("tf32", "level_up")

    def __init__(self, cell: Dict, seed: int, device: torch.device):
        cfg, mix = cell["config_spec"], cell["mix_spec"]
        self.cell, self.cfg, self.device = cell, cfg, device
        self.hw = tuple(cfg["image_size"])
        gen = world.device_generator(seed, device)
        self.P = world.make_weights(ref.trunk_params(cfg["fpn_channels"]), gen, device, {})
        self.P.update(ref.head_weights(ref.head_params(cfg), gen, device))
        self.traffic = traffic.generate(mix, seed, cfg["n_classes"] - 1)
        self.images = world.make_images(gen, self.traffic["images"], self.hw, device)
        macs = maskrcnn_counts.frame_macs(cfg, *self.hw)
        self.frame_flops = 2 * sum(macs.values())
        self.rng = np.random.default_rng([seed % (1 << 63), 11])
        self.kept, self.seen = [], 0
        self._refs: Dict = {}
        self._build_program()

    def _build_program(self):
        from happypose_tpu_torch.models.mask_rcnn import config_from_dict
        from happypose_tpu_torch.utils.load_model import load_detector

        self.detector = load_detector(config_from_dict(self.cfg), state_dict=self.P,
                                      device=self.device, image_size=self.hw)

    def warm(self):
        for item in self.traffic["items"][:2]:
            self.run(item)
        self.kept, self.seen = [], 0
        print(f"benchmark: warmed the detector's graph at {self.hw}", file=sys.stderr)

    def run(self, item) -> Record:
        from happypose_tpu_torch.inference.types import ObservationBatch

        obs = ObservationBatch.from_numpy(self.images[item["image"]], item["K"],
                                          device=self.device)
        det, extra = self.detector.get_detections(
            obs, detection_th=self.cfg["detection_th"],
            one_instance_per_class=self.cfg["one_instance_per_class"])
        rows = {"boxes": det.boxes.cpu(), "scores": det.scores.cpu(),
                "labels": det.obj_ids.cpu(), "masks": extra["masks"]}
        out = extra["outputs"]
        rec = Record(0.0, 0.0, units=1, ok=bool(torch.isfinite(rows["boxes"]).all()),
                     keep={"image": item["image"], "rois": (out.proposals, out.boxes),
                           "rows": rows, "outputs": out},
                     model_flops=self.frame_flops)
        self._reservoir(rec)
        return rec

    def _reservoir(self, rec):
        """Keep `sample` frames' outputs, a uniform sample of those seen
        (Algorithm R, from the seed); the others drop theirs at once."""
        k = self.cell["sample"]
        if len(self.kept) < k:
            self.kept.append(rec)
        else:
            j = int(self.rng.integers(self.seen + 1))
            if j < k:
                self.kept[j].keep.update(rows=None, outputs=None)
                self.kept[j] = rec
            else:
                rec.keep.update(rows=None, outputs=None)
        self.seen += 1

    def release(self):
        del self.detector
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def roi_work(self, records):
        """(bytes, flops) of the records' RoIAlign calls: the proposals' 7x7
        and the detections' 14x14 (`maskrcnn_counts.roi_align_work`)."""
        cfg, (H, W) = self.cfg, self.hw
        sizes = maskrcnn_counts.level_sizes(H, W)[:4]
        scales = [2.0 ** round(np.log2(h / H)) for h, _ in sizes]
        n_bytes = n_flops = 0
        for rec in records:
            for boxes, size in zip(rec.keep["rois"], (cfg["box_roi_size"], cfg["mask_roi_size"])):
                lv = ref.level_of(boxes[0]).cpu().numpy()
                w = maskrcnn_counts.roi_align_work(sizes, scales, cfg["fpn_channels"],
                                                   boxes[0].cpu().numpy(), lv, size,
                                                   cfg["sampling_ratio"])
                n_bytes, n_flops = n_bytes + w[0], n_flops + w[1]
        return n_bytes, n_flops

    def nms_bytes(self, records):
        """Bytes of the records' NMS calls: the RPN's candidates (the top of
        each level) and the box stage's pair budget."""
        cfg = self.cfg
        counts = [h * w * len(cfg["aspect_ratios"])
                  for h, w in maskrcnn_counts.level_sizes(*self.hw)]
        n_rpn = sum(min(cfg["rpn_pre_nms_top_n"], n) for n in counts)
        n_box = min(cfg["box_pair_budget"], cfg["rpn_post_nms_top_n"] * (cfg["n_classes"] - 1))
        per = maskrcnn_counts.nms_bytes(n_rpn) + maskrcnn_counts.nms_bytes(n_box)
        return per * len(records)

    def check(self, records, rng: np.random.Generator, control=None) -> Dict:
        sample = [r for r in records if r.keep.get("outputs") is not None]
        sample = [sample[i] for i in rng.permutation(len(sample))[:self.cell["sample"]]]
        return worst([self.compare(r.keep, control) for r in sample], self.cell["limits"])

    def _reference(self, image: int, tf32: bool):
        """The reference's pyramid and RPN of an image (kept for the run)."""
        key = (image, tf32)
        if key not in self._refs:
            img = torch.from_numpy(self.images[image]).to(self.device).permute(2, 0, 1)[None]
            conv = megapose_ref.conv_for(tf32, self.device)
            with megapose_ref.precision(tf32, self.device), torch.no_grad():
                feats = ref.pyramid(self.P, img.contiguous(), conv=conv)
                logits, deltas = ref.rpn_head(self.P, feats, conv=conv)
            self._refs[key] = (feats, logits, deltas)
        return self._refs[key]

    def _heads(self, image, props, boxes, labels, tf32, shift):
        feats = self._reference(image, tf32)[0]
        conv = megapose_ref.conv_for(tf32, self.device)
        with megapose_ref.precision(tf32, self.device), torch.no_grad():
            cl, bd = ref.box_head(self.P, feats, self.hw, props, 0, shift=shift)
            ml = ref.mask_logits(self.P, feats, self.hw, boxes, labels, 0, conv=conv, shift=shift)
        return cl, bd, ml

    def compare(self, keep, control=None) -> Dict[str, float]:
        cfg, hw, image = self.cfg, self.hw, keep["image"]
        out, rows = keep["outputs"], keep["rows"]
        n, d = int(out.proposal_valid[0].sum()), int(out.valid[0].sum())
        props, boxes, labels = out.proposals[0, :n], out.boxes[0, :d], out.labels[0, :d]
        _, r_logits, r_deltas = self._reference(image, False)
        r_cl, r_bd, r_ml = self._heads(image, props, boxes, labels, False, 0)
        if control:  # the control's numbers in the program's place
            tf32 = control == "tf32"
            _, p_logits, p_deltas = self._reference(image, tf32)
            p_cl, p_bd, p_ml = self._heads(image, props, boxes, labels, tf32,
                                           int(control == "level_up"))
        else:
            p_logits, p_deltas = out.rpn_logits[0], out.rpn_deltas[0]
            p_cl, p_bd = out.class_logits[0, :n], out.box_deltas[0, :n]
            p_ml = out.mask_logits[0, :d]

        def spread_gap(a, b):
            return float((a - b).abs().max() / b.std())

        inf = float("inf")
        rpn_gap = max(spread_gap(p_logits, r_logits[0]), spread_gap(p_deltas, r_deltas[0]))
        box_gap = max(spread_gap(p_cl, r_cl), spread_gap(p_bd, r_bd))
        mask_gap = spread_gap(p_ml, r_ml)
        if not control:  # the program's discrete choices, from its own numbers
            feats = self._reference(image, False)[0]
            anchors = ref.anchors(feats, hw, cfg)
            counts = [f.shape[-2] * f.shape[-1] * len(cfg["aspect_ratios"]) for f in feats]
            kept = ref.select_proposals(out.rpn_logits, out.rpn_deltas, anchors, counts, hw, cfg)[0]
            if not torch.equal(kept, out.proposal_anchor[0, :n]):
                rpn_gap = inf
            pair = ref.select_detections(props, p_cl, p_bd, hw, cfg)[0]
            if not torch.equal(pair, out.det_pair[0, :d]):
                box_gap = inf
        # the rows: the reference's scores and boxes at the program's pairs
        pair = out.det_pair[0, :d]
        r, c = pair // (cfg["n_classes"] - 1), pair % (cfg["n_classes"] - 1) + 1

        def at_pairs(cl, bd):  # scores and boxes of the program's pairs
            decoded = ref.clip(ref.decode(bd[r, c], props[r], (10.0, 10.0, 5.0, 5.0)), hw)
            return F.softmax(cl, -1)[r, c], decoded

        want_scores, want_boxes = at_pairs(r_cl, r_bd)
        slots = self._rows(out.scores[0, :d], labels)
        if control:
            got_scores, got_boxes = (x[slots] for x in at_pairs(p_cl, p_bd))
            got_labels = labels[slots]
        else:
            got_scores = rows["scores"].to(self.device)
            got_boxes = rows["boxes"].to(self.device)
            got_labels = rows["labels"].to(self.device)
        if len(slots) != len(got_scores) or not torch.equal(got_labels, labels[slots]):
            det_gap = inf
        elif not len(slots):
            det_gap = 0.0
        else:
            top = want_scores.max()
            size = (want_boxes[slots, 2:] - want_boxes[slots, :2]).abs().amax(-1).clamp(min=1.0)
            det_gap = float(torch.maximum(
                (got_scores - want_scores[slots]).abs() / top,
                (got_boxes - want_boxes[slots]).abs().amax(-1) / size).max())
        if not control and len(slots):
            probs = ref.paste(torch.sigmoid(out.mask_logits[0, slots]), boxes[slots], hw)
            host = torch.from_numpy(rows["masks"]).to(self.device)
            differ = (probs > cfg["mask_threshold"]) != host
            if bool(((probs - cfg["mask_threshold"]).abs()[differ] > PASTE_MARGIN).any()):
                mask_gap = inf
        return {"rpn_gap": rpn_gap, "box_gap": box_gap, "det_gap": det_gap, "mask_gap": mask_gap}

    def _rows(self, scores, labels) -> torch.Tensor:
        """The detection slots the wrapper makes rows of: scores over the
        threshold, the best of each label where one instance a class is
        kept, in slot order."""
        ok = (scores > self.cfg["detection_th"]).nonzero()[:, 0].tolist()
        if self.cfg["one_instance_per_class"]:
            best: Dict[int, int] = {}
            for i in ok:
                lab = int(labels[i])
                if lab not in best or scores[i] > scores[best[lab]]:
                    best[lab] = i
            ok = sorted(best.values())
        return torch.tensor(ok, dtype=torch.long, device=scores.device)
