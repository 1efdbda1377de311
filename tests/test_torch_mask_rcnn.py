"""Mask R-CNN (`models/mask_rcnn.py`) against the plain reference
(`tests/plain_maskrcnn.py`) on seeded weights (torchvision's
initialisation, `MaskRCNN.init_weights`) at a small size: a 96x128 frame,
32 pyramid channels, a 64-wide box head, 32-wide mask convs, 6 classes;
every count as published. The two kernels' plain versions
(`ops/nms.py`, `ops/multiscale_roi_align.py`, what the CPU runs) against
the reference's NMS and RoIAlign. The reference is handed the port's
discrete choices (which anchors, proposals and pairs were kept) only where
it runs its selection on the port's own numbers, so those compare index
for index.

Tolerances, each with its reason:
- the pyramid and the RPN: the same float32 convolutions in the same
  order on one CPU, so equal;
- RoIAlign: the kernel's and the reference's sums of the same taps in
  another order: 1e-6 of the features' largest value;
- box logits and deltas, mask logits: RoIAlign's rounding carried through
  two linear layers or five convolutions: 1e-5 of the values' spread;
- pasted masks: a pixel may differ only within 1e-5 of the threshold (the
  port pastes by two matrix products, the reference by `F.interpolate`).
"""

import dataclasses

import numpy as np
import pytest
import torch

import plain_maskrcnn as ref
from happypose_tpu_torch.inference.types import ObservationBatch
from happypose_tpu_torch.models import mask_rcnn as mr
from happypose_tpu_torch.ops import multiscale_roi_align as mra
from happypose_tpu_torch.ops import nms as nms_ops
from happypose_tpu_torch.utils import load_model as lm

torch.set_num_threads(2)

H, W = 96, 128
CFG = mr.MaskRCNNConfig(n_classes=6, fpn_channels=32, representation_size=64,
                        mask_layers=(32, 32, 32, 32), box_score_thresh=0.0)
SPREAD_TOL = 1e-5
ROI_TOL = 1e-6
PASTE_MARGIN = 1e-5


@pytest.fixture(scope="module")
def world():
    """The port's model on seeded weights, two frames, its outputs, and the
    reference's view: the state dict, settings and pyramid."""
    model = mr.MaskRCNN(CFG).init_weights(torch.Generator().manual_seed(3)).eval()
    images = torch.from_numpy(np.random.RandomState(0).rand(2, 3, H, W).astype(np.float32))
    with torch.inference_mode():
        out = model(images)
    P = dict(model.state_dict())
    with torch.no_grad():
        feats = ref.pyramid(P, images)
    return model, images, out, P, dataclasses.asdict(CFG), feats


def _n(valid, b):
    n = int(valid[b].sum())
    assert bool(valid[b, :n].all()), "the kept slots come first"
    return n


def _spread_gap(a, b):
    return float((a - b).abs().max() / b.std())


def test_published_settings_are_the_defaults():
    """torchvision's `MaskRCNN` with CosyPose's arguments, widths included."""
    c = mr.MaskRCNNConfig()
    assert (c.n_classes, c.fpn_channels, c.representation_size) == (22, 256, 1024)
    assert c.anchor_sizes == (32, 64, 128, 256, 512) and c.aspect_ratios == (0.5, 1.0, 2.0)
    assert (c.rpn_pre_nms_top_n, c.rpn_post_nms_top_n, c.rpn_nms_thresh) == (1000, 1000, 0.7)
    assert (c.box_roi_size, c.mask_roi_size, c.sampling_ratio) == (7, 14, 2)
    assert (c.box_nms_thresh, c.detections_per_img, c.mask_layers) == (0.5, 100, (256,) * 4)
    model = mr.MaskRCNN(c)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert shapes["box_head.fc6.weight"] == (1024, 12544)
    assert shapes["box_head.fc7.weight"] == (1024, 1024)
    assert shapes["box_predictor.cls_score.weight"] == (22, 1024)
    assert shapes["box_predictor.bbox_pred.weight"] == (88, 1024)
    assert shapes["rpn.cls_logits.weight"] == (3, 256, 1, 1)
    assert shapes["mask_predictor.conv5_mask.weight"] == (256, 256, 2, 2)
    assert shapes["mask_predictor.mask_fcn_logits.weight"] == (22, 256, 1, 1)
    assert shapes["backbone.lat2.weight"] == (256, 256, 1, 1)
    assert shapes["backbone.smooth5.weight"] == (256, 256, 3, 3)


def test_anchors_are_torchvisions(world):
    """The base anchors (rounded) and the grid, strides the padded frame
    over the level: P6 of 480x640 is 8x10, strides 60 and 64."""
    model, _, _, _, cfg, feats = world
    assert mr.base_anchors((32,), (0.5, 1.0, 2.0)) == [
        ((-23.0, -11.0, 23.0, 11.0), (-16.0, -16.0, 16.0, 16.0), (-11.0, -23.0, 11.0, 23.0))]
    assert torch.equal(model.anchors(feats, (H, W)), ref.anchors(feats, (H, W), cfg))
    big = [torch.zeros(1, 1, h, w) for h, w in ((120, 160), (60, 80), (30, 40), (15, 20), (8, 10))]
    a = model.anchors(big, (480, 640))
    assert a.shape == (3 * (19200 + 4800 + 1200 + 300 + 80), 4)
    p6 = a[-240:].reshape(8, 10, 3, 4)
    assert torch.equal(p6[1, 1, 1], torch.tensor([64.0 - 256, 60 - 256, 64 + 256, 60 + 256]))


def test_rpn_and_proposals_match_plain(world):
    """The RPN's logits and deltas equal; the proposals (the anchors kept,
    their boxes) index for index, from the port's own numbers and from the
    reference's."""
    model, _, out, P, cfg, feats = world
    logits, deltas = ref.rpn_head(P, feats)
    assert torch.equal(logits, out.rpn_logits) and torch.equal(deltas, out.rpn_deltas)
    anchors = ref.anchors(feats, (H, W), cfg)
    counts = [f.shape[-2] * f.shape[-1] * 3 for f in feats]
    for mine in (True, False):
        lg, dl = (out.rpn_logits, out.rpn_deltas) if mine else (logits, deltas)
        kept = ref.select_proposals(lg, dl, anchors, counts, (H, W), cfg)
        for b in range(2):
            n = _n(out.proposal_valid, b)
            assert n > 100 and torch.equal(kept[b], out.proposal_anchor[b, :n])
            boxes = ref.clip(ref.decode(dl[b, kept[b]], anchors[kept[b]], (1.0,) * 4), (H, W))
            assert torch.equal(boxes, out.proposals[b, :n])


def test_box_stage_and_detections_match_plain(world):
    """Box logits and deltas at the port's proposals to 1e-5 of their
    spread; the detections (pairs, boxes, scores, labels) index for index
    from the port's numbers, and the reference's own detections on its own
    logits the same pairs."""
    _, _, out, P, cfg, feats = world
    for b in range(2):
        n = _n(out.proposal_valid, b)
        props = out.proposals[b, :n]
        logits, deltas = ref.box_head(P, feats, (H, W), props, b)
        assert _spread_gap(out.class_logits[b, :n], logits) < SPREAD_TOL
        assert _spread_gap(out.box_deltas[b, :n], deltas) < SPREAD_TOL
        d = _n(out.valid, b)
        assert d == CFG.detections_per_img
        for lg, dl in ((out.class_logits[b, :n], out.box_deltas[b, :n]), (logits, deltas)):
            pair, boxes, scores, labels = ref.select_detections(props, lg, dl, (H, W), cfg)
            assert torch.equal(pair, out.det_pair[b, :d])
            assert torch.equal(labels, out.labels[b, :d])
            np.testing.assert_allclose(boxes, out.boxes[b, :d], atol=1e-4, rtol=0)
            np.testing.assert_allclose(scores, out.scores[b, :d], rtol=1e-5, atol=0)


def test_masks_match_plain(world):
    """Mask logits at the port's detections to 1e-5 of their spread; the
    pasted masks: a pixel differs only within 1e-5 of the threshold of the
    reference's paste of the port's probabilities."""
    _, _, out, P, _, feats = world
    for b in range(2):
        d = _n(out.valid, b)
        boxes, labels = out.boxes[b, :d], out.labels[b, :d]
        logits = ref.mask_logits(P, feats, (H, W), boxes, labels, b)
        assert _spread_gap(out.mask_logits[b, :d], logits) < SPREAD_TOL
        probs = ref.paste(torch.sigmoid(out.mask_logits[b, :d]), boxes, (H, W))
        differ = (probs > CFG.mask_threshold) != out.masks[b, :d]
        assert out.masks[b, :d].sum() > 1000
        assert bool(((probs - CFG.mask_threshold).abs()[differ] < PASTE_MARGIN).all())


def _candidates(rs, n, n_groups):
    xy = rs.rand(n, 2).astype(np.float32) * 100
    wh = rs.rand(n, 2).astype(np.float32) * 30 + 1
    boxes = torch.from_numpy(np.concatenate([xy, xy + wh], 1))
    scores = torch.from_numpy(rs.rand(n).astype(np.float32))
    groups = torch.from_numpy(rs.randint(0, n_groups, n))
    return boxes, scores, groups


@pytest.mark.parametrize("n_groups, max_out", [(1, 50), (5, 1000), (40, 7)])
def test_nms_plain_version_is_the_references_scan(n_groups, max_out):
    """`ops.nms` (its plain version) keeps the reference's candidates index
    for index, invalid candidates left out of both; unused slots invalid."""
    rs = np.random.RandomState(n_groups)
    boxes, scores, groups = _candidates(rs, 700, n_groups)
    valid = torch.from_numpy(rs.rand(700) > 0.1)
    keep, kv = nms_ops.nms(boxes[None], scores[None], groups[None], valid[None], 0.5, max_out)
    sel = valid.nonzero()[:, 0]
    want = sel[ref.nms(boxes[sel], scores[sel], groups[sel], 0.5, max_out)]
    n = int(kv[0].sum())
    assert n == len(want) and bool(kv[0, :n].all()) and not bool(kv[0, n:].any())
    assert torch.equal(keep[0, :n], want)


def test_nms_ties_keep_the_lower_index():
    boxes = torch.tensor([[[0.0, 0, 10, 10], [0, 0, 10, 10], [20, 20, 30, 30]]])
    scores = torch.tensor([[0.5, 0.5, 0.5]])
    keep, kv = nms_ops.nms(boxes, scores, torch.zeros(1, 3, dtype=torch.long),
                           torch.ones(1, 3, dtype=torch.bool), 0.5, 3)
    assert keep[0, :2].tolist() == [0, 2] and kv[0].tolist() == [True, True, False]


@pytest.mark.parametrize("size", [7, 14])
def test_roi_align_plain_version_is_the_references(world, size):
    """`ops.multiscale_roi_align` (its plain version) against the reference's
    bilinear taps: boxes inside, across the border and tiny, each at its
    level, to float32 rounding."""
    _, _, _, _, _, feats = world
    rs = np.random.RandomState(size)
    xy = rs.rand(300, 2).astype(np.float32) * [W + 40, H + 40] - 20
    wh = np.exp(rs.rand(300, 2).astype(np.float32) * 7) - 0.5
    boxes = torch.from_numpy(np.concatenate([xy, xy + wh], 1)).float()
    scales = [mra.level_scale(f.shape[-2], H) for f in feats[:4]]
    assert scales == [0.25, 0.125, 0.0625, 0.03125]
    levels = mra.level_of(boxes, 2, 5)
    assert set(levels.tolist()) == {0, 1, 2, 3}
    assert torch.equal(levels, ref.level_of(boxes))
    out = mra.multiscale_roi_align(feats[:4], scales, boxes[None].expand(2, -1, -1).contiguous(),
                                   levels[None].expand(2, -1), size, 2)
    top = max(float(f.abs().max()) for f in feats[:4])
    for b in range(2):
        want = ref.roi_align(feats, (H, W), boxes, b, size, 2)
        assert float((out[b * 300:(b + 1) * 300] - want).abs().max()) <= ROI_TOL * top


def test_detector_rows_and_full_frame_masks(world):
    """`Detector.get_detections` on a Mask R-CNN: the rows of the valid
    detections (labels as object ids), masks at the frame's size, one
    instance a class on request, no row over the best score (with one
    instance a class too); the run directory round trip
    (`save_run_dir` -> `load_detector`) gives the same rows."""
    model, images, out, _, _, _ = world
    K = np.asarray([[150.0, 0, W / 2], [0, 150.0, H / 2], [0, 0, 1]], np.float32)
    obs = ObservationBatch(rgb=images, K=torch.from_numpy(np.stack([K, K])))
    det = lm.Detector(model, image_size=(H, W))
    rows, extra = det.get_detections(obs, detection_th=0.0)
    assert rows.n_rows == 2 * CFG.detections_per_img
    assert extra["masks"].shape == (rows.n_rows, H, W)
    np.testing.assert_array_equal(rows.obj_ids.numpy()[:100], out.labels[0].numpy())
    np.testing.assert_array_equal(extra["masks"][:100], out.masks[0].numpy())
    assert isinstance(extra["outputs"], mr.MaskRCNNOutputs)
    one, extra1 = det.get_detections(obs, detection_th=0.0, one_instance_per_class=True)
    assert one.n_rows <= 2 * (CFG.n_classes - 1)
    for b in range(2):
        ids = one.obj_ids.numpy()[one.batch_im_ids.numpy() == b]
        assert len(set(ids.tolist())) == len(ids)
    for one_instance in (False, True):
        high, extra = det.get_detections(obs, detection_th=float(out.scores.max()),
                                         one_instance_per_class=one_instance)
        assert high.n_rows == 0 and extra["masks"].shape[0] == 0


def test_detector_nms_settings_of_a_mask_rcnn(world):
    """Mask R-CNN's NMS runs inside its graph at its config's threshold:
    `max_detections` keeps the first slots (those a smaller budget keeps),
    another `iou_threshold` raises, its own is accepted."""
    model, images, out, _, _, _ = world
    obs = ObservationBatch(rgb=images, K=torch.eye(3).expand(2, 3, 3))
    det = lm.Detector(model, image_size=(H, W))
    rows, extra = det.get_detections(obs, detection_th=0.0, max_detections=5,
                                     iou_threshold=CFG.box_nms_thresh)
    assert rows.n_rows == 2 * 5
    np.testing.assert_array_equal(rows.boxes.numpy()[:5], out.boxes[0, :5].numpy())
    np.testing.assert_array_equal(extra["masks"][5:], out.masks[1, :5].numpy())
    with pytest.raises(ValueError, match="box_nms_thresh"):
        det.get_detections(obs, detection_th=0.0, iou_threshold=0.6)


def test_run_directory_round_trip(world, tmp_path):
    model, images, out, _, _, _ = world
    run = lm.save_run_dir(tmp_path / "det", model.state_dict(),
                          {**mr.config_to_dict(CFG), "image_size": [H, W]})
    det = lm.load_detector(run, n_classes=CFG.n_classes - 1, device="cpu", seed=99)
    assert isinstance(det.model, mr.MaskRCNN) and det.model.cfg == CFG
    assert det.image_size == (H, W)
    K = torch.eye(3).expand(2, 3, 3)
    rows, extra = det.get_detections(ObservationBatch(rgb=images, K=K), detection_th=0.0)
    np.testing.assert_array_equal(rows.boxes.numpy()[:100], out.boxes[0].numpy())
    np.testing.assert_array_equal(extra["masks"][100:], out.masks[1].numpy())
