"""The FCOS + YOLACT-mask detector: the PyTorch port against Flax.

The JAX test's detector config (`tests/test_detector.py`: 2 classes, 8
prototypes, 32 FPN channels, head depth 1) at 120x160, so that the FPN's
c5 -> c4 -> c3 steps include a resize that is not 2x (8x10 -> 15x20). The
Flax variables are perturbed with a seed and carried over by
`weights_from_jax.detector_state_dict`; both sides see the same numpy
inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from happypose_tpu.datasets.augmentations import crop_resize_to_aspect as jax_crop_resize_to_aspect
from happypose_tpu.inference.detector import Detector as JaxDetector
from happypose_tpu.inference.types import ObservationBatch as JaxObservation
from happypose_tpu.models import detector as jd
from happypose_tpu_torch.datasets.augmentations import crop_resize_to_aspect
from happypose_tpu_torch.inference.detector import Detector
from happypose_tpu_torch.inference.types import ObservationBatch
from happypose_tpu_torch.models import detector as td
from happypose_tpu_torch.utils import profiling
from happypose_tpu_torch.utils.load_model import load_detector
from happypose_tpu_torch.utils.weights_from_jax import detector_state_dict
from test_torch_models import perturb

torch.set_num_threads(2)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

H, W = 120, 160
CFG = dict(n_classes=2, n_prototypes=8, fpn_channels=32, head_depth=1)
RAW_RTOL = 1e-4  # float32 convolutions over 50+ layers, summed in another order
MASK_TOL = 1e-4  # mask pixels may differ only this close to the threshold


@pytest.fixture(scope="module")
def detectors():
    """(Flax model, its perturbed variables, the port's model, images [2, 3, H, W])."""
    jax_model = jd.FCOSDetector(jd.DetectorConfig(**CFG))
    images = np.random.RandomState(0).rand(2, 3, H, W).astype(np.float32)
    variables = jax.jit(lambda k, x: jax_model.init(k, x, train=False))(
        jax.random.PRNGKey(0), jnp.asarray(images[:1])
    )
    variables = perturb(variables, seed=5)
    model = td.FCOSDetector(td.DetectorConfig(**CFG)).eval()
    model.load_state_dict(detector_state_dict(variables))
    return jax_model, variables, model, images


@pytest.fixture(scope="module")
def raw(detectors):
    jax_model, variables, model, images = detectors
    ref = jax.jit(lambda v, x: jax_model.apply(v, x, train=False))(variables, jnp.asarray(images))
    with torch.no_grad():
        out = model(torch.from_numpy(images))
    return jax.tree.map(np.asarray, ref), out


@pytest.mark.parametrize("field", td.DetectorOutputs._fields)
def test_raw_outputs_match_flax(raw, field):
    """Every output to 1e-4 relative (of the array's largest magnitude for
    values near 0); locations and level ids exactly."""
    ref, out = raw
    r, t = getattr(ref, field), getattr(out, field).numpy()
    assert t.shape == r.shape
    if field in ("locations", "level_ids"):
        np.testing.assert_array_equal(t, r)
    else:
        assert np.isfinite(t).all() and np.abs(r).max() > 0
        np.testing.assert_allclose(t, r, rtol=RAW_RTOL, atol=RAW_RTOL * np.abs(r).max())


def test_levels_cover_the_non_2x_resize(raw):
    """At 120x160 the pyramid is 15x20, 8x10, 4x5, 2x3, 1x2: P3 gets P4
    resized 8x10 -> 15x20."""
    _, out = raw
    counts = np.bincount(out.level_ids.numpy())
    assert counts.tolist() == [15 * 20, 8 * 10, 4 * 5, 2 * 3, 1 * 2]


def test_decode_boxes_exact(raw):
    ref, _ = raw
    loc, reg = ref.locations, ref.box_reg[0]
    expected = np.asarray(jd.decode_boxes(jnp.asarray(loc), jnp.asarray(reg)))
    got = td.decode_boxes(torch.tensor(loc), torch.tensor(reg)).numpy()
    np.testing.assert_array_equal(got, expected)


def _nms_case_tied(seed=3, n=64):
    """Overlapping boxes in a small area, 2 labels, scores from 4 values so
    that many tie."""
    rs = np.random.RandomState(seed)
    xy = rs.uniform(0, 40, (n, 2))
    wh = rs.uniform(8, 20, (n, 2))
    boxes = np.concatenate([xy, xy + wh], axis=1).astype(np.float32)
    scores = (rs.randint(0, 4, n) / 4 + 0.1).astype(np.float32)
    labels = rs.randint(0, 2, n)
    return boxes, scores, labels


@pytest.mark.parametrize("case", ["test_detector", "tied", "best_not_first"])
def test_nms_fixed_matches_jax(case):
    """The same kept indices in the same slots, unused slots 0 and invalid;
    `max_out` cuts the tied case. In the last case the best score is not
    at index 0 and two slots stay unused: they hold 0, not the best's
    index (`ops.nms`'s)."""
    if case == "test_detector":  # tests/test_detector.py::test_nms_fixed
        boxes = np.asarray([[0, 0, 10, 10], [1, 1, 11, 11], [50, 50, 60, 60], [0, 0, 10, 10]],
                           np.float32)
        scores = np.asarray([0.9, 0.8, 0.7, 0.6], np.float32)
        labels = np.asarray([0, 0, 0, 1])
        max_out = 4
    elif case == "best_not_first":
        boxes = np.asarray([[0, 0, 10, 10], [1, 1, 11, 11], [50, 50, 60, 60]], np.float32)
        scores = np.asarray([0.5, 0.9, 0.7], np.float32)
        labels = np.asarray([0, 0, 0])
        max_out = 4
    else:
        boxes, scores, labels = _nms_case_tied()
        max_out = 8
    jk, jv = jd.nms_fixed(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(labels),
                          iou_threshold=0.5, max_out=max_out)
    tk, tv = td.nms_fixed(torch.from_numpy(boxes), torch.from_numpy(scores),
                          torch.from_numpy(labels), iou_threshold=0.5, max_out=max_out)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    if case == "test_detector":
        assert set(tk.numpy()[tv.numpy()].tolist()) == {0, 2, 3}
    elif case == "best_not_first":
        assert tk.tolist() == [1, 2, 0, 0] and tv.tolist() == [True, True, False, False]
    else:
        assert tv.all() and len(np.unique(scores[tk.numpy()])) < max_out  # cut, with ties


def _mask_probs(out, boxes_j):
    """float64 mask probabilities of the port's selected detections, found
    by their boxes among the decoded candidates (for the threshold check)."""
    protos = out.prototypes.numpy().astype(np.float64)
    coeffs = out.mask_coeffs.numpy().astype(np.float64)
    reg = out.box_reg.numpy()
    loc = out.locations.numpy()
    cand = np.concatenate([loc - reg[..., :2], loc + reg[..., 2:]], axis=-1)  # [B, L, 4]
    probs = []
    for b in range(boxes_j.shape[0]):
        idx = [np.abs(cand[b] - box).sum(-1).argmin() for box in boxes_j[b]]
        logits = np.einsum("hwp,np->nhw", protos[b], coeffs[b][idx])
        probs.append(1 / (1 + np.exp(-logits)))
    return np.stack(probs)


def _assert_masks_match(t_masks, j_masks, probs):
    differ = t_masks != j_masks
    assert (np.abs(probs[differ] - 0.5) < MASK_TOL).all(), int(differ.sum())
    assert differ.mean() < 1e-3


def test_detector_postprocess_matches_jax(raw):
    """Fixed-size detections: the same valid set, labels, boxes to 1e-3 px,
    scores to 1e-4 relative, masks equal except pixels within 1e-4 of the
    threshold. The score threshold sits in a gap of the kept scores."""
    ref, out = raw
    j0 = jax.tree.map(np.asarray, jd.detector_postprocess(ref, score_threshold=0.0))
    top = np.sort(j0["scores"][0][j0["valid"][0]])[::-1]
    assert top[4] - top[5] > 1e-3 * top[4]
    th = float((top[4] + top[5]) / 2)
    j = jax.tree.map(np.asarray, jd.detector_postprocess(ref, score_threshold=th))
    t = {k: v.numpy() for k, v in td.detector_postprocess(out, score_threshold=th).items()}
    assert t["masks"].shape == j["masks"].shape == (2, 32, 2 * 15, 2 * 20)
    np.testing.assert_array_equal(t["valid"], j["valid"])
    assert t["valid"][0].sum() == 5
    np.testing.assert_array_equal(t["labels"], j["labels"])
    np.testing.assert_allclose(t["boxes"], j["boxes"], atol=1e-3, rtol=0)
    np.testing.assert_allclose(t["scores"], j["scores"], rtol=1e-4, atol=0)
    _assert_masks_match(t["masks"], j["masks"], _mask_probs(out, j["boxes"]))


@pytest.mark.parametrize("one_instance_per_class", [False, True])
def test_get_detections_matches_jax(detectors, raw, one_instance_per_class):
    """`Detector.get_detections` through `load_detector`: the same rows
    (object ids, image ids, instance ids), boxes to 1e-3 px, masks as in
    the post-processing test."""
    jax_model, variables, _, images = detectors
    _, out = raw
    K = np.tile(np.asarray([[150.0, 0, W / 2], [0, 150.0, H / 2], [0, 0, 1]], np.float32), (2, 1, 1))
    jdet, jextra = JaxDetector(jax_model, variables).get_detections(
        JaxObservation(rgb=jnp.asarray(images), K=jnp.asarray(K)),
        detection_th=0.0, one_instance_per_class=one_instance_per_class,
    )
    detector = load_detector(td.DetectorConfig(**CFG),
                             state_dict=detector_state_dict(variables), image_size=(H, W),
                             device="cpu")
    det, extra = detector.get_detections(
        ObservationBatch(rgb=torch.from_numpy(images), K=torch.from_numpy(K)),
        detection_th=0.0, one_instance_per_class=one_instance_per_class,
    )
    n = 2 * (2 if one_instance_per_class else 32)
    assert det.n_rows == jdet.n_rows == n
    for f in ("obj_ids", "batch_im_ids", "instance_ids"):
        np.testing.assert_array_equal(getattr(det, f).numpy(), np.asarray(getattr(jdet, f)))
    np.testing.assert_allclose(det.boxes.numpy(), np.asarray(jdet.boxes), atol=1e-3, rtol=0)
    np.testing.assert_allclose(det.scores.numpy(), np.asarray(jdet.scores), rtol=1e-4, atol=0)
    assert det.valid.all()
    im = det.batch_im_ids.numpy()
    boxes = np.asarray(jdet.boxes)
    probs = np.concatenate([_mask_probs(out, boxes[im == b][None])[0] for b in range(2)])
    _assert_masks_match(extra["masks"], jextra["masks"], probs)


@pytest.mark.parametrize("one_instance_per_class", [False, True])
def test_get_detections_with_no_row_left(detectors, one_instance_per_class):
    """A frame whose detections all score under the threshold gives no row
    and no mask, as JAX's does, with or without one instance a class."""
    jax_model, variables, model, images = detectors
    K = np.tile(np.eye(3, dtype=np.float32), (2, 1, 1))
    jdet, jextra = JaxDetector(jax_model, variables).get_detections(
        JaxObservation(rgb=jnp.asarray(images), K=jnp.asarray(K)),
        detection_th=1.0, one_instance_per_class=one_instance_per_class,
    )
    det, extra = Detector(model, image_size=(H, W)).get_detections(
        ObservationBatch(rgb=torch.from_numpy(images), K=torch.from_numpy(K)),
        detection_th=1.0, one_instance_per_class=one_instance_per_class,
    )
    assert det.n_rows == jdet.n_rows == 0
    assert extra["masks"].shape[0] == np.asarray(jextra["masks"]).shape[0] == 0


def test_a_frame_is_one_detector_graph_call(detectors):
    """An FCOS frame is one call of the detector's graph, its NMS and
    post-processing inside (on the CPU its plain call): the second frame
    adds one replay and no capture. Its rows are those of the eager
    `detector_postprocess(model(x))`, bit for bit, in (image, slot) order."""
    _, _, model, images = detectors
    x = torch.from_numpy(images)
    with torch.inference_mode():
        ref = td.detector_postprocess(model(x), score_threshold=0.0)
    th = float(ref["scores"][ref["valid"]].median())
    valid = (ref["valid"] & (ref["scores"] > th)).numpy()
    im, slot = np.nonzero(valid)
    assert 0 < len(im) < valid.size
    detector = Detector(model, image_size=(H, W))
    obs = ObservationBatch(rgb=x, K=torch.eye(3).expand(2, 3, 3))
    detector.get_detections(obs, detection_th=th)
    before = profiling.counters()
    det, extra = detector.get_detections(obs, detection_th=th)
    after = profiling.counters()
    grown = {k: after.get(f"graphs.detector.{k}", 0) - before.get(f"graphs.detector.{k}", 0)
             for k in ("replays", "captures")}
    assert grown == {"replays": 1, "captures": 0}
    np.testing.assert_array_equal(det.batch_im_ids.numpy(), im)
    np.testing.assert_array_equal(det.boxes.numpy(), ref["boxes"].numpy()[im, slot])
    np.testing.assert_array_equal(det.scores.numpy(), ref["scores"].numpy()[im, slot])
    np.testing.assert_array_equal(det.obj_ids.numpy(), ref["labels"].numpy()[im, slot])
    np.testing.assert_array_equal(extra["masks"], ref["masks"].numpy()[im, slot])


@pytest.mark.parametrize("frame,target", [((480, 640), (240, 320)), ((480, 640), (120, 120)),
                                          ((400, 240), (120, 160))])
def test_crop_resize_to_aspect_matches_jax(frame, target):
    """The detector's input (same aspect), a crop in x and a crop in y, to
    1e-5. The scales are exact in float32: with others, XLA's fused
    multiply-add moves a sample position by an ulp (1.5e-5 at 150 px) and
    the pixel by as much."""
    rs = np.random.RandomState(1)
    images = rs.rand(2, 3, *frame).astype(np.float32)
    K = np.tile(np.asarray([[500.0, 0, frame[1] / 2], [0, 500.0, frame[0] / 2], [0, 0, 1]],
                           np.float32), (2, 1, 1))
    j_img, j_K = jax_crop_resize_to_aspect(jnp.asarray(images), jnp.asarray(K), target)
    t_img, t_K = crop_resize_to_aspect(torch.from_numpy(images), torch.from_numpy(K), target)
    assert t_img.shape == (2, 3, *target)
    np.testing.assert_allclose(t_img.numpy(), np.asarray(j_img), atol=1e-5, rtol=0)
    np.testing.assert_allclose(t_K.numpy(), np.asarray(j_K), atol=1e-5, rtol=1e-6)
