"""Detector training: the loss and a train step of a cut detector, the
port against the JAX package.

- `detector_loss` on the same outputs and targets: every part to 1e-5, and
  its gradients with respect to the outputs to 1e-5 of their largest entry.
- One train step of a cut detector (the JAX detector test's config at
  120x160, B = 2, Flax variables perturbed and carried over by
  `weights_from_jax.detector_state_dict`): the loss to 5e-5 (relative), the
  classification head's gradient to 5e-4 of its largest entry (no ReLU lies
  between the head and the loss, so no ReLU decides differently), and the
  BatchNorm running statistics after the train-mode forward (Flax's
  momentum 0.9 on the biased variance) to 1e-4 of each buffer's largest
  entry. The limits are float32 noise of 50+ layers whose BatchNorm
  divides by the spread of 2 x 4 x 5 values at C5: against a float64 run
  of the port, the port's float32 outputs were off by 3.5e-5 to 4.7e-4 of
  their largest entry and JAX's by 1.7e-4 to 1.5e-3 (on the CPU); the
  two losses parted by 8.9e-6, the head gradients by 1.4e-4 of the max,
  the statistics by 4.0e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import happypose_tpu.training.detector_loss as jdl
import happypose_tpu_torch.training.detector_loss as tdl
from happypose_tpu.models import detector as jd
from happypose_tpu_torch.models import detector as td
from happypose_tpu_torch.utils.weights_from_jax import detector_state_dict
from test_torch_models import perturb

torch.set_num_threads(2)
torch.backends.cudnn.allow_tf32 = False

H, W = 64, 96  # the loss on given outputs
CUT_H, CUT_W = 120, 160  # the cut detector's step
CFG = dict(n_classes=2, n_prototypes=8, fpn_channels=32, head_depth=1)
STRIDES = (8, 16, 32, 64, 128)


def _locations():
    locs, lvls = [], []
    for lvl, s in enumerate(STRIDES):
        h, w = -(-H // s), -(-W // s)
        uu, vv = np.meshgrid((np.arange(w) + 0.5) * s, (np.arange(h) + 0.5) * s)
        locs.append(np.stack([uu.ravel(), vv.ravel()], -1))
        lvls.append(np.full(h * w, lvl))
    return np.concatenate(locs).astype(np.float32), np.concatenate(lvls)


def _targets(B=2, G=4, seed=0, Hm=H // 4, Wm=W // 4):
    rs = np.random.RandomState(seed)
    xy = rs.uniform(0, 60, (B, G, 2))
    wh = rs.uniform(6, 40, (B, G, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    boxes[0, 1] = boxes[0, 0]  # two equal boxes: the first wins the assignment
    valid = np.ones((B, G), bool)
    valid[1, -1] = False
    masks = rs.rand(B, G, Hm, Wm) > 0.5
    return jdl.DetectionTargets(boxes=boxes, labels=rs.randint(0, 2, (B, G)).astype(np.int32),
                                masks=masks, valid=valid)


def _outputs(B=2, seed=1):
    rs = np.random.RandomState(seed)
    locs, lvls = _locations()
    L = len(locs)
    return dict(
        cls_logits=rs.randn(B, L, 2).astype(np.float32),
        box_reg=np.exp(rs.randn(B, L, 4)).astype(np.float32) * 8,
        centerness=rs.randn(B, L).astype(np.float32),
        mask_coeffs=np.tanh(rs.randn(B, L, 8)).astype(np.float32),
        prototypes=np.abs(rs.randn(B, H // 4, W // 4, 8)).astype(np.float32),
        locations=locs, level_ids=lvls,
    )


def test_assign_targets_matches_jax_exactly():
    locs, lvls = _locations()
    t = _targets()
    out_idx, out_pos = tdl.assign_targets(torch.from_numpy(locs), torch.from_numpy(lvls),
                                          torch.from_numpy(t.boxes), torch.from_numpy(t.valid))
    for b in range(2):
        idx, pos = jdl._assign_targets(jnp.asarray(locs), jnp.asarray(lvls),
                                       jnp.asarray(t.boxes[b]), jnp.asarray(t.valid[b]))
        np.testing.assert_array_equal(out_idx[b].numpy(), np.asarray(idx))
        np.testing.assert_array_equal(out_pos[b].numpy(), np.asarray(pos))
    assert out_pos.sum() > 0 and not (out_idx[0] == 1).any()  # the tie went to box 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_detector_loss_and_its_gradients_match_jax(seed):
    o, t = _outputs(seed=seed + 1), _targets(seed=seed)
    diff = ("cls_logits", "box_reg", "centerness", "mask_coeffs", "prototypes")

    def jax_loss(x):
        out = jd.DetectorOutputs(**{**o, **x})
        return jdl.detector_loss(out, jdl.DetectionTargets(*map(jnp.asarray, t)), 2)

    (j_loss, j_parts), j_grads = jax.value_and_grad(jax_loss, has_aux=True)(
        {k: jnp.asarray(o[k]) for k in diff})
    x = {k: torch.tensor(o[k], requires_grad=k in diff) for k in o}
    out = td.DetectorOutputs(**{**x, "level_ids": x["level_ids"].long()})
    loss, parts = tdl.detector_loss(out, tdl.DetectionTargets(
        *(torch.from_numpy(np.asarray(a)) for a in t)), 2)
    loss.backward()
    assert sorted(parts) == sorted(j_parts)
    for k in parts:
        np.testing.assert_allclose(parts[k].item(), float(j_parts[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    for k in diff:
        g, r = x[k].grad.numpy(), np.asarray(j_grads[k])
        assert np.abs(r).max() > 0, k
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-5 * np.abs(r).max(), err_msg=k)


def test_focal_and_giou_match_jax():
    rs = np.random.RandomState(3)
    logits, tgt = rs.randn(50, 3).astype(np.float32), (rs.rand(50, 3) > 0.7).astype(np.float32)
    np.testing.assert_allclose(
        tdl.focal_loss(torch.from_numpy(logits), torch.from_numpy(tgt)).numpy(),
        np.asarray(jdl._focal_loss(jnp.asarray(logits), jnp.asarray(tgt))), rtol=1e-6, atol=1e-7)
    xy = rs.uniform(0, 50, (2, 40, 2))
    b = np.concatenate([xy, xy + rs.uniform(-5, 30, (2, 40, 2))], -1).astype(np.float32)
    np.testing.assert_allclose(tdl.giou(torch.from_numpy(b[0]), torch.from_numpy(b[1])).numpy(),
                               np.asarray(jdl._giou(jnp.asarray(b[0]), jnp.asarray(b[1]))),
                               rtol=1e-6, atol=1e-6)


# ------------------------------------------------------ a cut detector step

@pytest.fixture(scope="module")
def cut_step():
    """JAX's and the port's loss, head gradient and running statistics after
    one train-mode forward + backward on the same batch and weights."""
    jax_model = jd.FCOSDetector(jd.DetectorConfig(**CFG))
    images = np.random.RandomState(0).rand(2, 3, CUT_H, CUT_W).astype(np.float32)
    variables = jax.jit(lambda k, x: jax_model.init(k, x, train=False))(
        jax.random.PRNGKey(0), jnp.asarray(images[:1]))
    variables = perturb(variables, seed=7)
    t = _targets(Hm=CUT_H // 4, Wm=CUT_W // 4, seed=4)
    jt = jdl.DetectionTargets(*map(jnp.asarray, t))

    @jax.jit
    def jax_step(params, stats, x):
        def lf(p):
            out, new = jax_model.apply({"params": p, "batch_stats": stats}, x, train=True,
                                       mutable=["batch_stats"])
            loss, parts = jdl.detector_loss(out, jt, 2)
            return loss, new["batch_stats"]

        return jax.value_and_grad(lf, has_aux=True)(params)

    (j_loss, j_stats), j_grads = jax_step(variables["params"], variables["batch_stats"],
                                          jnp.asarray(images))
    model = td.FCOSDetector(td.DetectorConfig(**CFG))
    model.load_state_dict(detector_state_dict(variables))
    model.train()
    loss, _ = tdl.detector_loss(model(torch.from_numpy(images)), tdl.DetectionTargets(
        *(torch.from_numpy(np.asarray(a)) for a in t)), 2)
    loss.backward()
    ported_stats = detector_state_dict({"params": variables["params"], "batch_stats": j_stats})
    return dict(j_loss=float(j_loss), loss=loss.item(),
                j_head=np.asarray(j_grads["cls_head"]["kernel"]),
                head=model.cls_head.weight.grad.numpy(), j_stats=ported_stats,
                stats={k: v.detach().numpy() for k, v in model.state_dict().items()
                       if "running" in k})


def test_cut_detector_step_loss_matches_jax(cut_step):
    np.testing.assert_allclose(cut_step["loss"], cut_step["j_loss"], rtol=5e-5)


def test_cut_detector_step_head_gradient_matches_jax(cut_step):
    r = cut_step["j_head"].transpose(3, 2, 0, 1)  # HWIO -> OIHW
    g = cut_step["head"]
    assert np.abs(r).max() > 0
    np.testing.assert_allclose(g, r, rtol=0, atol=5e-4 * np.abs(r).max())


def test_cut_detector_step_batchnorm_statistics_move_as_flax(cut_step):
    stats, ref = cut_step["stats"], cut_step["j_stats"]
    assert len(stats) == 2 * 53  # 53 BatchNorm layers in ResNet50
    for k, v in stats.items():
        r = ref[k].numpy()
        np.testing.assert_allclose(v, r, rtol=0, atol=1e-4 * np.abs(r).max(), err_msg=k)
