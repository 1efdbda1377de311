"""Training pieces without a network, port against JAX: the losses, the
pose noise, the hypothesis samplers of the coarse losses, the synthetic
batch, the optimizer with its clip and schedule, the seeds, the small
members of `inference/types.py`, the crop in bfloat16 and the run
directory of a bfloat16 run.

`torch.Generator` is not `jax.random`: every comparison hands the port the
draws JAX made (`jax.random` called with the keys JAX's own code splits).
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy.spatial.transform import Rotation

from happypose_tpu.inference import types as jax_types
from happypose_tpu.lib3d.multiview_geom import make_TCO_multiview as jax_multiview
from happypose_tpu.lib3d.rotations import quat_to_rotmat as jax_quat_to_rotmat
from happypose_tpu.lib3d.transforms import add_pose_noise as jax_add_pose_noise
from happypose_tpu.ops.crop_resize import crop_images_matmul as jax_crop
from happypose_tpu.training import losses as jax_losses
from happypose_tpu.training.forward_loss import sample_grid_hypotheses as jax_grid_hypotheses
from happypose_tpu.training.synth_data import make_synth_batch as jax_synth_batch
from happypose_tpu.training.trainer import make_lr_schedule as jax_schedule
from happypose_tpu.training.trainer import make_optimizer as jax_make_optimizer
from happypose_tpu.utils.random import make_seed as jax_make_seed
from happypose_tpu_torch.inference import types
from happypose_tpu_torch.lib3d.multiview_geom import make_TCO_multiview
from happypose_tpu_torch.lib3d.transforms import add_pose_noise, apply_pose_noise
from happypose_tpu_torch.ops.crop_resize import crop_images_matmul
from happypose_tpu_torch.training import losses
from happypose_tpu_torch.training.forward_loss import (
    MULTIVIEW, N_MULTIVIEW, multiview_hypotheses, sample_grid_hypotheses,
)
from happypose_tpu_torch.training.synth_data import make_synth_batch, sample_synth_scenes
from happypose_tpu_torch.training.trainer import make_lr_schedule, make_optimizer
from happypose_tpu_torch.utils.load_model import save_run_dir, spec_from_checkpoints
from happypose_tpu_torch.utils.random import generator_for, make_seed, temp_numpy_seed
from test_torch_models import mesh_dbs

torch.set_num_threads(2)
B = 4


def t(x):
    return torch.from_numpy(np.array(x))


def jax_noise_draws(key, n, dtype=jnp.float32):
    """The draws of JAX's `add_pose_noise(key, TCO)` with its default spreads."""
    k1, k2 = jax.random.split(key)
    euler = jax.random.normal(k1, (n, 3), dtype) * jnp.asarray((15.0,) * 3) * (jnp.pi / 180.0)
    trans = jax.random.normal(k2, (n, 3), dtype) * jnp.asarray((0.01, 0.01, 0.05))
    return {"euler": t(euler), "trans": t(trans)}


def random_poses(n, seed, z=0.5):
    rs = np.random.RandomState(seed)
    T = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    T[:, :3, :3] = Rotation.random(n, random_state=seed).as_matrix()
    T[:, :3, 3] = rs.uniform(-0.05, 0.05, (n, 3)) + [0, 0, z]
    return T


def loss_inputs(seed, at_gt, head="reference_point"):
    """(TCO_possible_gt, TCO_input, outputs, K_crop, points, tCR, points_mask,
    sym_mask) as numpy. `head`: the outputs of the reference-point loss, or
    of the object-centre loss with an "ortho6d" or "quaternion" head;
    `at_gt` makes them the ground-truth update of that loss. Slot 1 of the
    symmetries is a 180 degree turn, slot 2 padding."""
    rs = np.random.RandomState(seed)
    TCO_gt = random_poses(B, seed)
    sym = np.tile(np.eye(4, dtype=np.float32), (B, 3, 1, 1))
    sym[:, 1, :3, :3] = np.diag([-1.0, -1.0, 1.0])
    sym_mask = np.ones((B, 3), bool)
    sym_mask[:, -1] = False
    sym[:, -1, :3, 3] = 0.3  # garbage in the padded slot, masked out
    possible = np.einsum("bij,bsjk->bsik", TCO_gt, sym).astype(np.float32)
    TCO_input = np.asarray(jax_add_pose_noise(jax.random.PRNGKey(seed), jnp.asarray(TCO_gt)))
    K = np.tile(np.asarray([[300.0, 0, 160], [0, 310.0, 120], [0, 0, 1]], np.float32), (B, 1, 1))
    fxfy = np.stack([K[:, 0, 0], K[:, 1, 1]], -1)
    points = rs.uniform(-0.05, 0.05, (B, 64, 3)).astype(np.float32)
    points_mask = np.ones((B, 64), bool)
    points_mask[:, 50:] = False
    tCR = TCO_input[:, :3, 3] + rs.uniform(-0.01, 0.01, (B, 3)).astype(np.float32)
    dR = TCO_gt[:, :3, :3] @ np.swapaxes(TCO_input[:, :3, :3], -1, -2)
    if head == "quaternion":
        rot = Rotation.from_matrix(dR).as_quat() if at_gt else rs.normal(0, 1, (B, 4))  # xyzw
    else:
        rot = np.concatenate([dR[:, :, 0], dR[:, :, 1]], -1)
        if not at_gt:
            rot = rot + rs.normal(0, 0.2, (B, 6))
    if head == "reference_point":
        t_out = TCO_gt[:, :3, 3] - np.einsum("bij,bj->bi", dR, TCO_input[:, :3, 3] - tCR)
        vxvy = fxfy * (t_out[:, :2] / t_out[:, 2:3] - tCR[:, :2] / tCR[:, 2:3])
        vz = t_out[:, 2:3] / tCR[:, 2:3]
    else:
        z_in = TCO_input[:, 2, 3:4]
        vxvy = (TCO_gt[:, :2, 3] / TCO_gt[:, 2, 3:4] - TCO_input[:, :2, 3] / z_in) * fxfy
        vz = TCO_gt[:, 2, 3:4] / z_in
    if not at_gt:
        vxvy, vz = vxvy + rs.normal(0, 5, (B, 2)), vz + rs.normal(0, 0.05, (B, 1))
    outputs = np.concatenate([rot, vxvy, vz], -1).astype(np.float32)
    return possible, TCO_input, outputs, K, points, tCR, points_mask, sym_mask


def _close_to_jax(out, ref, rtol, atol):
    loss, parts = out
    ref_loss, ref_parts = ref
    np.testing.assert_allclose(loss.numpy(), np.asarray(ref_loss), rtol=rtol, atol=atol)
    for k in ("loss_orn", "loss_xy", "loss_z"):
        np.testing.assert_allclose(parts[k].numpy(), np.asarray(ref_parts[k]), rtol=rtol, atol=atol)


@pytest.mark.parametrize("at_gt", [False, True], ids=["random", "ground_truth"])
def test_reference_point_loss_matches_jax(at_gt):
    """The disentangled reference-point loss of each sample, and its three
    parts, to 1e-6 relative (float32 on both sides, the same operations).
    At the ground-truth update the loss is 0 up to float32 rounding of
    poses at 0.5 m (1e-6 m)."""
    possible, TCO_in, outputs, K, points, tCR, pm, sm = loss_inputs(0, at_gt)
    ref = jax_losses.loss_refiner_CO_disentangled_reference_point(
        *map(jnp.asarray, (possible, TCO_in, outputs, K, points, tCR)),
        points_mask=jnp.asarray(pm), sym_mask=jnp.asarray(sm))
    out = losses.loss_refiner_CO_disentangled_reference_point(
        *map(t, (possible, TCO_in, outputs, K, points, tCR)), points_mask=t(pm), sym_mask=t(sm))
    _close_to_jax(out, ref, rtol=1e-6, atol=1e-7)
    if at_gt:
        assert out[0].abs().max() < 1e-5
    else:
        assert out[0].min() > 1e-3


@pytest.mark.parametrize("rotation_param", ["ortho6d", "quaternion"])
@pytest.mark.parametrize("at_gt", [False, True], ids=["random", "ground_truth"])
def test_disentangled_loss_matches_jax(rotation_param, at_gt):
    """CosyPose's object-centre disentangled loss, both heads: 1e-6
    relative to JAX, and 0 (to float32 rounding) at the ground truth."""
    possible, TCO_in, outputs, K, points, _, pm, sm = loss_inputs(1, at_gt, head=rotation_param)
    ref = jax_losses.loss_refiner_CO_disentangled(
        *map(jnp.asarray, (possible, TCO_in, outputs, K, points)), points_mask=jnp.asarray(pm),
        sym_mask=jnp.asarray(sm), rotation_param=rotation_param)
    out = losses.loss_refiner_CO_disentangled(
        *map(t, (possible, TCO_in, outputs, K, points)), points_mask=t(pm), sym_mask=t(sm),
        rotation_param=rotation_param)
    _close_to_jax(out, ref, rtol=1e-6, atol=1e-7)
    if at_gt:
        assert out[0].abs().max() < 1e-5


@pytest.mark.parametrize("shape", ["views", "flat", "valid"])
def test_coarse_classification_loss_matches_jax(shape):
    """Sigmoid BCE of [B, n] or [B] logits, plain and with a validity mask
    of samples: 1e-6 relative."""
    rs = np.random.RandomState(3)
    logits = rs.normal(0, 3, (B, 8)).astype(np.float32)
    pos = (rs.rand(B, 8) < 0.3).astype(np.float32)
    valid = None
    if shape == "flat":
        logits, pos = logits[:, 0], pos[:, 0]
    if shape == "valid":
        valid = np.asarray([True, False, True, True])
    ref = jax_losses.coarse_classification_loss(
        jnp.asarray(logits), jnp.asarray(pos), None if valid is None else jnp.asarray(valid))
    out = losses.coarse_classification_loss(
        t(logits), t(pos), None if valid is None else t(valid))
    np.testing.assert_allclose(out.item(), float(ref), rtol=1e-6)


def test_apply_pose_noise_matches_jax():
    """JAX's draws handed to `apply_pose_noise`: JAX's noised poses to 1e-6."""
    TCO = random_poses(B, 4)
    key = jax.random.PRNGKey(7)
    ref = np.asarray(jax_add_pose_noise(key, jnp.asarray(TCO)))
    draws = jax_noise_draws(key, B)
    out = apply_pose_noise(t(TCO), draws["euler"], draws["trans"]).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)
    assert np.abs(out - TCO).max() > 1e-3


def test_add_pose_noise_draws_from_the_generator():
    """Same seed, same noise; the spread is the one asked for (15 degrees
    of euler noise, 1 / 1 / 5 cm), on the generator's device."""
    TCO = t(random_poses(256, 5))
    a = add_pose_noise(torch.Generator().manual_seed(0), TCO)
    b = add_pose_noise(torch.Generator().manual_seed(0), TCO)
    assert torch.equal(a, b) and a.device == TCO.device
    dt = (a - TCO)[:, :3, 3]
    np.testing.assert_allclose(dt.std(0).numpy(), [0.01, 0.01, 0.05], rtol=0.15)


def test_grid_hypotheses_match_jax():
    """`sample_grid_hypotheses` on JAX's draws (noise from the first key of
    its split, grid indices from the second), on a 16-rotation grid with
    an object that has a 180 degree symmetry in half the samples: poses to
    1e-6, angles to 1e-5 rad (arccos near 0 magnifies rounding), labels
    equal, and both labels occur."""
    TCO_gt = random_poses(B, 8)
    sym = np.tile(np.eye(4, dtype=np.float32), (B, 2, 1, 1))
    sym[:, 1, :3, :3] = np.diag([-1.0, -1.0, 1.0])
    sym_mask = np.asarray([[True, True], [True, False], [True, True], [True, False]])
    grid = Rotation.random(16, random_state=9).as_matrix().astype(np.float32)
    grid[:B] = TCO_gt[:, :3, :3]  # a negative can be right
    n = 6
    rng = jax.random.PRNGKey(11)
    ref = jax_grid_hypotheses(
        rng, jnp.asarray(TCO_gt), jnp.asarray(sym), jnp.asarray(sym_mask), jnp.asarray(grid), n)
    k_noise, k_grid = jax.random.split(rng)
    draws = jax_noise_draws(k_noise, B)
    draws["gidx"] = t(jax.random.randint(k_grid, (B, n - 1), 0, grid.shape[0])).long()
    out = sample_grid_hypotheses(t(TCO_gt), t(sym), t(sym_mask), t(grid), draws)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(out[2].numpy(), np.asarray(ref[2]), atol=1e-5, rtol=0)
    assert 0 < out[1].sum() < out[1].numel()
    # every negative shares slot 0's translation
    assert torch.equal(out[0][:, 1:, :3, 3], out[0][:, :1, :3, 3].expand(-1, n - 1, -1))


def test_multiview_hypotheses_match_jax():
    """The multiview coarse loss's hypothesis set on JAX's draws (`perm`,
    `include`, `slot` from the keys JAX splits): the same 104 views (1e-6),
    the same picks and the same positives, the forced positive included."""
    TCO_gt = random_poses(B, 12)
    n_hyp = 3
    rng = jax.random.PRNGKey(13)
    k_noise, k_perm, k_inc, k_slot = jax.random.split(rng, 4)
    TCO_noise = jax_add_pose_noise(k_noise, jnp.asarray(TCO_gt))
    TCV_ref = jax_multiview(TCO_noise, TCO_noise[:, :3, 3], multiview_type="sphere_26views",
                            remove_TCO_rendering=True, views_inplane_rotations=True)
    perm = jax.vmap(lambda k: jax.random.permutation(k, N_MULTIVIEW)[:n_hyp])(
        jax.random.split(k_perm, B))
    include = jax.random.uniform(k_inc, (B,)) < 0.7
    slot = jax.random.randint(k_slot, (B,), 0, n_hyp)
    # JAX's forward_loss.make_coarse_loss_fn, lines :296-308
    do_force = include & ~jnp.any(perm == 0, axis=1)
    perm_f = jnp.where(do_force[:, None] & (jnp.arange(n_hyp)[None] == slot[:, None]), 0, perm)
    hyp_ref = jnp.take_along_axis(TCV_ref, perm_f[:, :, None, None], axis=1)

    draws = jax_noise_draws(k_noise, B)
    noise = apply_pose_noise(t(TCO_gt), draws["euler"], draws["trans"])
    TCV = make_TCO_multiview(noise, noise[:, :3, 3], **MULTIVIEW)
    assert TCV.shape[1] == N_MULTIVIEW
    np.testing.assert_allclose(TCV.numpy(), np.asarray(TCV_ref), atol=1e-6, rtol=0)
    # make the forced positive happen on sample 0
    perm, include = np.asarray(perm).copy(), np.asarray(include).copy()
    perm[0] = [5, 6, 7]
    include[0] = True
    do_force = include & ~(perm == 0).any(1)
    perm_f = np.where(do_force[:, None] & (np.arange(n_hyp)[None] == np.asarray(slot)[:, None]),
                      0, perm)
    hyp_ref = np.take_along_axis(np.asarray(TCV_ref), perm_f[:, :, None, None], axis=1)
    hyp, is_pos = multiview_hypotheses(TCV, t(perm).long(), t(include), t(slot).long())
    np.testing.assert_allclose(hyp.numpy(), hyp_ref, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(is_pos.numpy(), (perm_f == 0).astype(np.float32))
    assert is_pos[0].sum() == 1


def test_background_resize_matches_jax():
    """The synthetic background's blur: `jax.image.resize(..., "linear")`
    down 8x (antialiased) and back up, against `F.interpolate` bilinear
    with `antialias=True` down and plain bilinear up, on a seeded noise
    image: 1e-6 (measured 1.8e-7: float32 kernel weights summed in another
    order)."""
    import torch.nn.functional as F

    rs = np.random.RandomState(14)
    bg = rs.rand(2, 120, 160, 3).astype(np.float32)
    small = jax.image.resize(jnp.asarray(bg), (2, 15, 20, 3), "linear")
    ref = np.asarray(jax.image.resize(small, (2, 120, 160, 3), "linear"))
    x = F.interpolate(t(bg).permute(0, 3, 1, 2), size=(15, 20), mode="bilinear", antialias=True,
                      align_corners=False)
    np.testing.assert_allclose(x.permute(0, 2, 3, 1).numpy(), np.asarray(small), atol=1e-6)
    x = F.interpolate(x, size=(120, 160), mode="bilinear", align_corners=False)
    np.testing.assert_allclose(x.permute(0, 2, 3, 1).numpy(), ref, atol=1e-6)


def test_synth_batch_matches_jax():
    """`make_synth_batch` on JAX's draws (object ids, rotations, xy, z,
    background, pixel noise from the six keys JAX splits), both rendering
    the icosphere and the box at 60x80 with their plain renderers: poses
    to 1e-6, the background (pixels neither side covers) to 1e-5, the
    object pixels where both cover to 1e-4 (the two-pass renderer's
    shading against the port's), masks on >= 99.5% of pixels (edge
    pixels are decided by float32 edge tests)."""
    jdb, tdb = mesh_dbs()
    H, W = 60, 80
    K1 = np.asarray([[150.0, 0, W / 2], [0, 150.0, H / 2], [0, 0, 1]], np.float32)
    rng = jax.random.PRNGKey(15)
    ref = jax_synth_batch(rng, jdb.render_assets(), jnp.asarray(K1), n_objects=2, batch_size=B,
                          resolution=(H, W), z_range=(0.3, 0.4), xy_extent=0.03)
    k_obj, k_rot, k_xy, k_z, k_bg, k_noise = jax.random.split(rng, 6)
    draws = {
        "obj_ids": t(jax.random.randint(k_obj, (B,), 0, 2)).long(),
        "R": t(jax_quat_to_rotmat(jax.random.normal(k_rot, (B, 4)))),
        "xy": t(jax.random.uniform(k_xy, (B, 2), minval=-0.03, maxval=0.03)),
        "z": t(jax.random.uniform(k_z, (B, 1), minval=0.3, maxval=0.4)),
        "bg": t(jax.random.uniform(k_bg, (B, H, W, 3))),
        "noise": t(jax.random.normal(k_noise, (B, H, W, 3))),
    }
    out = make_synth_batch(tdb.render_assets(device="cpu"), t(K1), draws)
    np.testing.assert_array_equal(out.obj_ids.numpy(), np.asarray(ref.obj_ids))
    np.testing.assert_allclose(out.TCO_gt.numpy(), np.asarray(ref.TCO_gt), atol=1e-6)
    assert out.images.shape == (B, 3, H, W)
    img, img_ref = out.images.numpy(), np.asarray(ref.images)
    plain = np.all(np.abs(img - img_ref) < 1e-5, axis=1)
    bg_ref = np.asarray(jax.image.resize(jax.image.resize(
        jnp.asarray(draws["bg"].numpy()), (B, H // 8, W // 8, 3), "linear"), (B, H, W, 3), "linear"))
    differs_from_bg = np.abs(np.clip(np.moveaxis(bg_ref, -1, 1) + 0.02 * np.moveaxis(
        draws["noise"].numpy(), -1, 1), 0, 1) - img_ref).max(1) > 1e-5  # covered in JAX
    covered = np.abs(np.clip(np.moveaxis(bg_ref, -1, 1) + 0.02 * np.moveaxis(
        draws["noise"].numpy(), -1, 1), 0, 1) - img).max(1) > 1e-5  # covered in the port
    assert 0.02 < covered.mean() < 0.6
    assert (covered == differs_from_bg).mean() >= 0.995
    assert plain[~covered & ~differs_from_bg].all()
    both = covered & differs_from_bg
    assert (np.abs(img - img_ref).max(1)[both] < 1e-4).mean() >= 0.99


def test_synth_scenes_draws():
    """The sampler's draws: shapes, ranges, the forced ids, and the same
    draws from the same seed."""
    g = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    d = sample_synth_scenes(g(), n_objects=3, batch_size=8, resolution=(24, 32))
    assert d["bg"].shape == d["noise"].shape == (8, 24, 32, 3)
    assert d["obj_ids"].min() >= 0 and d["obj_ids"].max() < 3
    assert d["xy"].abs().max() <= 0.08 and ((d["z"] >= 0.35) & (d["z"] <= 0.8)).all()
    R = d["R"]
    np.testing.assert_allclose((R @ R.transpose(1, 2)).numpy(), np.tile(np.eye(3), (8, 1, 1)),
                               atol=1e-5)
    again = sample_synth_scenes(g(), n_objects=3, batch_size=8, resolution=(24, 32))
    assert all(torch.equal(d[k], again[k]) for k in d)
    forced = sample_synth_scenes(g(), 3, 8, (24, 32), force_obj_ids=torch.full((8,), 2))
    assert (forced["obj_ids"] == 2).all()


@pytest.mark.parametrize("case", ["adam", "adamw", "clip", "schedule"])
def test_optimizer_matches_optax(case):
    """3 steps of `make_optimizer` on the same handed-in gradients and
    parameters as JAX's optax chain: Adam, AdamW (decoupled decay 0.05),
    a clipped step (global norm 12 against a clip of 1, the other steps
    under it), and the warmup (3 steps) with a step decay at update 2.
    Parameters to 1e-6 relative after each step."""
    rs = np.random.RandomState(16)
    shapes = [(4, 3), (5,), (2, 2, 3)]
    params = [rs.normal(0, 1, s).astype(np.float32) for s in shapes]
    grads = [[rs.normal(0, 0.3, s).astype(np.float32) for s in shapes] for _ in range(3)]
    kw = dict(lr=1e-2, n_warmup_steps=1, clip_grad_norm=None)
    if case == "adamw":
        kw["weight_decay"] = 0.05
    if case == "clip":
        kw["clip_grad_norm"] = 1.0
        grads[1] = [g * 12 / np.sqrt(sum((x ** 2).sum() for x in grads[1])) for g in grads[1]]
    if case == "schedule":
        kw.update(n_warmup_steps=3, decay_steps=(2,))
    tx = jax_make_optimizer(**kw)
    jp = {str(i): jnp.asarray(p) for i, p in enumerate(params)}
    opt_state = tx.init(jp)
    tp = [torch.nn.Parameter(t(p.copy())) for p in params]
    opt = make_optimizer(tp, **kw)
    from happypose_tpu_torch.training.trainer import global_norm

    for step, gs in enumerate(grads):
        updates, opt_state = tx.update({str(i): jnp.asarray(g) for i, g in enumerate(gs)},
                                       opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, g in zip(tp, gs):
            p.grad = t(g.copy())
        opt.apply(global_norm(p.grad for p in tp))
        for i, p in enumerate(tp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[str(i)]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"step {step} tensor {i}")
    assert opt.count == 3


def test_schedule_matches_jax():
    """Warmup and step decay at every count 0-11: equal to JAX's schedule
    to 3e-7 relative (JAX multiplies in float32: up to three roundings of
    6e-8 each; the port in float64)."""
    kw = dict(base_lr=3e-4, n_warmup_steps=4, total_steps=12, decay_steps=(6, 9))
    ref, out = jax_schedule(**kw), make_lr_schedule(**kw)
    for step in range(12):
        np.testing.assert_allclose(out(step), float(ref(step)), rtol=3e-7)
    assert out(0) == 3e-4 / 4 and out(5) == 3e-4 and math.isclose(out(11), 3e-6)


def test_seeds_match_jax():
    """`make_seed` is JAX's hash; `generator_for` seeds a generator from it
    on the device asked for; `temp_numpy_seed` restores numpy's state."""
    for args in [(0,), ("synth", 3, 7), ("a/b", 1.5)]:
        assert make_seed(*args) == jax_make_seed(*args)
    g = generator_for("step", 1, 2, device="cpu")
    assert g.initial_seed() == make_seed("step", 1, 2) and g.device == torch.device("cpu")
    before = np.random.get_state()[1].copy()
    with temp_numpy_seed(5):
        a = np.random.rand()
    assert a == np.random.RandomState(5).rand()
    assert np.array_equal(np.random.get_state()[1], before)


def _estimates(mod, n=5):
    rs = np.random.RandomState(17)
    f = lambda x: jnp.asarray(x) if mod is jax_types else t(x)  # noqa: E731
    return mod.PoseEstimateBatch(
        poses=f(random_poses(n, 17)), K=f(np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))),
        obj_ids=f(np.arange(n) % 2), batch_im_ids=f(np.zeros(n, np.int64)),
        instance_ids=f(np.arange(n)), hypothesis_ids=f(np.arange(n)),
        scores=f(rs.rand(n).astype(np.float32)), coarse_logits=f(rs.rand(n).astype(np.float32)),
        pose_logits=f(rs.rand(n).astype(np.float32)),
        valid=f(np.asarray([True, True, False, True, True])))


def test_pose_estimate_mask_where_and_replace_valid_match_jax():
    """`mask_where` ands the validity with `keep`; `replace_valid` swaps it;
    the other fields come through: as JAX's (`inference/types.py:181,185`)."""
    keep = np.asarray([True, False, True, True, False])
    ref, out = _estimates(jax_types), _estimates(types)
    for r, o in ((ref.mask_where(jnp.asarray(keep)), out.mask_where(t(keep))),
                 (jax_types.replace_valid(ref, jnp.asarray(keep)), types.replace_valid(out, t(keep)))):
        np.testing.assert_array_equal(o.valid.numpy(), np.asarray(r.valid))
        np.testing.assert_array_equal(o.poses.numpy(), np.asarray(r.poses))
        np.testing.assert_array_equal(o.scores.numpy(), np.asarray(r.scores))
    assert out.mask_where(t(keep)).valid.tolist() == [True, False, False, True, False]


def test_observation_batch_size_matches_jax():
    rgb = np.zeros((3, 24, 32, 3), np.uint8)
    K = np.tile(np.eye(3, dtype=np.float32), (3, 1, 1))
    assert types.ObservationBatch.from_numpy(rgb, K, device="cpu").batch_size == \
        jax_types.ObservationBatch.from_numpy(rgb, K).batch_size == 3


def test_crop_in_bfloat16_close_to_jax():
    """`crop_images_matmul(matmul_dtype=bfloat16)` against JAX's: both
    round the images and the interpolation weights to bfloat16 (8 bits)
    and accumulate in float32; the port rounds the product of the first
    matrix product to bfloat16 as JAX does, and its output once more. So
    1.6e-2 absolute on [0, 1] images (two bfloat16 roundings of ~2^-8
    each), and both within 2e-2 of the float32 crop."""
    rs = np.random.RandomState(18)
    images = rs.rand(2, 4, 60, 80).astype(np.float32)
    images[:, 3] *= rs.rand(2, 60, 80) > 0.1  # depth with holes
    boxes = np.asarray([[5.5, 3.2, 50.1, 40.7], [-3.0, 10.0, 70.0, 58.0]], np.float32)
    ref = np.asarray(jax_crop(jnp.asarray(images), jnp.asarray(boxes), (24, 32), 4,
                              matmul_dtype=jnp.bfloat16))
    out = crop_images_matmul(t(images), t(boxes), (24, 32), 4, matmul_dtype=torch.bfloat16)
    fp32 = crop_images_matmul(t(images), t(boxes), (24, 32), 4)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1.6e-2, rtol=0)
    np.testing.assert_allclose(out.numpy(), fp32.numpy(), atol=2e-2, rtol=0)
    assert not torch.equal(out, fp32)
    # the depth validity test stays in float32: the same holes
    np.testing.assert_array_equal(out[:, 3].numpy() == 0, fp32[:, 3].numpy() == 0)


def test_bf16_run_directory_loads_with_bfloat16(tmp_path):
    """A run directory whose `config.json` says `bf16` (as JAX's training
    writes it) builds `compute_dtype="bfloat16"`; without it, float32."""
    from happypose_tpu_torch.models.pose_predictor import PosePredictor, PosePredictorConfig

    sd = PosePredictor(PosePredictorConfig(backbone="wide_resnet18")).state_dict()
    save_run_dir(tmp_path / "refiner", sd, {"backbone": "wide_resnet18", "render_size": [24, 32],
                                            "bf16": True})
    save_run_dir(tmp_path / "coarse", {}, {"backbone": "resnet34", "render_size": [24, 32]})
    spec = spec_from_checkpoints({"refiner": tmp_path / "refiner", "coarse": tmp_path / "coarse"})
    assert spec.refiner_cfg.compute_dtype == "bfloat16"
    assert spec.coarse_cfg.compute_dtype == "float32"
    assert json.loads((tmp_path / "refiner" / "config.json").read_text())["bf16"] is True
