"""Crop-resize (matrix and gather form) and the segment ops: the port
against JAX."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from happypose_tpu.ops.crop_resize import crop_images_matmul as jax_crop
from happypose_tpu.ops.roi_align import crop_images as jax_crop_images
from happypose_tpu.ops.roi_align import roi_align as jax_roi_align
from happypose_tpu.ops.segment_ops import argmin_per_group as jax_argmin_per_group
from happypose_tpu.ops.segment_ops import expand_for_symmetry as jax_expand_for_symmetry
from happypose_tpu.ops.segment_ops import group_keys as jax_group_keys
from happypose_tpu.ops.segment_ops import topk_per_group as jax_topk
from happypose_tpu_torch.ops.crop_resize import crop_images_matmul
from happypose_tpu_torch.ops.crop_resize import roi_align_matmul
from happypose_tpu_torch.ops.roi_align import crop_images, roi_align
from happypose_tpu_torch.ops.segment_ops import (
    argmin_per_group,
    expand_for_symmetry,
    group_keys,
    topk_per_group,
)

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("channels", [3, 4])
def test_crop_images_matmul_matches_jax(channels):
    """Boxes inside, across and outside the image border; with a depth
    channel holding holes (0). Tolerance 1e-5: the two products sum up to
    H or W terms of weights <= 1 in another order."""
    rs = np.random.RandomState(0)
    B, H, W = 5, 60, 80
    images = rs.rand(B, channels, H, W).astype(np.float32)
    if channels == 4:
        images[:, 3] *= rs.rand(B, H, W) > 0.1  # depth holes
    xy = rs.rand(B, 2).astype(np.float32) * [W, H] - 10
    wh = rs.rand(B, 2).astype(np.float32) * [60, 45] + 5
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    ref = np.asarray(jax_crop(jnp.asarray(images), jnp.asarray(boxes), (24, 32), 4))
    out = crop_images_matmul(torch.from_numpy(images), torch.from_numpy(boxes), (24, 32), 4)
    assert out.shape == ref.shape == (B, channels, 24, 32)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("k", [1, 2, 5])
def test_topk_per_group_with_ties(k):
    """Groups of (image, object, instance) with tied scores and invalid
    rows: the kept rows must be exactly JAX's, whose lexsort is stable (a
    tie keeps the lower row)."""
    rs = np.random.RandomState(k)
    N = 64
    im = rs.randint(0, 2, N)
    obj = rs.randint(0, 3, N)
    inst = rs.randint(0, 2, N)
    score = rs.randint(0, 4, N).astype(np.float32)  # many ties
    score[rs.rand(N) < 0.1] = -np.inf
    valid = rs.rand(N) > 0.15
    jkey = jax_group_keys(*(jnp.asarray(x) for x in (im, obj, inst)))
    tkey = group_keys(*(torch.from_numpy(x) for x in (im, obj, inst)))
    np.testing.assert_array_equal(np.asarray(jkey), tkey.numpy())
    ref = np.asarray(jax_topk(jkey, jnp.asarray(score), jnp.asarray(valid), k))
    out = topk_per_group(tkey, torch.from_numpy(score), torch.from_numpy(valid), k).numpy()
    np.testing.assert_array_equal(out, ref)
    # ties were really broken by row order
    for g in np.unique(np.asarray(jkey)[valid]):
        rows = np.flatnonzero((np.asarray(jkey) == g) & valid)
        assert out[rows].sum() == min(k, len(rows))


def _crop_inputs(channels, seed=2):
    rs = np.random.RandomState(seed)
    images = rs.rand(3, channels, 24, 32).astype(np.float32)
    if channels == 4:
        images[:, 3] *= rs.rand(3, 24, 32) > 0.1  # depth holes
    boxes = np.array(
        [[4.5, 3.2, 20.0, 18.7], [-2.0, 5.0, 35.0, 30.0], [0.0, 0.0, 32.0, 24.0]], np.float32
    )
    return images, boxes


@pytest.mark.parametrize("fn", ["roi_align", "crop_images"])
def test_roi_align_gather_form_matches_jax(fn):
    """The gather form, boxes inside and across the border, 4 channels with
    depth holes. Tolerance 1e-5: 16 bilinear samples of 4 taps a pixel.
    `crop_images` zeroes a depth pixel whose validity crop is under 0.99;
    both libraries compute that crop from the same 0/1 image, and no pixel
    of these inputs sits within 1e-4 of the threshold (checked)."""
    images, boxes = _crop_inputs(4)
    jfn, tfn = {"roi_align": (jax_roi_align, roi_align),
                "crop_images": (jax_crop_images, crop_images)}[fn]
    ref = np.asarray(jfn(jnp.asarray(images), jnp.asarray(boxes), (8, 10), 4))
    out = tfn(torch.from_numpy(images), torch.from_numpy(boxes), (8, 10), 4).numpy()
    assert out.shape == ref.shape == (3, 4, 8, 10)
    valid = roi_align(torch.from_numpy((images[:, 3:4] > 0).astype(np.float32)),
                      torch.from_numpy(boxes), (8, 10), 4).numpy()
    assert np.abs(valid - 0.99).min() > 1e-4
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
    if fn == "crop_images":
        assert (out[:, 3] == 0).any() and (out[:, 3] > 0).any()


def test_matmul_crop_matches_gather():
    """The matrix form the pipelines use against the gather form, as the
    JAX package's own test holds them: 2e-5."""
    images, boxes = _crop_inputs(4)
    a = roi_align(torch.from_numpy(images), torch.from_numpy(boxes), (8, 10), 4).numpy()
    b = roi_align_matmul(torch.from_numpy(images), torch.from_numpy(boxes), (8, 10), 4).numpy()
    np.testing.assert_allclose(a, b, atol=2e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_argmin_per_group_with_ties(seed):
    """Tied values, invalid rows and an empty group: the indices are JAX's
    (lowest row wins a tie, -1 for an empty group), the minima too."""
    rs = np.random.RandomState(seed)
    N, G = 40, 6
    key = rs.randint(0, G - 1, N)  # group G-1 stays empty
    value = rs.randint(0, 4, N).astype(np.float32)
    valid = rs.rand(N) > 0.2
    valid[key == 0] = False  # a group with no valid row
    jarg, jmin = jax_argmin_per_group(jnp.asarray(key), jnp.asarray(value), jnp.asarray(valid), G)
    targ, tmin = argmin_per_group(torch.from_numpy(key), torch.from_numpy(value),
                                  torch.from_numpy(valid), G)
    np.testing.assert_array_equal(targ.numpy(), np.asarray(jarg))
    np.testing.assert_array_equal(tmin.numpy(), np.asarray(jmin))
    assert targ[0] == -1 and targ[G - 1] == -1 and np.isinf(tmin.numpy()[[0, G - 1]]).all()


@pytest.mark.parametrize("max_total", [12, 20])
def test_expand_for_symmetry(max_total):
    """Row-major (row, sym) pairs, a row with no symmetry, padded and (at
    12) truncated to `max_total`: equal to JAX's."""
    n_sym = np.asarray([3, 1, 0, 8, 2], np.int32)
    ref = jax_expand_for_symmetry(jnp.asarray(n_sym), max_total)
    out = expand_for_symmetry(torch.from_numpy(n_sym), max_total)
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    n = min(int(n_sym.sum()), max_total)
    assert out[2].sum() == n and out[0][:5].tolist() == [0, 0, 0, 1, 3]
