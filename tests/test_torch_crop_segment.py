"""Crop-resize matmuls and the group-wise top-k: the port against JAX."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from happypose_tpu.ops.crop_resize import crop_images_matmul as jax_crop
from happypose_tpu.ops.segment_ops import group_keys as jax_group_keys
from happypose_tpu.ops.segment_ops import topk_per_group as jax_topk
from happypose_tpu_torch.ops.crop_resize import crop_images_matmul
from happypose_tpu_torch.ops.segment_ops import group_keys, topk_per_group

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
