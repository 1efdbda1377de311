"""Training augmentations and the prefetch thread: the port against the JAX
package.

Each augmentation runs on the same numpy images with the draws JAX made
(`jax.random` on the keys JAX's function splits) handed to the port, to
1e-6 (float32 convolutions and means summed in another order). The depth
model's dropped pixels (ellipses, missing pixels) are compared exactly.
The port's own samplers are held to the distributions JAX draws from,
among them `rgb_jitter`'s gate and factor sharing one uniform.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import happypose_tpu.datasets.augmentations as jaug
import happypose_tpu_torch.datasets.augmentations as taug
from happypose_tpu.utils.prefetch import prefetch as jax_prefetch
from happypose_tpu_torch.utils.prefetch import PrefetchIterator, prefetch

ATOL = 1e-6


def _images(B=3, H=24, W=40, seed=0):
    return np.random.RandomState(seed).rand(B, 3, H, W).astype(np.float32)


def _u(key, B):
    return np.asarray(jax.random.uniform(key, (B, 1, 1, 1))).reshape(B)


def _jax_rgb_jitter_draws(key, B, p=0.8, brightness=0.3, contrast=0.3, saturation=0.3,
                          sharpness=0.5):
    """What `jaug.rgb_jitter` draws from `key`, as the port's draws."""
    keys = jax.random.split(key, 7)

    def factor(k, r):
        return np.asarray(jax.random.uniform(k, (B, 1, 1, 1), minval=-r, maxval=r)).reshape(B)

    d = {
        "brightness": 1.0 + factor(keys[0], brightness), "brightness_on": _u(keys[1], B) < p,
        # the gate and the factor of contrast (and of saturation) share a key
        "contrast": 1.0 + factor(keys[2], contrast), "contrast_on": _u(keys[2], B) < p,
        "saturation": 1.0 + factor(keys[3], saturation), "saturation_on": _u(keys[3], B) < p,
        "sharpness": factor(keys[4], sharpness), "sharpness_on": _u(keys[5], B) < p,
    }
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


@pytest.mark.parametrize("sigma,radius", [(1.2, 3), (0.5, 2), (2.0, 4)])
def test_gaussian_blur_matches_jax(sigma, radius):
    x = _images()
    ref = np.asarray(jaug.gaussian_blur(jnp.asarray(x), sigma, radius))
    out = taug.gaussian_blur(torch.from_numpy(x), sigma, radius).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rgb_jitter_matches_jax_with_its_draws(seed):
    x = _images(B=8, seed=seed)
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(jaug.rgb_jitter(key, jnp.asarray(x)))
    draws = _jax_rgb_jitter_draws(key, 8)
    out = taug.rgb_jitter(torch.from_numpy(x), draws).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)
    assert not np.allclose(out, x)


def test_rgb_jitter_gate_and_factor_share_a_draw():
    """Contrast and saturation are on where their uniform is below 0.8, and
    their factor is 1 + c (2u - 1) of the same uniform: never above
    1 + 0.6 c when on, never below it when off. JAX's draws obey the same
    bound; the port draws the same distribution."""
    n = 20000
    draws = taug.sample_rgb_jitter(torch.Generator().manual_seed(0), n)
    jd = _jax_rgb_jitter_draws(jax.random.PRNGKey(3), n)
    bound = 1.0 + 0.6 * 0.3
    for d in (draws, jd):
        for name in ("contrast", "saturation"):
            on, f = d[f"{name}_on"], d[name]
            assert f[on].max() <= bound + 1e-6 and f[~on].min() >= bound - 1e-6
            assert f[on].max() > bound - 1e-3 and f.min() < 0.7 + 1e-3
        assert abs(d["brightness_on"].float().mean() - 0.8) < 0.02
        # brightness keeps an independent gate: its factor spans the full range when on
        assert d["brightness"][d["brightness_on"]].max() > 1.29
    for name in ("brightness_on", "contrast_on", "saturation_on", "sharpness_on"):
        assert abs(draws[name].float().mean() - jd[name].float().mean()) < 0.02


@pytest.mark.parametrize("size", [(24, 40), (60, 80), (30, 17)])
def test_upsample_matches_jax_image_resize(size):
    """`jax.image.resize(..., "linear")` 8x up (and uneven ratios), border
    rows and columns included."""
    H, W = size
    low = np.random.RandomState(4).rand(2, 3, H // 8, W // 8).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(low), (2, 3, H, W), "linear"))
    out = taug._upsample(torch.from_numpy(low), (H, W)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)
    for edge in (np.s_[..., 0, :], np.s_[..., -1, :], np.s_[..., :, 0], np.s_[..., :, -1]):
        np.testing.assert_allclose(out[edge], ref[edge], rtol=0, atol=ATOL)


@pytest.mark.parametrize("pool", [False, True], ids=["noise", "pool"])
def test_background_replace_matches_jax_with_its_draws(pool):
    B, H, W = 6, 32, 48
    x = _images(B, H, W, seed=5)
    fg = np.zeros((B, H, W), bool)
    fg[:, 8:20, 10:30] = True
    backgrounds = np.random.RandomState(6).rand(4, 3, H, W).astype(np.float32) if pool else None
    key = jax.random.PRNGKey(9)
    ref = np.asarray(jaug.background_replace(
        key, jnp.asarray(x), jnp.asarray(fg), None if backgrounds is None else jnp.asarray(backgrounds),
        p_apply=0.5))
    k1, k2, _ = jax.random.split(key, 3)
    draws = {"apply": torch.from_numpy(_u(k2, B) < 0.5)}
    if pool:
        draws["bg_idx"] = torch.from_numpy(np.array(jax.random.randint(k1, (B,), 0, 4))).long()
    else:
        draws["bg_low"] = torch.from_numpy(np.array(jax.random.uniform(k1, (B, 3, H // 8, W // 8))))
    out = taug.background_replace(torch.from_numpy(x), torch.from_numpy(fg), draws,
                                  None if backgrounds is None else torch.from_numpy(backgrounds))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ATOL)
    assert draws["apply"].any() and not draws["apply"].all()
    # the sampler's draws have the shapes the function reads
    d = taug.sample_background_replace(torch.Generator().manual_seed(0), B, (H, W),
                                       n_backgrounds=4 if pool else None)
    assert set(d) == set(draws) and all(d[k].shape == draws[k].shape for k in d)


def test_depth_augment_matches_jax_with_its_draws():
    B, H, W = 3, 40, 56
    depth = np.full((B, 1, H, W), 0.5, np.float32)
    depth[:, :, :4] = 0.0  # missing rows stay missing
    key = jax.random.PRNGKey(2)
    ref = np.asarray(jaug.depth_augment(key, jnp.asarray(depth)))
    keys = jax.random.split(key, 5)
    ck = jax.random.split(keys[2], 3)
    ell = {k: [] for k in ("cx", "cy", "ra", "rb")}
    for i in range(3):
        kc, ka, kb, kr = jax.random.split(ck[i], 4)
        for name, k, lo, hi in (("cx", kc, 0, W), ("cy", ka, 0, H), ("ra", kb, 2, W * 0.08),
                                ("rb", kr, 2, H * 0.08)):
            ell[name].append(np.asarray(jax.random.uniform(k, (B, 1, 1), minval=lo, maxval=hi))
                             .reshape(B))
    draws = {
        "corr": np.array(jax.random.normal(keys[0], (B, 1, H // 8, W // 8))),
        "white": np.array(jax.random.normal(keys[1], (B, 1, H, W))),
        "missing_u": np.array(jax.random.uniform(keys[3], (B, 1, H, W))),
        **{k: np.stack(v) for k, v in ell.items()},
    }
    out = taug.depth_augment(torch.from_numpy(depth),
                             {k: torch.from_numpy(v) for k, v in draws.items()}).numpy()
    np.testing.assert_array_equal(out == 0, ref == 0)  # ellipses and missing pixels, exactly
    assert (ref == 0).mean() > 0.1 and (ref[:, :, :4] == 0).all()
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)
    d = taug.sample_depth_augment(torch.Generator().manual_seed(0), B, (H, W))
    assert all(tuple(d[k].shape) == draws[k].shape for k in draws)
    assert (d["ra"] >= 2).all() and (d["ra"] < W * 0.08).all() and (d["cy"] < H).all()


# ---------------------------------------------------------------- prefetch

def test_prefetch_order_and_completion_as_jax():
    assert list(prefetch(iter(range(20)), depth=3)) == list(jax_prefetch(iter(range(20)), 3))


def test_prefetch_raises_the_worker_error_in_the_consumer():
    def gen():
        yield 1
        raise ValueError("bad shard member")

    it = prefetch(gen(), depth=2)
    assert next(it) == 1
    with pytest.raises(ValueError, match="bad shard member"):
        next(it)
    assert not it._thread.is_alive()
    with pytest.raises(StopIteration):
        next(it)


def test_prefetch_close_stops_a_worker_blocked_on_a_full_queue():
    produced = []

    def endless():
        i = 0
        while True:
            produced.append(i)
            yield i
            i += 1

    with PrefetchIterator(endless(), depth=2) as it:
        assert next(it) == 0
        time.sleep(0.2)
    assert not it._thread.is_alive()
    assert len(produced) <= 5  # bounded: the worker waited on the full queue
    assert threading.active_count() >= 1
