"""Training augmentations (PyTorch port of
`happypose_tpu/datasets/augmentations.py`): blur, the Pillow-style colour
jitter, background replacement, the depth-sensor model and the crop to the
target aspect. Batched tensor ops on the images' device.

Each random augmentation is split in two, as `sample_pose_noise` /
`apply_pose_noise` are: `sample_*` makes the draws with a `torch.Generator`
on its device, and the augmentation itself is deterministic in them, so a
test can hand it the draws `jax.random` made.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from happypose_tpu_torch.lib3d.camera import get_K_crop_resize
from happypose_tpu_torch.ops.crop_resize import roi_align_matmul

Draws = Dict[str, torch.Tensor]


def _uniform(generator: torch.Generator, *shape, lo=0.0, hi=1.0) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(*shape, generator=generator, device=generator.device)


def _upsample(low: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """`jax.image.resize(..., "linear")` upwards: half-pixel centres, the
    edge rows and columns held (JAX drops the taps outside the image and
    renormalizes, which for a magnification is the clamp torch does)."""
    return F.interpolate(low, size=size, mode="bilinear", align_corners=False)


def _blur_kernel(sigma: float, radius: int, like: torch.Tensor) -> torch.Tensor:
    """The normalized 1D gaussian, on `like`'s device."""
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=like.device)
    k = torch.exp(-0.5 * (x / max(sigma, 1e-6)) ** 2)
    return k / k.sum()


def gaussian_blur(images: torch.Tensor, sigma: float, radius: int = 3) -> torch.Tensor:
    """Separable gaussian blur with zero padding; images [B, C, H, W]."""
    k = _blur_kernel(sigma, radius, images)
    B, C, H, W = images.shape
    x = images.reshape(B * C, 1, H, W)
    x = F.conv2d(x, k.reshape(1, 1, 1, -1), padding=(0, radius))
    x = F.conv2d(x, k.reshape(1, 1, -1, 1), padding=(radius, 0))
    return x.reshape(B, C, H, W)


def sample_rgb_jitter(
    generator: torch.Generator,
    batch_size: int,
    p_apply: float = 0.8,
    brightness: float = 0.3,
    contrast: float = 0.3,
    saturation: float = 0.3,
    sharpness: float = 0.5,
) -> Draws:
    """The draws of `rgb_jitter`, one of each per image: a factor and a gate
    for brightness, contrast, saturation and sharpness.

    As in the JAX package, contrast and saturation each take ONE uniform
    `u` for both their gate and their factor (JAX draws both from the same
    key): the jitter is applied when `u < p_apply`, so its factor
    `1 + c (2u - 1)` never exceeds `1 + c (2 p_apply - 1)`. Brightness and
    sharpness have gates of their own."""
    u = _uniform(generator, 6, batch_size)
    return {
        "brightness": 1.0 + (-brightness + 2 * brightness * u[0]),
        "brightness_on": u[1] < p_apply,
        "contrast": 1.0 + (-contrast + 2 * contrast * u[2]),
        "contrast_on": u[2] < p_apply,
        "saturation": 1.0 + (-saturation + 2 * saturation * u[3]),
        "saturation_on": u[3] < p_apply,
        "sharpness": -sharpness + 2 * sharpness * u[4],
        "sharpness_on": u[5] < p_apply,
    }


def rgb_jitter(images: torch.Tensor, draws: Draws, blur_sigma_max: float = 1.2) -> torch.Tensor:
    """Pillow-style enhancement jitters of images [B, 3, H, W] in [0, 1],
    each applied where its gate is on: brightness (scale), contrast (lerp
    to the mean luminance), saturation (lerp to grey), sharpness (unsharp
    mask against a blurred copy); clipped to [0, 1]."""

    def gated(name):
        on = draws[f"{name}_on"].to(images.dtype)[:, None, None, None]
        return on, draws[name][:, None, None, None]

    on, f = gated("brightness")
    images = images * (1 + on * (f - 1))
    lum = images.mean(dim=(1, 2, 3), keepdim=True)
    on, f = gated("contrast")
    images = lum + (images - lum) * (1 + on * (f - 1))
    gray = images.mean(dim=1, keepdim=True)
    on, f = gated("saturation")
    images = gray + (images - gray) * (1 + on * (f - 1))
    blurred = gaussian_blur(images, sigma=blur_sigma_max)
    on, f = gated("sharpness")
    images = images + on * f * (images - blurred)
    return torch.clamp(images, 0.0, 1.0)


def sample_background_replace(
    generator: torch.Generator,
    batch_size: int,
    resolution: Tuple[int, int],
    n_backgrounds: Optional[int] = None,
    p_apply: float = 0.3,
) -> Draws:
    """The draws of `background_replace`: which images get a new background
    (`apply`), and either an index into a pool of `n_backgrounds` images
    (`bg_idx`) or, without a pool, uniform noise at 1/8 of the resolution
    (`bg_low`) that is smoothed up to it."""
    H, W = resolution
    dev = generator.device
    if n_backgrounds is None:
        pick = {"bg_low": _uniform(generator, batch_size, 3, H // 8, W // 8)}
    else:
        pick = {"bg_idx": torch.randint(0, n_backgrounds, (batch_size,), generator=generator,
                                        device=dev)}
    return {**pick, "apply": _uniform(generator, batch_size) < p_apply}


def background_replace(
    images: torch.Tensor,  # [B, 3, H, W]
    fg_mask: torch.Tensor,  # [B, H, W] bool, object pixels
    draws: Draws,
    backgrounds: Optional[torch.Tensor] = None,  # [N, 3, H, W] pool
) -> torch.Tensor:
    """Replace the background pixels of the drawn images with a pool image,
    or without a pool with the drawn noise upsampled bilinearly."""
    H, W = images.shape[-2:]
    bg = _upsample(draws["bg_low"], (H, W)) if backgrounds is None else backgrounds[draws["bg_idx"]]
    out = torch.where(fg_mask[:, None], images, bg)
    return torch.where(draws["apply"][:, None, None, None], out, images)


def sample_depth_augment(
    generator: torch.Generator,
    batch_size: int,
    resolution: Tuple[int, int],
    ellipse_dropout_rate: float = 3.0,
) -> Draws:
    """The draws of `depth_augment`: standard normals for the correlated
    noise (at 1/8 of the resolution) and the white noise, `int(rate)`
    ellipses an image (centre `cx` in [0, W), `cy` in [0, H), half-axes
    `ra` in [2, 0.08 W), `rb` in [2, 0.08 H); [n, B] each) and a uniform a
    pixel for the missing pixels."""
    H, W = resolution
    B, n, dev = batch_size, int(ellipse_dropout_rate), generator.device

    def normal(*shape):
        return torch.randn(*shape, generator=generator, device=dev)

    return {
        "corr": normal(B, 1, H // 8, W // 8),
        "white": normal(B, 1, H, W),
        "cx": _uniform(generator, n, B, hi=W),
        "cy": _uniform(generator, n, B, hi=H),
        "ra": _uniform(generator, n, B, lo=2.0, hi=W * 0.08),
        "rb": _uniform(generator, n, B, lo=2.0, hi=H * 0.08),
        "missing_u": _uniform(generator, B, 1, H, W),
    }


def depth_augment(
    depth: torch.Tensor,  # [B, 1, H, W] metres, 0 = missing
    draws: Draws,
    blur_sigma: float = 1.0,
    noise_std: float = 0.003,
    corr_noise_std: float = 0.005,
    p_missing: float = 0.05,
) -> torch.Tensor:
    """Depth-sensor model: blur, correlated + white gaussian noise, the
    drawn ellipses zeroed, random missing pixels, and pixels without depth
    kept at 0."""
    B, _, H, W = depth.shape
    valid = depth > 0
    d = gaussian_blur(depth, blur_sigma)
    d = d + _upsample(draws["corr"] * corr_noise_std, (H, W)) + draws["white"] * noise_std
    uu = torch.arange(W, dtype=torch.float32, device=depth.device)[None, :]
    vv = torch.arange(H, dtype=torch.float32, device=depth.device)[:, None]
    drop = torch.zeros(B, H, W, dtype=torch.bool, device=depth.device)
    for cx, cy, ra, rb in zip(draws["cx"], draws["cy"], draws["ra"], draws["rb"]):
        e = ((uu - cx[:, None, None]) / ra[:, None, None]) ** 2 \
            + ((vv - cy[:, None, None]) / rb[:, None, None]) ** 2
        drop = drop | (e < 1.0)
    missing = draws["missing_u"] < p_missing
    d = torch.where(drop[:, None] | missing | ~valid, torch.zeros_like(d), d)
    return torch.clamp(d, min=0.0)


def crop_resize_to_aspect(
    images: torch.Tensor,  # [B, C, H, W]
    K: torch.Tensor,  # [B, 3, 3]
    target_hw: Tuple[int, int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Centre-crop to the target aspect ratio, then resize to `target_hw`;
    returns the images and their updated intrinsics."""
    B, _, H, W = images.shape
    th, tw = target_hw
    target_ratio = tw / th
    if W / H > target_ratio:
        crop_w, crop_h = H * target_ratio, H
    else:
        crop_w, crop_h = W, W / target_ratio
    x1 = (W - crop_w) / 2
    y1 = (H - crop_h) / 2
    boxes = torch.tensor(
        [x1, y1, x1 + crop_w, y1 + crop_h], dtype=torch.float32, device=images.device
    ).expand(B, 4)
    out = roi_align_matmul(images, boxes, target_hw, sampling_ratio=2)
    return out, get_K_crop_resize(K, boxes, (H, W), target_hw)
