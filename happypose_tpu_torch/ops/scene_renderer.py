"""Multi-object scene rendering by z-composite of per-object renders
(PyTorch port of `happypose_tpu/ops/scene_renderer.py`).

The batched rasterizer renders one object per image, so scenes composite by
a per-pixel nearest-depth merge: exact for opaque objects, fully batched,
one `render_batch_fused` call (one launch of the hand-written kernel for
CUDA tensors). Used to synthesize frames and by the visualizations.
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import torch

from happypose_tpu_torch.meshes.database import RenderAssets
from happypose_tpu_torch.ops.rasterizer import RenderOutput
from happypose_tpu_torch.ops.rasterizer_fused import render_batch_fused


def render_scenes(
    assets: RenderAssets,
    obj_ids: torch.Tensor,  # [N] all instances across scenes
    scene_ids: torch.Tensor,  # [N] which scene each instance belongs to
    TCO: torch.Tensor,  # [N, 4, 4]
    K: torch.Tensor,  # [N, 3, 3] (same K within a scene)
    valid: torch.Tensor,  # [N]
    n_scenes: int,
    resolution: Tuple[int, int] = (240, 320),
    light_ambient: float = 0.6,
    light_diffuse: float = 0.6,
    lights: Optional[torch.Tensor] = None,
    renderer_fn=render_batch_fused,
) -> RenderOutput:
    """Composite per-instance renders into [n_scenes, ...] frames.
    `lights`: optional [N, 5] per-INSTANCE lighting rows (pass each
    scene's lighting repeated over its instances; see `shade_lambert`).
    Two instances at exactly equal depth both count as front: their
    colours and normals add, as in the JAX package."""
    out = renderer_fn(
        assets, obj_ids, TCO, K, resolution=resolution,
        light_ambient=light_ambient, light_diffuse=light_diffuse,
        lights=lights,
    )
    return composite(out, scene_ids, valid, n_scenes)[0]


def scene_zmin(
    out: RenderOutput, scene_ids: torch.Tensor, valid: torch.Tensor, n_scenes: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(z [N, H, W]: each valid instance's depth, inf where it misses;
    zmin [n_scenes, H, W]: the nearest of a scene's, inf where none hits)."""
    H, W = out.depth.shape[1:]
    z = torch.where(out.mask & valid[:, None, None], out.depth,
                    torch.full_like(out.depth, float("inf")))
    # per-scene nearest instance per pixel: minimum over an inf-filled target
    zmin = torch.full((n_scenes, H, W), float("inf"), dtype=z.dtype, device=z.device)
    with warnings.catch_warnings():  # "index_reduce() is in beta"
        warnings.filterwarnings("ignore", message="index_reduce", category=UserWarning)
        zmin.index_reduce_(0, scene_ids.to(torch.int64), z, "amin", include_self=True)
    return z, zmin


def composite(
    out: RenderOutput,  # per instance [N, H, W, ...]
    scene_ids: torch.Tensor,  # [N]
    valid: torch.Tensor,  # [N]
    n_scenes: int,
) -> Tuple[RenderOutput, torch.Tensor]:
    """Nearest-depth merge of per-instance renders into scenes: the scenes'
    `RenderOutput` and `is_front` [N, H, W], where each valid instance is
    the scene's nearest surface."""
    scene_ids = scene_ids.to(torch.int64)
    z, zmin = scene_zmin(out, scene_ids, valid, n_scenes)
    is_front = (z == zmin[scene_ids]) & torch.isfinite(z)  # [N, H, W]

    def seg(x: torch.Tensor) -> torch.Tensor:
        acc = torch.zeros((n_scenes,) + x.shape[1:], dtype=x.dtype, device=x.device)
        return acc.index_add_(0, scene_ids, x * is_front[..., None].to(x.dtype))

    mask = torch.isfinite(zmin)
    return RenderOutput(
        rgb=seg(out.rgb),
        depth=torch.where(mask, zmin, torch.zeros_like(zmin)),
        mask=mask,
        normals=seg(out.normals),
    ), is_front
