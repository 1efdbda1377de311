"""Rasterizer pieces shared by every render path (PyTorch port of the
matching parts of `happypose_tpu/ops/rasterizer.py`): screen-space face
data, texture resolve and Lambert shading. The z-buffer itself is
`ops/rasterizer_fused.py`.

Conventions: pixel (i, j) has continuous image coordinates (u, v) = (j, i)
at its centre; a point X_cam projects to u = fx·x/z + cx, v = fy·y/z + cy.
Two-sided rasterization (no backface culling).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

_Z_NEAR = 1e-3


@dataclass
class RenderOutput:
    """Batched render results (channels-last)."""

    rgb: torch.Tensor  # [B, H, W, 3] float32 in [0, 1]
    depth: torch.Tensor  # [B, H, W] float32, 0 where no hit
    mask: torch.Tensor  # [B, H, W] bool
    normals: torch.Tensor  # [B, H, W, 3] camera frame, 0 where no hit


@dataclass
class FaceData:
    """Per-face screen-space data of a batch of images."""

    u: torch.Tensor  # [B, F, 3] screen u of the 3 vertices
    v: torch.Tensor  # [B, F, 3]
    inv_z: torch.Tensor  # [B, F, 3] 1/z_cam of the 3 vertices
    valid: torch.Tensor  # [B, F] face usable (masked in, in front of camera)


def face_screen_data(
    vertices: torch.Tensor,  # [B, V, 3]
    faces: torch.Tensor,  # [B, F, 3] int
    faces_mask: torch.Tensor,  # [B, F] bool
    TCO: torch.Tensor,  # [B, 4, 4]
    K: torch.Tensor,  # [B, 3, 3]
) -> FaceData:
    """Project each image's vertices and gather per-face screen coordinates."""
    R, t = TCO[:, :3, :3], TCO[:, :3, 3]
    verts_cam = vertices @ R.transpose(1, 2) + t[:, None, :]  # [B, V, 3]
    z = verts_cam[..., 2]
    safe_z = torch.clamp(z, min=_Z_NEAR)
    u = K[:, 0, 0, None] * verts_cam[..., 0] / safe_z + K[:, 0, 2, None]
    v = K[:, 1, 1, None] * verts_cam[..., 1] / safe_z + K[:, 1, 2, None]

    def gather(x):  # [B, V] -> [B, F, 3]
        return torch.gather(x, 1, faces.reshape(faces.shape[0], -1)).reshape(faces.shape)

    fz = gather(z)
    return FaceData(
        u=gather(u),
        v=gather(v),
        inv_z=1.0 / torch.clamp(fz, min=_Z_NEAR),
        valid=faces_mask & (fz > _Z_NEAR).all(dim=-1),
    )


def shade_lambert(
    rgb: torch.Tensor,  # [B, H, W, 3] albedo
    normals: torch.Tensor,  # [B, H, W, 3] unit, camera-facing
    light_ambient: float,
    light_diffuse: float,
) -> torch.Tensor:
    """Lambert shading under the headlight model (direction (0, 0, -1)
    toward the scene), applied after texture resolution. The JAX version's
    per-image `lights` serve the scene recorder, which is not ported."""
    lambert = torch.clamp(-normals[..., 2], min=0.0)
    shade = torch.clamp(light_ambient + light_diffuse * lambert, 0.0, 1.0)
    return torch.clamp(rgb * shade[..., None], 0.0, 1.0)


def sample_textures_at(
    textures: torch.Tensor,  # [n_obj, T, T, 3]
    obj_ids: torch.Tensor,  # [B]
    uv: torch.Tensor,  # [B, H, W, 2]
) -> torch.Tensor:
    """Bilinear texture lookup -> [B, H, W, 3] through a flat-index gather
    over the whole atlas. v=0 is the image bottom; textures store row 0 at
    the top. UVs wrap (GL_REPEAT); an exact 1.0 stays."""
    n_obj, T = textures.shape[0], textures.shape[1]
    flat = textures.reshape(n_obj * T * T, 3)

    def wrap(x):
        return torch.where(x == 1.0, torch.ones_like(x), x - torch.floor(x))

    u = wrap(uv[..., 0]) * (T - 1)
    v = (1.0 - wrap(uv[..., 1])) * (T - 1)
    x0f = torch.floor(u)
    y0f = torch.floor(v)
    fx = (u - x0f)[..., None]
    fy = (v - y0f)[..., None]
    x0 = x0f.long()
    y0 = y0f.long()
    x1 = torch.clamp(x0 + 1, max=T - 1)
    y1 = torch.clamp(y0 + 1, max=T - 1)
    base = (obj_ids.long() * T * T)[:, None, None]

    def g(y, x):
        return flat[base + y * T + x]

    return (
        g(y0, x0) * (1 - fx) * (1 - fy)
        + g(y0, x1) * fx * (1 - fy)
        + g(y1, x0) * (1 - fx) * fy
        + g(y1, x1) * fx * fy
    )


def resolve_albedo(
    rgb_attr: torch.Tensor,  # [B, H, W, 3] interpolated color channels
    textures: torch.Tensor,  # [n_obj, T, T, 3]
    obj_ids: torch.Tensor,  # [B]
    has_texture: torch.Tensor,  # [B] bool
) -> torch.Tensor:
    """Textured instances carry (u, v, 0) in their color channels; resolve
    them to sampled texture RGB. Untextured instances pass through."""
    if textures.shape[1] == 1:  # untextured database: skip the gathers
        return rgb_attr
    tex_rgb = sample_textures_at(textures, obj_ids, rgb_attr[..., 0:2])
    return torch.where(has_texture[:, None, None, None], tex_rgb, rgb_attr)
