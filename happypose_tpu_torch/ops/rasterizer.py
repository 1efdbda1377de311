"""The two-pass rasterizer in plain PyTorch, and the pieces every render
path shares (PyTorch port of `happypose_tpu/ops/rasterizer.py`):
screen-space face data, texture resolve and Lambert shading.

`render_batch` runs on any device: (1) a z-buffer pass over fixed-size face
chunks that keeps each pixel's closest face id, (2) a shading pass that
gathers the winning face's vertices and interpolates color and normal
perspective-correctly. It is the second, independent renderer: the pipelines
render through `ops/rasterizer_fused.py` (the hand-written CUDA kernel); the
tests hold that one to this one, and the depth refiners take either through
their `renderer_fn` argument.

Conventions: pixel (i, j) has continuous image coordinates (u, v) = (j, i)
at its centre; a point X_cam projects to u = fx·x/z + cx, v = fy·y/z + cy.
Two-sided rasterization (no backface culling).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from happypose_tpu_torch.meshes.database import RenderAssets

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


def _gather_faces(x: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Per-vertex x [B, V] or [B, V, C] -> per-face [B, F, 3] or [B, F, 3, C]."""
    idx = faces.reshape(faces.shape[0], -1)
    if x.ndim == 2:
        return torch.gather(x, 1, idx).reshape(faces.shape)
    C = x.shape[-1]
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, C)).reshape(*faces.shape, C)


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
    fz = _gather_faces(z, faces)
    return FaceData(
        u=_gather_faces(u, faces),
        v=_gather_faces(v, faces),
        inv_z=1.0 / torch.clamp(fz, min=_Z_NEAR),
        valid=faces_mask & (fz > _Z_NEAR).all(dim=-1),
    )


def shade_lambert(
    rgb: torch.Tensor,  # [B, H, W, 3] albedo
    normals: torch.Tensor,  # [B, H, W, 3] unit, camera-facing
    light_ambient: float,
    light_diffuse: float,
    lights: Optional[torch.Tensor] = None,  # [B, 5]: dir_xyz + ambient + diffuse
) -> torch.Tensor:
    """Lambert shading, applied after texture resolution. The default is the
    headlight model (direction (0, 0, -1) toward the scene). `lights` gives
    per-image lighting instead: the direction from the surface toward the
    light (camera frame, normalized here) and the ambient and diffuse
    strengths."""
    if lights is None:
        lambert = torch.clamp(-normals[..., 2], min=0.0)
        shade = torch.clamp(light_ambient + light_diffuse * lambert, 0.0, 1.0)
        return torch.clamp(rgb * shade[..., None], 0.0, 1.0)
    d = lights[:, 0:3]
    d = d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True), min=1e-8)
    lambert = torch.clamp(torch.einsum("bhwc,bc->bhw", normals, d), min=0.0)
    amb = lights[:, 3, None, None]
    dif = lights[:, 4, None, None]
    shade = torch.clamp(amb + dif * lambert, 0.0, 1.0)
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


def _zbuffer_scan(
    fd: FaceData, resolution: Tuple[int, int], chunk: int = 32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pass 1: per-pixel closest-face search over chunks of `chunk` faces.

    A face covers a pixel where its three edge functions, in vertex-0-centred
    coordinates, have the sign of its area; among covering faces the largest
    1/z wins, the lowest face index on ties (a later face replaces the best
    only where its 1/z is strictly greater). Returns (face_id [B, H, W] int64,
    -1 = background; inv_z_best [B, H, W]).
    """
    H, W = resolution
    B, F = fd.u.shape[:2]
    dev = fd.u.device
    px_u = torch.arange(W, dtype=torch.float32, device=dev)[None, None, None, :]
    px_v = torch.arange(H, dtype=torch.float32, device=dev)[None, None, :, None]
    best_iz = torch.zeros(B, H, W, dtype=torch.float32, device=dev)
    best_id = torch.full((B, H, W), -1, dtype=torch.int64, device=dev)
    for s in range(0, F, chunk):
        sl = slice(s, s + chunk)
        # [B, C, 1, 1] per-face scalars
        u0, u1, u2 = (x[..., None, None] for x in fd.u[:, sl].unbind(-1))
        v0, v1, v2 = (x[..., None, None] for x in fd.v[:, sl].unbind(-1))
        iz0, iz1, iz2 = (x[..., None, None] for x in fd.inv_z[:, sl].unbind(-1))
        e1u, e1v = u1 - u0, v1 - v0
        e2u, e2v = u2 - u0, v2 - v0
        area = e1u * e2v - e2u * e1v  # signed 2x triangle area
        pu = px_u - u0
        pv = px_v - v0
        w1 = pu * e2v - pv * e2u
        w2 = pv * e1u - pu * e1v
        w0 = area - w1 - w2
        sgn = torch.sign(area)
        nondegenerate = area.abs() > 1e-12
        cov = (
            (w0 * sgn >= 0) & (w1 * sgn >= 0) & (w2 * sgn >= 0)
            & nondegenerate & fd.valid[:, sl, None, None]
        )
        inv_area = 1.0 / torch.where(nondegenerate, area, torch.ones_like(area))
        # 1/z is affine in screen space; clamped to the vertex range so a
        # degenerate face can never fabricate a closer depth
        pix_iz = (w0 * iz0 + w1 * iz1 + w2 * iz2) * inv_area
        izs = fd.inv_z[:, sl]
        pix_iz = torch.minimum(
            torch.maximum(pix_iz, izs.amin(-1)[..., None, None]), izs.amax(-1)[..., None, None]
        )
        cand = torch.where(cov, pix_iz, torch.full_like(pix_iz, -1.0))  # [B, C, H, W]
        cbest = cand.amax(dim=1)
        # the first face of the chunk that reaches the chunk's best
        n = cand.shape[1]
        first = torch.where(
            cand == cbest[:, None], torch.arange(n, device=dev)[None, :, None, None], n
        ).amin(dim=1)
        closer = cbest > best_iz
        best_id = torch.where(closer, first + s, best_id)
        best_iz = torch.where(closer, cbest, best_iz)
    return best_id, best_iz


def _shade(
    face_id: torch.Tensor,  # [B, H, W]
    fd: FaceData,
    faces: torch.Tensor,  # [B, F, 3]
    colors: torch.Tensor,  # [B, V, 3]
    normals_obj: torch.Tensor,  # [B, V, 3]
    TCO: torch.Tensor,  # [B, 4, 4]
) -> RenderOutput:
    """Pass 2: per-pixel attribute interpolation. `.rgb` is the unshaded
    albedo (the color channels may carry UVs of textured instances);
    texture resolution and shading happen in `render_batch`."""
    B, H, W = face_id.shape
    dev = face_id.device
    hit = face_id >= 0
    fid = torch.clamp(face_id, min=0).reshape(B, H * W)

    def per_pixel(x):  # [B, F, 3] -> [B, H, W, 3]
        return torch.gather(x, 1, fid[..., None].expand(-1, -1, 3)).reshape(B, H, W, 3)

    tri = per_pixel(faces)
    fu, fv, fiz = per_pixel(fd.u), per_pixel(fd.v), per_pixel(fd.inv_z)
    px_u = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :]
    px_v = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None]

    u0, u1, u2 = fu.unbind(-1)
    v0, v1, v2 = fv.unbind(-1)
    e1u, e1v = u1 - u0, v1 - v0
    e2u, e2v = u2 - u0, v2 - v0
    area = e1u * e2v - e2u * e1v
    pu = px_u - u0
    pv = px_v - v0
    w1 = pu * e2v - pv * e2u
    w2 = pv * e1u - pu * e1v
    w0 = area - w1 - w2
    inv_area = 1.0 / torch.where(area.abs() > 1e-12, area, torch.ones_like(area))
    t0, t1, t2 = w0 * inv_area, w1 * inv_area, w2 * inv_area  # screen bary

    # perspective-correct weights
    iz_px = t0 * fiz[..., 0] + t1 * fiz[..., 1] + t2 * fiz[..., 2]
    z_px = 1.0 / torch.clamp(iz_px, min=1e-12)
    p0 = t0 * fiz[..., 0] * z_px
    p1 = t1 * fiz[..., 1] * z_px
    p2 = t2 * fiz[..., 2] * z_px

    def interp(attr_v):  # [B, V, C] -> [B, H, W, C]
        a = _gather_faces(attr_v, tri.reshape(B, H * W, 3)).reshape(B, H, W, 3, -1)
        return (
            a[..., 0, :] * p0[..., None]
            + a[..., 1, :] * p1[..., None]
            + a[..., 2, :] * p2[..., None]
        )

    color = interp(colors)
    n_px = interp(normals_obj @ TCO[:, :3, :3].transpose(1, 2))
    n_px = n_px / torch.clamp(torch.linalg.vector_norm(n_px, dim=-1, keepdim=True), min=1e-8)
    # two-sided: flip normals facing away from the camera (view dir ~ -z)
    n_px = torch.where(n_px[..., 2:3] > 0, -n_px, n_px)

    hit_f = hit[..., None]
    return RenderOutput(
        rgb=torch.where(hit_f, color, torch.zeros_like(color)),
        depth=torch.where(hit, z_px, torch.zeros_like(z_px)),
        mask=hit,
        normals=torch.where(hit_f, n_px, torch.zeros_like(n_px)),
    )


def render_batch(
    assets: RenderAssets,
    obj_ids: torch.Tensor,  # [B]
    TCO: torch.Tensor,  # [B, 4, 4]
    K: torch.Tensor,  # [B, 3, 3]
    resolution: Tuple[int, int] = (240, 320),
    light_ambient: float = 0.6,
    light_diffuse: float = 0.6,
    face_chunk: int = 32,
    lights: Optional[torch.Tensor] = None,  # [B, 5], see `shade_lambert`
) -> RenderOutput:
    """Render B object instances, one per output image, with the two-pass
    rasterizer (plain PyTorch on the tensors' device)."""
    inst = assets.select(obj_ids)
    # textured instances carry (u, v, 0) in their color channels and are
    # resolved against the texture atlas after rasterization
    uv0 = torch.cat([inst.vertex_uv, torch.zeros_like(inst.vertex_uv[..., :1])], dim=-1)
    attr_c = torch.where(inst.has_texture[:, None, None], uv0, inst.vertex_colors)
    fd = face_screen_data(inst.vertices, inst.faces, inst.faces_mask, TCO, K)
    face_id, _ = _zbuffer_scan(fd, resolution, chunk=face_chunk)
    out = _shade(face_id, fd, inst.faces, attr_c, inst.vertex_normals, TCO)
    albedo = resolve_albedo(out.rgb, assets.textures, obj_ids, inst.has_texture)
    rgb = shade_lambert(albedo, out.normals, light_ambient, light_diffuse, lights)
    rgb = torch.where(out.mask[..., None], rgb, torch.zeros_like(rgb))
    return RenderOutput(rgb=rgb, depth=out.depth, mask=out.mask, normals=out.normals)
