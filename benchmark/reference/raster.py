"""A z-buffer renderer of textured triangle meshes in plain PyTorch, held
to the program's rasterizer bit for bit.

Each face is written as affine functions of the pixel (three normalized
edge functions, 1/z and six attribute * 1/z channels) and evaluated at
the pixels of its screen box +-1 px in 8 x 32 tiles, in tile-local
coordinates: R = (a pu + b pv) + ((c + a tu0) + b tv0), every product
and sum rounded on its own. A pixel keeps its largest 1/z (clamped to the
face's vertex range) among the faces that cover it, and among equal
values the face that comes first by the tile of its box centre, then by
its index. Where a pixel's winner differs from the program's, the two
renders differ; so the arithmetic order is part of the definition.

Instead of the program's per-tile face lists, the faces here are
expanded into their candidate pixels, in passes of at most `MAX_CANDIDATES`,
and merged with one scatter-max of (1/z, priority) keys a pass.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

TILE_H, TILE_W = 8, 32
Z_NEAR = 1e-3
MAX_CANDIDATES = 1 << 23
_LOW = (1 << 31) - 1


class Meshes(NamedTuple):
    """The object database as the renderer reads it, one row an object:
    vertices [n, V, 3], faces [n, F, 3] int64, vertex normals [n, V, 3],
    uv [n, V, 2] (v = 0 at the texture's bottom), textures [n, T, T, 3]
    (row 0 at the top)."""

    vertices: torch.Tensor
    faces: torch.Tensor
    normals: torch.Tensor
    uv: torch.Tensor
    textures: torch.Tensor


def _per_face(x: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    idx = faces.reshape(faces.shape[0], -1)
    if x.ndim == 2:
        return torch.gather(x, 1, idx).reshape(faces.shape)
    c = x.shape[-1]
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, c)).reshape(*faces.shape, c)


def screen_faces(meshes: Meshes, obj_ids, T, K):
    """Per face of each render: u, v, 1/z [B, F, 3], valid [B, F] and the
    vertex attributes [B, F, 3, 6] (u, v, 0, camera-frame normal)."""
    R, t = T[:, :3, :3], T[:, :3, 3]
    verts = meshes.vertices[obj_ids]
    faces = meshes.faces[obj_ids]
    cam = verts @ R.transpose(1, 2) + t[:, None, :]
    z = cam[..., 2]
    zs = torch.clamp(z, min=Z_NEAR)
    u = K[:, 0, 0, None] * cam[..., 0] / zs + K[:, 0, 2, None]
    v = K[:, 1, 1, None] * cam[..., 1] / zs + K[:, 1, 2, None]
    fz = _per_face(z, faces)
    uv0 = torch.cat([meshes.uv[obj_ids], torch.zeros_like(meshes.uv[obj_ids][..., :1])], -1)
    n_cam = meshes.normals[obj_ids] @ R.transpose(1, 2)
    attrs = _per_face(torch.cat([uv0, n_cam], dim=-1), faces)
    return (_per_face(u, faces), _per_face(v, faces), 1.0 / torch.clamp(fz, min=Z_NEAR),
            (fz > Z_NEAR).all(dim=-1), attrs)


def affine_rows(u, v, inv_z, valid, attr_iz, size):
    """Rows [B, F, 3 (a, b, c), 12]: three edge functions, 1/z, six
    attribute * 1/z channels, then the 1/z range; and the screen box
    [B, F, 4] clamped to the image (+-1e9 where the face covers nothing)."""
    H, W = size
    u0, u1, u2 = u.unbind(-1)
    v0, v1, v2 = v.unbind(-1)
    e1u, e1v = u1 - u0, v1 - v0
    e2u, e2v = u2 - u0, v2 - v0
    area = e1u * e2v - e2u * e1v
    ok = valid & (area.abs() > 1e-12)
    zero = torch.zeros_like(area)
    norm = torch.where(ok, torch.sign(area) / torch.clamp(area.abs(), min=1e-12), zero)
    a1, b1 = e2v * norm, -e2u * norm
    c1 = (-u0 * e2v + v0 * e2u) * norm
    a2, b2 = -e1v * norm, e1u * norm
    c2 = (u0 * e1v - v0 * e1u) * norm
    a0, b0 = -(a1 + a2), -(b1 + b2)
    c0 = torch.where(ok, area * norm - c1 - c2, zero - 1.0)
    bary = torch.stack([torch.stack([a0, b0, c0], -1), torch.stack([a1, b1, c1], -1),
                        torch.stack([a2, b2, c2], -1)], dim=-2)  # [B, F, vertex, abc]
    vals = torch.cat([inv_z[..., None], attr_iz], dim=-1)  # [B, F, vertex, 7]
    chan = (bary[..., 0, :, None] * vals[..., 0, None, :]
            + bary[..., 1, :, None] * vals[..., 1, None, :]
            + bary[..., 2, :, None] * vals[..., 2, None, :])  # [B, F, abc, 7]
    big = torch.full_like(area, 1e9)
    box = torch.stack([
        torch.where(ok, torch.clamp(u.amin(-1), 0.0, W - 1.0), big),
        torch.where(ok, torch.clamp(v.amin(-1), 0.0, H - 1.0), big),
        torch.where(ok, torch.clamp(u.amax(-1), 0.0, W - 1.0), -big),
        torch.where(ok, torch.clamp(v.amax(-1), 0.0, H - 1.0), -big)], dim=-1)
    zrange = torch.stack([inv_z.amin(-1), inv_z.amax(-1)], dim=-1)
    const = torch.stack([torch.zeros_like(zrange), torch.zeros_like(zrange), zrange], dim=-2)
    rows = torch.cat([bary.transpose(-1, -2), chan, const], dim=-1)
    return rows, box


def pixel_ranges(box: torch.Tensor, size):
    """The first pixel and the count along x and y [B, F] that a face's box
    +-1 px reaches inside the image."""
    H, W = size
    x0 = torch.clamp(torch.ceil(box[..., 0] - 1.0), min=0.0)
    x1 = torch.clamp(torch.floor(box[..., 2] + 1.0), max=W - 1.0)
    y0 = torch.clamp(torch.ceil(box[..., 1] - 1.0), min=0.0)
    y1 = torch.clamp(torch.floor(box[..., 3] + 1.0), max=H - 1.0)
    nx = torch.clamp(x1 - x0 + 1, min=0).long()
    ny = torch.clamp(y1 - y0 + 1, min=0).long()
    return x0.long(), nx, y0.long(), ny


def _priority(box: torch.Tensor) -> torch.Tensor:
    """[B, F] order among faces of equal 1/z: the tile row-major index of
    the box centre, then the face index."""
    F = box.shape[1]
    cu = (box[..., 0] + box[..., 2]) * 0.5
    cv = (box[..., 1] + box[..., 3]) * 0.5
    ku = torch.clamp(cu / TILE_W, 0, 255).to(torch.int64)
    kv = torch.clamp(cv / TILE_H, 0, 255).to(torch.int64)
    return (kv * 256 + ku) * F + torch.arange(F, device=box.device)


def _eval(rows_a, rows_b, rows_c, x, y):
    """rows [N, k] at pixels (x, y) [N] in the tile-local arithmetic."""
    tu0 = torch.div(x, TILE_W, rounding_mode="floor").float() * TILE_W
    tv0 = torch.div(y, TILE_H, rounding_mode="floor").float() * TILE_H
    pu = (x.float() - tu0)[:, None]
    pv = (y.float() - tv0)[:, None]
    return (rows_a * pu + rows_b * pv) + ((rows_c + rows_a * tu0[:, None]) + rows_b * tv0[:, None])


def rasterize(u, v, inv_z, valid, attrs, size) -> Tuple[torch.Tensor, torch.Tensor]:
    """(1/z [B, H, W], attributes [B, 6, H, W]) of the closest face a pixel,
    0 where none covers it."""
    H, W = size
    B, F = u.shape[:2]
    dev = u.device
    rows, box = affine_rows(u, v, inv_z, valid, attrs * inv_z[..., None], size)
    prio = _priority(box)
    x0, nx, y0, ny = pixel_ranges(box, size)
    count = (nx * ny).reshape(-1)
    best = torch.full((B * H * W,), -1, dtype=torch.int64, device=dev)
    ends = torch.cumsum(count, 0)
    total = int(ends[-1]) if count.numel() else 0
    face_start = 0
    flat_rows = rows.reshape(B * F, 3, -1)
    while face_start < B * F and total:
        done = int(ends[face_start - 1]) if face_start else 0
        stop = int(torch.searchsorted(ends, done + MAX_CANDIDATES, right=True))
        stop = max(stop, face_start + 1)
        sel = torch.arange(face_start, stop, device=dev)
        n = count[sel]
        bf = torch.repeat_interleave(sel, n)
        k = torch.arange(int(n.sum()), device=dev) - torch.repeat_interleave(torch.cumsum(n, 0) - n, n)
        b = bf // F
        f_nx = nx.reshape(-1)[bf]
        x = x0.reshape(-1)[bf] + k % f_nx
        y = y0.reshape(-1)[bf] + k // f_nx
        r = flat_rows[bf]
        R = _eval(r[:, 0, :4], r[:, 1, :4], r[:, 2, :4], x, y)
        iz = torch.minimum(torch.maximum(R[:, 3], r[:, 2, 10]), r[:, 2, 11])
        hit = (R[:, 0] >= 0) & (R[:, 1] >= 0) & (R[:, 2] >= 0) & (iz > 0)
        key = (iz.view(torch.int32).to(torch.int64) << 32) | (_LOW - prio.reshape(-1)[bf])
        pix = (b * H + y) * W + x
        best.scatter_reduce_(0, pix[hit], key[hit], "amax")
        face_start = stop
    pix = torch.nonzero(best >= 0)[:, 0]
    won = best[pix]
    iz = torch.zeros(B * H * W, device=dev)
    iz[pix] = (won >> 32).to(torch.int32).view(torch.float32)
    b, y, x = pix // (H * W), (pix // W) % H, pix % W
    r = flat_rows[b * F + (_LOW - (won & 0xFFFFFFFF)) % F]
    attr = torch.zeros(B * H * W, 6, device=dev)
    attr[pix] = _eval(r[:, 0, 4:10], r[:, 1, 4:10], r[:, 2, 4:10], x, y)
    iz = iz.reshape(B, H, W)
    z = torch.where(iz > 0, 1.0 / torch.clamp(iz, min=1e-12), torch.zeros_like(iz))
    attr = attr.reshape(B, H, W, 6).permute(0, 3, 1, 2).contiguous()
    return iz, attr * z[:, None]


def sample_texture(textures, obj_ids, uv):
    """Bilinear lookup of [B, H, W, 2] uv in each render's texture; uv wrap
    (an exact 1.0 stays), v = 0 is the texture's bottom row."""
    n, T = textures.shape[0], textures.shape[1]
    flat = textures.reshape(n * T * T, 3)

    def wrap(a):
        return torch.where(a == 1.0, torch.ones_like(a), a - torch.floor(a))

    u = wrap(uv[..., 0]) * (T - 1)
    v = (1.0 - wrap(uv[..., 1])) * (T - 1)
    x0f, y0f = torch.floor(u), torch.floor(v)
    fx, fy = (u - x0f)[..., None], (v - y0f)[..., None]
    x0, y0 = x0f.long(), y0f.long()
    x1, y1 = torch.clamp(x0 + 1, max=T - 1), torch.clamp(y0 + 1, max=T - 1)
    base = (obj_ids.long() * T * T)[:, None, None]

    def g(yy, xx):
        return flat[base + yy * T + xx]

    return (g(y0, x0) * (1 - fx) * (1 - fy) + g(y0, x1) * fx * (1 - fy)
            + g(y1, x0) * (1 - fx) * fy + g(y1, x1) * fx * fy)


def render(meshes: Meshes, obj_ids, T, K, size, ambient: float = 0.6, diffuse: float = 0.6):
    """Shaded texture colour and camera-facing normals, [B, H, W, 3] each,
    0 off the object (Lambert under a headlight), and the object's mask."""
    u, v, iz, valid, attrs = screen_faces(meshes, obj_ids, T, K)
    izb, attr = rasterize(u, v, iz, valid, attrs, size)
    hit = (izb > 0)[..., None]
    uvw = attr[:, 0:3].permute(0, 2, 3, 1)
    n = attr[:, 3:6].permute(0, 2, 3, 1)
    n = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=1e-8)
    n = torch.where(n[..., 2:3] > 0, -n, n)
    albedo = sample_texture(meshes.textures, obj_ids, uvw[..., 0:2])
    shade = torch.clamp(ambient + diffuse * torch.clamp(-n[..., 2], min=0.0), 0.0, 1.0)
    rgb = torch.clamp(albedo * shade[..., None], 0.0, 1.0)
    zero = torch.zeros((), device=rgb.device)
    return torch.where(hit, rgb, zero), torch.where(hit, n, zero), hit[..., 0]


def pixel_tests(meshes: Meshes, obj_ids, T, K, size) -> torch.Tensor:
    """[B] pixel tests of each render: over the faces, the pixels inside
    the image that the face's screen box +-1 px reaches."""
    u, v, iz, valid, attrs = screen_faces(meshes, obj_ids, T, K)
    _, box = affine_rows(u, v, iz, valid, attrs * iz[..., None], size)
    _, nx, _, ny = pixel_ranges(box, size)
    return (nx * ny).sum(-1)
