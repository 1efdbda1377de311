"""Fused z-buffer + attribute interpolation: the wrapper of the hand-written
CUDA kernel `csrc/raster_fused.cu`, and its plain PyTorch version.

Port of `happypose_tpu/ops/rasterizer_pallas.py`. Each face becomes sixteen
rows that are affine functions of the pixel coordinate (`face_affine_rows`):
3 normalized edge functions (coverage), 1/z, six attribute*(1/z) channels
(rgb or uv, camera-frame normal) — perspective-correct interpolation is
`(affine attr*iz) / (affine iz)` — and six constant rows (a = b = 0)
carrying the face's 1/z clamp range and screen bbox. Faces are sorted by
the tile of their bbox centre and packed into 64-face chunks with a chunk
bbox for culling (`pack_faces`).

`raster_fused` sends a CUDA tensor to the kernel and a CPU tensor to
`raster_fused_reference`, which computes the same thing chunk by chunk with
the same tile-local arithmetic, so the two agree exactly. There is no
fallback: a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from happypose_tpu_torch.meshes.database import RenderAssets
from happypose_tpu_torch.ops.rasterizer import (
    FaceData,
    RenderOutput,
    face_screen_data,
    resolve_albedo,
    shade_lambert,
)

CHUNK = 64  # faces per chunk
N_AFF = 10  # w0, w1, w2, iz, (r, g, b, nx, ny, nz) * iz
N_ROWS = 16  # + izmin, izmax, umin, vmin, umax, vmax (a = b = 0 rows)
N_OUT = 7  # iz + 6 attr*iz
# Pixel tile of one kernel block. It is part of the arithmetic (tile-local
# coordinates, chunk culling), so the plain version uses the same tiles.
TILE_H = 8
TILE_W = 32
_MAX_TILES = 2**31 - 1  # (image, tile) pairs per call: the kernels index them with an int
_N_COUNTERS = 68  # int32 words of the kernels' zeroed scratch (raster_fused.cu)

# Kernel launches since the last reset (the CPU path never counts).
launches = 0
# The name of the kernel that one launch runs once (`csrc/raster_fused.cu`),
# by which a device trace counts launches (a CUDA graph's replay runs no
# Python, so it does not add to `launches`).
KERNEL_NAME = "raster_kernel"


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def face_affine_rows(
    u: torch.Tensor,  # [B, F, 3]
    v: torch.Tensor,  # [B, F, 3]
    inv_z: torch.Tensor,  # [B, F, 3]
    valid: torch.Tensor,  # [B, F] bool
    attr_iz: torch.Tensor,  # [B, F, 3, 6] per-vertex attr * inv_z
    resolution: Tuple[int, int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-face packed rows A [B, F, 3 (a, b, c), N_ROWS] and screen bbox
    [B, F, 4] (umin, vmin, umax, vmax; +-1e9 for invalid faces)."""
    H, W = resolution
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
    c0 = torch.where(ok, area * norm - c1 - c2, zero - 1.0)  # invalid: never covered

    # normalized bary coefficients [B, F, 3 (vertex), 3 (a, b, c)]
    bary = torch.stack(
        [
            torch.stack([a0, b0, c0], -1),
            torch.stack([a1, b1, c1], -1),
            torch.stack([a2, b2, c2], -1),
        ],
        dim=-2,
    )
    # iz and attribute channels are linear in bary: coeff = sum_j bary_j*val_j
    vals = torch.cat([inv_z[..., None], attr_iz], dim=-1)  # [B, F, 3, 7]
    chan = (
        bary[..., 0, :, None] * vals[..., 0, None, :]
        + bary[..., 1, :, None] * vals[..., 1, None, :]
        + bary[..., 2, :, None] * vals[..., 2, None, :]
    )  # [B, F, 3 (abc), 7]

    umin = torch.clamp(u.amin(-1), 0.0, W - 1.0)
    umax = torch.clamp(u.amax(-1), 0.0, W - 1.0)
    vmin = torch.clamp(v.amin(-1), 0.0, H - 1.0)
    vmax = torch.clamp(v.amax(-1), 0.0, H - 1.0)
    big = torch.full_like(umin, 1e9)
    bbox = torch.stack(
        [
            torch.where(ok, umin, big),
            torch.where(ok, vmin, big),
            torch.where(ok, umax, -big),
            torch.where(ok, vmax, -big),
        ],
        dim=-1,
    )
    # the constant rows carry the same bbox, so a face that can never be
    # covered (invalid or degenerate) is inside nowhere and reaches no tile
    const_vals = torch.cat(
        [inv_z.amin(-1, keepdim=True), inv_z.amax(-1, keepdim=True), bbox], dim=-1
    )
    zeros = torch.zeros_like(const_vals)
    const_rows = torch.stack([zeros, zeros, const_vals], dim=-2)  # [B, F, 3, 6]
    A = torch.cat([bary.transpose(-1, -2), chan, const_rows], dim=-1)
    return A, bbox


def _sort_key(bbox: torch.Tensor) -> torch.Tensor:
    """Spatial sort key: tile-granular row-major index of the bbox centre."""
    cu = (bbox[..., 0] + bbox[..., 2]) * 0.5
    cv = (bbox[..., 1] + bbox[..., 3]) * 0.5
    ku = torch.clamp(cu / TILE_W, 0, 255).to(torch.int32)
    kv = torch.clamp(cv / TILE_H, 0, 255).to(torch.int32)
    return kv * 256 + ku


def pack_faces(
    u: torch.Tensor,
    v: torch.Tensor,
    inv_z: torch.Tensor,
    valid: torch.Tensor,
    attrs: torch.Tensor,  # [B, F, 3, 6] per-vertex attributes
    resolution: Tuple[int, int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel input: A [B, n_chunks*CHUNK, 3, N_ROWS] (faces spatially
    sorted, padded to whole chunks) and chunk_bbox [B, n_chunks, 4]."""
    B, F = u.shape[:2]
    pad = _cdiv(F, CHUNK) * CHUNK - F
    if pad:
        u = torch.nn.functional.pad(u, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
        inv_z = torch.nn.functional.pad(inv_z, (0, 0, 0, pad), value=1.0)
        valid = torch.nn.functional.pad(valid, (0, pad), value=False)
        attrs = torch.nn.functional.pad(attrs, (0, 0, 0, 0, 0, pad))
    A, bbox = face_affine_rows(
        u, v, inv_z, valid, attrs * inv_z[..., None], resolution
    )
    perm = torch.argsort(_sort_key(bbox), dim=1, stable=True)
    A = torch.gather(A, 1, perm[:, :, None, None].expand_as(A)).contiguous()
    bbox = torch.gather(bbox, 1, perm[:, :, None].expand_as(bbox))
    bb = bbox.reshape(B, -1, CHUNK, 4)
    chunk_bbox = torch.cat([bb[..., :2].amin(2), bb[..., 2:].amax(2)], dim=-1)
    return A, chunk_bbox.contiguous()


def _check_packed(A: torch.Tensor, chunk_bbox: torch.Tensor, resolution) -> None:
    H, W = resolution
    if A.ndim != 4 or A.shape[2:] != (3, N_ROWS) or A.shape[1] % CHUNK:
        raise ValueError(f"A must be [B, n_chunks*{CHUNK}, 3, {N_ROWS}], got {tuple(A.shape)}")
    B, n_chunks = A.shape[0], A.shape[1] // CHUNK
    if tuple(chunk_bbox.shape) != (B, n_chunks, 4):
        raise ValueError(f"chunk_bbox must be [{B}, {n_chunks}, 4], got {tuple(chunk_bbox.shape)}")
    if A.dtype != torch.float32 or chunk_bbox.dtype != torch.float32:
        raise TypeError("A and chunk_bbox must be float32")
    if A.device != chunk_bbox.device:
        raise ValueError("A and chunk_bbox must be on one device")
    if not (A.is_contiguous() and chunk_bbox.is_contiguous()):
        raise ValueError("A and chunk_bbox must be contiguous")
    if H < 1 or W < 1:
        raise ValueError(f"bad resolution {resolution}")
    if B * _cdiv(H, TILE_H) * _cdiv(W, TILE_W) > _MAX_TILES:
        raise ValueError(f"at most {_MAX_TILES} (image, tile) pairs per call")


def _reach(bbox: torch.Tensor, resolution: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Which tile columns [..., n_tw] and tile rows [..., n_th] a screen bbox
    [..., 4] reaches. `inside` accepts a face up to one pixel outside its
    bbox, so the tile test takes the same margin, with the same float32
    operations as the kernel."""
    H, W = resolution
    dev = bbox.device
    tu0 = torch.arange(_cdiv(W, TILE_W), device=dev, dtype=torch.float32) * TILE_W
    tv0 = torch.arange(_cdiv(H, TILE_H), device=dev, dtype=torch.float32) * TILE_H
    umin, vmin, umax, vmax = (x[..., None] for x in bbox.unbind(-1))
    reach_u = (tu0 + (TILE_W - 1) >= umin - 1.0) & (tu0 <= umax + 1.0)
    reach_v = (tv0 + (TILE_H - 1) >= vmin - 1.0) & (tv0 <= vmax + 1.0)
    return reach_u, reach_v


def bin_faces_reference(
    A: torch.Tensor, chunk_bbox: torch.Tensor, resolution: Tuple[int, int]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the binning kernel: per (image, tile) the
    packed indices of the faces whose chunk bbox and own bbox (the face's
    constant rows) reach the tile, margin included. Returns the list
    lengths [B, n_tiles] int32 and the lists themselves, concatenated in
    (image, tile) order, each ascending: [sum of lengths] int32."""
    _check_packed(A, chunk_bbox, resolution)
    counts, lists = [], []
    for b in range(A.shape[0]):
        fu, fv = _reach(A[b, :, 2, N_AFF + 2:], resolution)  # [Fp, n_tw], [Fp, n_th]
        cu, cv = _reach(chunk_bbox[b], resolution)
        fu &= cu.repeat_interleave(CHUNK, dim=0)
        fv &= cv.repeat_interleave(CHUNK, dim=0)
        member = (fv.T[:, None, :] & fu.T[None, :, :]).flatten(0, 1)  # [n_tiles, Fp]
        counts.append(member.sum(-1).to(torch.int32))
        lists.append(member.nonzero()[:, 1].to(torch.int32))
    if not counts:
        n_tiles = _cdiv(resolution[0], TILE_H) * _cdiv(resolution[1], TILE_W)
        return (torch.zeros(0, n_tiles, dtype=torch.int32, device=A.device),
                torch.zeros(0, dtype=torch.int32, device=A.device))
    return torch.stack(counts), torch.cat(lists)


def raster_fused_reference(
    A: torch.Tensor, chunk_bbox: torch.Tensor, resolution: Tuple[int, int]
) -> torch.Tensor:
    """Plain PyTorch version of the kernels, on any device: [B, 7, H, W].

    A pixel tests the faces of its tile's list (`bin_faces_reference`) in
    ascending packed order. Here that runs chunk by chunk over the window
    of tiles the chunk reaches, with list membership as a mask, and with
    the kernel's tile-local arithmetic
    R = (a*pu + b*pv) + ((c + a*tu0) + b*tv0): the chunk's best face (max
    iz, lowest index on ties) replaces the running best only where its iz
    is strictly greater and > 0.
    """
    _check_packed(A, chunk_bbox, resolution)
    H, W = resolution
    B, n_chunks = A.shape[0], A.shape[1] // CHUNK
    dev = A.device
    out = torch.zeros(B, N_OUT, H, W, dtype=torch.float32, device=dev)
    if n_chunks == 0:
        return out

    # the tiles each chunk reaches form one rectangle of whole tiles
    def span(ok):  # first and last reached tile, -1 when none
        n = ok.shape[-1]
        first = ok.int().argmax(-1)
        last = n - 1 - ok.flip(-1).int().argmax(-1)
        none = ~ok.any(-1)
        return first.masked_fill(none, -1), last.masked_fill(none, -1)

    cu, cv = _reach(chunk_bbox, resolution)
    spans = torch.stack([*span(cu), *span(cv)], dim=-1).tolist()
    face_u, face_v = _reach(A[:, :, 2, N_AFF + 2:], resolution)  # [B, Fp, n_tw], [B, Fp, n_th]

    fidx = torch.arange(CHUNK, device=dev)[:, None, None]
    for b in range(B):
        best = out[b, 0]
        acc = out[b, 1:]
        for c in range(n_chunks):
            j0, j1, i0, i1 = spans[b][c]
            if j0 < 0 or i0 < 0:
                continue
            x0, x1 = j0 * TILE_W, min((j1 + 1) * TILE_W, W)
            y0, y1 = i0 * TILE_H, min((i1 + 1) * TILE_H, H)
            gu = torch.arange(x0, x1, device=dev)
            gv = torch.arange(y0, y1, device=dev)
            tj, ti = gu // TILE_W, gv // TILE_H
            tu0, tv0 = (tj * TILE_W).float(), (ti * TILE_H).float()
            pu, pv = (gu.float() - tu0), (gv.float() - tv0)
            gu, gv = gu.float(), gv.float()

            faces = slice(c * CHUNK, (c + 1) * CHUNK)
            Ac = A[b, faces]  # [CHUNK, 3, N_ROWS]
            a, bc, cc = Ac[:, 0], Ac[:, 1], Ac[:, 2]  # [CHUNK, N_ROWS]

            # edge and iz rows at every pixel of the window: [CHUNK, 4, h, w]
            ra, rb, rc = (x[:, :4, None, None] for x in (a, bc, cc))
            R = (ra * pu + rb * pv[:, None]) + ((rc + ra * tu0) + rb * tv0[:, None])
            const = cc[:, N_AFF:, None, None]  # [CHUNK, 6, 1, 1]
            iz = torch.minimum(torch.maximum(R[:, 3], const[:, 0]), const[:, 1])
            cov = (R[:, 0] >= 0) & (R[:, 1] >= 0) & (R[:, 2] >= 0)
            inside = (
                (gu >= const[:, 2] - 1.0)
                & (gu <= const[:, 4] + 1.0)
                & (gv[:, None] >= const[:, 3] - 1.0)
                & (gv[:, None] <= const[:, 5] + 1.0)
            )
            listed = face_v[b, faces][:, ti, None] & face_u[b, faces][:, None, tj]
            cand = torch.where(cov & inside & listed, iz, torch.full_like(iz, -1.0))
            cbest = cand.amax(0)  # [h, w]
            win = torch.where(cand == cbest, fidx, CHUNK).amin(0)  # [h, w]
            # the winner's attribute rows, evaluated pixel by pixel
            aw = a[win, 4:N_AFF].permute(2, 0, 1)  # [6, h, w]
            bw = bc[win, 4:N_AFF].permute(2, 0, 1)
            cw = cc[win, 4:N_AFF].permute(2, 0, 1)
            attr = (aw * pu + bw * pv[:, None]) + ((cw + aw * tu0) + bw * tv0[:, None])

            prev = best[y0:y1, x0:x1]
            better = (cbest > prev) & (cbest > 0)
            best[y0:y1, x0:x1] = torch.where(better, cbest, prev)
            acc[:, y0:y1, x0:x1] = torch.where(better, attr, acc[:, y0:y1, x0:x1])
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a build of `raster_fused.cu`."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.raster_fused_launch.argtypes = [vp] * 4 + [ci] * 6 + [vp]
    lib.raster_fused_launch.restype = ci
    lib.raster_fused_error_string.argtypes = [ci]
    lib.raster_fused_error_string.restype = ctypes.c_char_p
    return lib


def _kernel_library() -> ctypes.CDLL:
    from happypose_tpu_torch.csrc import load_library

    return _bind(load_library("raster_fused"))


def _launch(A, chunk_bbox, resolution, out, pool_capacity):
    """Allocate the kernels' scratch and enqueue them on the current stream:
    the binning kernel alone when `out` is None, else all three. Returns
    (tile_meta [B * n_tiles, 4] int32: list length, offset into the pool or
    -1 where the pool was full, queue bucket, place in the bucket;
    pool int32), views of the scratch."""
    H, W = resolution
    B, Fp = A.shape[:2]
    n_items = B * _cdiv(H, TILE_H) * _cdiv(W, TILE_W)
    if A.data_ptr() % 16 or chunk_bbox.data_ptr() % 16:
        raise ValueError("A and chunk_bbox must be 16-byte aligned")
    if pool_capacity is None:
        pool_capacity = min(2 * B * Fp + 16 * n_items, 2**31 - 1)
    # counters, tile_meta, queue, pool: the layout of raster_fused_launch
    scratch = torch.empty(
        _N_COUNTERS + 5 * n_items + pool_capacity, dtype=torch.int32, device=A.device
    )
    lib = _kernel_library()
    err = lib.raster_fused_launch(
        A.data_ptr(), chunk_bbox.data_ptr(), None if out is None else out.data_ptr(),
        scratch.data_ptr(), B, Fp // CHUNK, H, W, pool_capacity, A.device.index,
        torch.cuda.current_stream(A.device).cuda_stream,
    )
    if err != 0:
        msg = lib.raster_fused_error_string(err).decode()
        raise RuntimeError(f"raster_fused kernel launch failed: {msg} ({err})")
    tile_meta = scratch[_N_COUNTERS:_N_COUNTERS + 4 * n_items].view(n_items, 4)
    return tile_meta, scratch[_N_COUNTERS + 5 * n_items:]


def bin_faces(
    A: torch.Tensor, chunk_bbox: torch.Tensor, resolution: Tuple[int, int]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-tile face lists in the form of `bin_faces_reference`: from
    the binning kernel for CUDA tensors (a check, not part of a render: it
    synchronizes), from the plain version for CPU tensors."""
    _check_packed(A, chunk_bbox, resolution)
    if A.device.type == "cpu":
        return bin_faces_reference(A, chunk_bbox, resolution)
    if A.device.type != "cuda":
        raise ValueError(f"bin_faces runs on CUDA or CPU tensors, not {A.device}")
    B = A.shape[0]
    if B == 0:
        return bin_faces_reference(A, chunk_bbox, resolution)
    tile_meta, pool = _launch(A, chunk_bbox, resolution, None, None)
    count, offset = tile_meta[:, 0].long(), tile_meta[:, 1].long()
    if bool(((count > 0) & (offset < 0)).any()):
        raise RuntimeError("bin_faces: the face lists did not fit the pool")
    first = torch.cumsum(count, 0) - count  # where each list starts in the result
    within = torch.arange(int(count.sum()), device=A.device) - first.repeat_interleave(count)
    return count.reshape(B, -1).to(torch.int32), pool[offset.repeat_interleave(count) + within]


def raster_fused(
    A: torch.Tensor,
    chunk_bbox: torch.Tensor,
    resolution: Tuple[int, int],
    pool_capacity: Optional[int] = None,
) -> torch.Tensor:
    """[B, 7, H, W] (iz, attr*iz) of packed faces: the CUDA kernels for CUDA
    tensors, `raster_fused_reference` for CPU tensors. `pool_capacity`
    (entries of all face lists together; default: room for twice the faces
    plus 16 entries a tile) only moves tiles between the listed and the
    unlisted path of the kernel; the result does not depend on it."""
    global launches
    _check_packed(A, chunk_bbox, resolution)
    if A.device.type == "cpu":
        return raster_fused_reference(A, chunk_bbox, resolution)
    if A.device.type != "cuda":
        raise ValueError(f"raster_fused runs on CUDA or CPU tensors, not {A.device}")
    H, W = resolution
    out = torch.empty(A.shape[0], N_OUT, H, W, dtype=torch.float32, device=A.device)
    if A.shape[0] == 0:
        return out
    _launch(A, chunk_bbox, resolution, out, pool_capacity)
    launches += 1
    return out


def rasterize(
    u: torch.Tensor,
    v: torch.Tensor,
    inv_z: torch.Tensor,
    valid: torch.Tensor,
    attrs: torch.Tensor,
    resolution: Tuple[int, int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Counterpart of `raster_fused_pallas`: (iz [B, H, W], attr [B, 6, H, W])
    with attr already divided by iz (0 on background)."""
    A, chunk_bbox = pack_faces(u, v, inv_z, valid, attrs, resolution)
    x = raster_fused(A, chunk_bbox, resolution)
    iz = x[:, 0]
    z = torch.where(iz > 0, 1.0 / torch.clamp(iz, min=1e-12), torch.zeros_like(iz))
    return iz, x[:, 1:N_OUT] * z[:, None]


def face_inputs(
    inst: RenderAssets,  # per instance (`RenderAssets.select`)
    TCO: torch.Tensor,  # [B, 4, 4]
    K: torch.Tensor,  # [B, 3, 3]
) -> Tuple[FaceData, torch.Tensor]:
    """Screen-space faces of B instances and their per-vertex attributes
    [B, F, 3, 6]: color channels + camera-frame normals. Textured instances
    carry (u, v, 0) in the color channels, resolved to texture RGB after
    the kernel."""
    fd = face_screen_data(inst.vertices, inst.faces, inst.faces_mask, TCO, K)
    uv0 = torch.cat([inst.vertex_uv, torch.zeros_like(inst.vertex_uv[..., :1])], -1)
    attr_c = torch.where(inst.has_texture[:, None, None], uv0, inst.vertex_colors)
    n_cam = inst.vertex_normals @ TCO[:, :3, :3].transpose(1, 2)
    av = torch.cat([attr_c, n_cam], dim=-1)  # [B, V, 6]
    faces = inst.faces
    attrs = torch.gather(
        av, 1, faces.reshape(faces.shape[0], -1, 1).expand(-1, -1, 6)
    ).reshape(*faces.shape, 6)
    return fd, attrs


def render_batch_fused(
    assets: RenderAssets,
    obj_ids: torch.Tensor,  # [B]
    TCO: torch.Tensor,  # [B, 4, 4]
    K: torch.Tensor,  # [B, 3, 3]
    resolution: Tuple[int, int] = (240, 320),
    light_ambient: float = 0.6,
    light_diffuse: float = 0.6,
    lights: Optional[torch.Tensor] = None,  # [B, 5], see `shade_lambert`
) -> RenderOutput:
    """Render B object instances, one per image (counterpart of
    `render_batch_pallas`). `assets` is the whole database, or this rank's
    object block (`parallel.mesh.shard_objects`), whose `select` gathers the
    instances' rows, textures included, from their owners."""
    inst = assets.select(obj_ids)
    # a whole database samples its textures by object id; a sharded one's
    # select hands back each instance's texture
    textures, tex_ids = ((assets.textures, obj_ids) if isinstance(assets, RenderAssets)
                         else (inst.textures, torch.arange(len(obj_ids), device=obj_ids.device)))
    fd, attrs = face_inputs(inst, TCO, K)
    iz, attr = rasterize(fd.u, fd.v, fd.inv_z, fd.valid, attrs, resolution)

    hit = iz > 0
    depth = torch.where(hit, 1.0 / torch.clamp(iz, min=1e-12), torch.zeros_like(iz))
    rgb = attr[:, 0:3].permute(0, 2, 3, 1)  # [B, H, W, 3]
    n = attr[:, 3:6].permute(0, 2, 3, 1)
    n = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=1e-8)
    n = torch.where(n[..., 2:3] > 0, -n, n)
    albedo = resolve_albedo(rgb, textures, tex_ids, inst.has_texture)
    rgb = shade_lambert(albedo, n, light_ambient, light_diffuse, lights)
    hit_f = hit[..., None]
    return RenderOutput(
        rgb=torch.where(hit_f, rgb, torch.zeros_like(rgb)),
        depth=depth,
        mask=hit,
        normals=torch.where(hit_f, n, torch.zeros_like(n)),
    )
