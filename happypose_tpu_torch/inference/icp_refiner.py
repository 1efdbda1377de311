"""Depth-based ICP pose refinement (PyTorch port of
`happypose_tpu/inference/icp_refiner.py`).

Render depth at the predicted pose, back-project the rendered and the
observed depth to fixed-count point sets (masked), take the observed
cloud's normals from depth-image gradients, and run point-to-plane ICP:
dense nearest-neighbour correspondences (masked [N, M] distances) and one
6x6 solve of the normal equations per iteration, for a fixed iteration
count. Every function takes leading batch axes (`...`), so all instances
run as one batch; `torch.linalg.solve_ex` is batched over them and, as
`jnp.linalg.solve`, never raises (it checks no error on the host, so a
CUDA graph can capture it).

Where the JAX version takes `jax.random` keys, this one takes a
`torch.Generator`; where it uses `lax.top_k` (lowest index among equal
scores), this one uses a stable descending sort. Without a generator a
refiner draws from `default_generator` (seed 0) afresh on every call; it
keeps those draws by shape (`SeededDraws`), so such a call draws nothing
on the device and a CUDA graph can capture it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from happypose_tpu_torch.lib3d.rotations import axis_angle_to_rotmat
from happypose_tpu_torch.lib3d.transforms import make_T


def backproject_depth(
    depth: torch.Tensor,  # [..., H, W]
    K: torch.Tensor,  # [..., 3, 3]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depth map -> camera-frame points [..., H*W, 3] + validity [..., H*W]."""
    H, W = depth.shape[-2:]
    u = torch.arange(W, dtype=depth.dtype, device=depth.device)
    v = torch.arange(H, dtype=depth.dtype, device=depth.device)[:, None]
    fx, fy, cx, cy = (K[..., i, j, None, None] for i, j in ((0, 0), (1, 1), (0, 2), (1, 2)))
    x = (u - cx) / fx * depth
    y = (v - cy) / fy * depth
    pts = torch.stack([x, y, depth], dim=-1).flatten(-3, -2)
    return pts, depth.flatten(-2) > 0


def depth_normals(depth: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Camera-frame normals from depth-image gradients, [..., H, W, 3],
    oriented toward the camera. The central differences wrap around the
    image border (as the JAX version's `jnp.roll`), so border normals mix
    opposite edges."""
    H, W = depth.shape[-2:]
    pts, _ = backproject_depth(depth, K)
    P = pts.unflatten(-2, (H, W))
    dx = torch.roll(P, -1, dims=-2) - torch.roll(P, 1, dims=-2)
    dy = torch.roll(P, -1, dims=-3) - torch.roll(P, 1, dims=-3)
    n = torch.linalg.cross(dx, dy)
    n = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=1e-9)
    return torch.where(n[..., 2:3] > 0, -n, n)


def default_generator(device) -> torch.Generator:
    """The refiners' default source of randomness: seed 0 on `device`."""
    return torch.Generator(device=device).manual_seed(0)


class SeededDraws:
    """U[0, 1) draws of a generator on the device of `like`, one of each
    shape in turn. Without a generator, those of a fresh
    `default_generator`, kept by (shapes, device): the same numbers as
    drawing them anew, and no draw on the device after the first call of
    those shapes."""

    def __init__(self):
        self._kept = {}

    def __call__(self, generator: Optional[torch.Generator], shapes, like: torch.Tensor):
        if generator is not None:
            return [torch.rand(s, generator=generator, device=like.device) for s in shapes]
        key = (tuple(tuple(s) for s in shapes), like.device)
        if key not in self._kept:
            self._kept[key] = self(default_generator(like.device), shapes, like)
        return self._kept[key]


def _subsample_idx(valid: torch.Tensor, n: int, uniform: torch.Tensor) -> torch.Tensor:
    """Indices [..., n] of n points, valid ones first in random order
    (a valid point scores 1 + U[0, 0.5), an invalid one U[0, 0.5));
    `uniform` holds U[0, 1) draws of `valid`'s shape."""
    score = valid.to(torch.float32) + uniform * 0.5
    return torch.sort(score, dim=-1, descending=True, stable=True).indices[..., :n]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [..., N] or [..., N, C], idx [..., n] -> the picked rows."""
    if x.ndim == idx.ndim:
        return torch.gather(x, -1, idx)
    return torch.gather(x, -2, idx[..., None].expand(*idx.shape, x.shape[-1]))


def _subsample(pts, valid, n: int, uniform: torch.Tensor):
    """Pick n points, biased to valid ones (invalid ones stay masked)."""
    idx = _subsample_idx(valid, n, uniform)
    return _take(pts, idx), _take(valid, idx)


def icp_point_to_plane(
    src_pts: torch.Tensor,  # [..., N, 3] rendered cloud (model at predicted pose)
    src_valid: torch.Tensor,  # [..., N]
    tgt_pts: torch.Tensor,  # [..., M, 3] observed cloud
    tgt_normals: torch.Tensor,  # [..., M, 3]
    tgt_valid: torch.Tensor,  # [..., M]
    max_corr_dist: float = 0.02,
    n_iterations: int = 10,
) -> torch.Tensor:
    """Returns dT [..., 4, 4] aligning src -> tgt (apply as dT @ TCO): of
    the iterates, the one with the lowest mean point-to-plane residual (flat
    geometry lets ICP slide after convergence)."""
    dtype, dev = src_pts.dtype, src_pts.device
    pair_valid = src_valid[..., :, None] & tgt_valid[..., None, :]

    def residual_and_corr(T):
        R, t = T[..., :3, :3], T[..., :3, 3]
        src = src_pts @ R.transpose(-1, -2) + t[..., None, :]
        d2 = ((src[..., :, None, :] - tgt_pts[..., None, :, :]) ** 2).sum(dim=-1)
        d2 = d2.masked_fill(~pair_valid, torch.inf)
        nn_d2, nn = d2.min(dim=-1)  # the first minimum, as jnp.argmin
        w = (src_valid & (torch.sqrt(nn_d2) < max_corr_dist)).to(dtype)
        q = _take(tgt_pts, nn)
        n = _take(tgt_normals, nn)
        plane = (n * (src - q)).sum(dim=-1)
        res = (w * plane.abs()).sum(dim=-1) / torch.clamp(w.sum(dim=-1), min=1.0)
        return src, n, w, plane, res

    batch = src_pts.shape[:-2]
    T = torch.eye(4, dtype=dtype, device=dev).expand(*batch, 4, 4)
    best_T = T
    best_res = torch.full(batch, torch.inf, dtype=dtype, device=dev)
    ridge = 1e-6 * torch.eye(6, dtype=dtype, device=dev)
    for _ in range(n_iterations):
        src, n, w, plane, _ = residual_and_corr(T)
        # point-to-plane linearization: find (w, v) minimizing
        # sum ((p x n) . w + n . v + n . (p - q))^2
        A = torch.cat([torch.linalg.cross(src, n), n], dim=-1)  # [..., N, 6]
        Aw = A * w[..., None]
        H6 = Aw.transpose(-1, -2) @ A + ridge
        g = (Aw.transpose(-1, -2) @ -plane[..., None])[..., 0]
        x = torch.linalg.solve_ex(H6, g, check_errors=False).result
        T = make_T(axis_angle_to_rotmat(x[..., :3]), x[..., 3:6]) @ T
        res_new = residual_and_corr(T)[-1]
        better = res_new < best_res
        best_T = torch.where(better[..., None, None], T, best_T)
        best_res = torch.minimum(res_new, best_res)
    return best_T


class ICPRefiner:
    """Refine poses with observed depth (the `run_depth_refiner` stage).

    `renderer_fn(assets, obj_ids, TCO, K, resolution=...)` returns an object
    with `.depth` [B, H, W]: `render_batch_fused` in the pipelines, the
    two-pass `render_batch` where a test wants the independent renderer.
    """

    def __init__(self, assets, renderer_fn, resolution=(120, 160),
                 n_points: int = 512, n_iterations: int = 10,
                 max_corr_dist: float = 0.02):
        self.assets = assets
        self.renderer_fn = renderer_fn
        self.resolution = resolution
        self.n_points = n_points
        self.n_iterations = n_iterations
        self.max_corr_dist = max_corr_dist
        self._draws = SeededDraws()

    @torch.inference_mode()
    def refine(
        self,
        obj_ids: torch.Tensor,  # [B]
        TCO: torch.Tensor,  # [B, 4, 4]
        K: torch.Tensor,  # [B, 3, 3] (intrinsics scaled to the depth map)
        depth_obs: torch.Tensor,  # [B, H, W] observed depth (meters)
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Returns refined TCO [B, 4, 4]; an instance whose render has 32
        valid points or fewer keeps its pose."""
        render = self.renderer_fn(self.assets, obj_ids, TCO, K, resolution=self.resolution)
        src_all, src_v = backproject_depth(render.depth, K)
        tgt_all, tgt_v = backproject_depth(depth_obs, K)
        nrm = depth_normals(depth_obs, K).flatten(-3, -2)
        u_src, u_tgt = self._draws(generator, (src_v.shape, tgt_v.shape), TCO)
        src, sv = _subsample(src_all, src_v, self.n_points, u_src)
        ti = _subsample_idx(tgt_v, self.n_points, u_tgt)
        dT = icp_point_to_plane(
            src, sv, _take(tgt_all, ti), _take(nrm, ti), _take(tgt_v, ti),
            max_corr_dist=self.max_corr_dist, n_iterations=self.n_iterations,
        )
        ok = sv.sum(dim=-1) > 32
        return torch.where(ok[:, None, None], dT @ TCO, TCO)
