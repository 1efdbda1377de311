"""Robust correspondence-based depth refinement, GNC-TLS (PyTorch port of
`happypose_tpu/inference/teaser_refiner.py`).

Render depth at the predicted pose, take same-pixel 3D-3D correspondences
between the rendered and the observed depth images, downsample them
(farthest-point or random), solve a robust registration by graduated
non-convexity over a truncated-least-squares cost (Yang et al., "Graduated
Non-Convexity for Robust Spatial Perception"): each GNC step is a weighted
Procrustes solve, batched over instances. Where JAX takes a 3x3 SVD, the
port solves the 3x3 problem in plain tensor operations (`_kabsch`: Horn's
quaternion method in float64, no host read, so that a CUDA graph can
capture the refiner). The update is accepted only when enough inliers
survive. Every function takes leading batch axes (`...`);
`torch.Generator`s take the place of `jax.random` keys.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from happypose_tpu_torch.inference.icp_refiner import (
    SeededDraws,
    _subsample_idx,
    _take,
    backproject_depth,
)
from happypose_tpu_torch.lib3d.rotations import quat_to_rotmat
from happypose_tpu_torch.lib3d.transforms import make_T

SQUARINGS = 32  # `_kabsch`'s power iteration: converged for relative gaps down to ~1e-8


def _kabsch(H: torch.Tensor) -> torch.Tensor:
    """The rotation R [..., 3, 3] of Kabsch's solution for the covariance
    H [..., 3, 3] (`U, S, Vt = svd(H)`, R = V diag(1, 1, det(V U^T)) U^T),
    without an SVD: Horn's quaternion method, in float64. R is the rotation
    of the top eigenvector of Horn's symmetric 4x4 matrix N; it is found
    by `SQUARINGS` squarings of N / |N| + I (positive semi-definite, each
    squaring scaled to trace 1), whose columns then all point along it.
    Plain operations with no convergence test read back, so a CUDA graph
    captures it. H = 0 (every weight 0) gives the identity, as
    `torch.linalg.svd`'s U = V = I does."""
    Hd = H.double()
    # Horn's matrix, S_ab = H[a, b]
    (xx, xy, xz), (yx, yy, yz), (zx, zy, zz) = (row.unbind(-1) for row in Hd.unbind(-2))
    N = torch.stack([
        xx + yy + zz, yz - zy, zx - xz, xy - yx,
        yz - zy, xx - yy - zz, xy + yx, zx + xz,
        zx - xz, xy + yx, yy - xx - zz, yz + zy,
        xy - yx, zx + xz, yz + zy, zz - xx - yy,
    ], dim=-1).reshape(*H.shape[:-2], 4, 4)
    scale = torch.linalg.vector_norm(N, dim=(-2, -1))[..., None, None]
    A = N / torch.clamp(scale, min=1e-300) + torch.eye(4, dtype=Hd.dtype, device=H.device)
    for _ in range(SQUARINGS):
        A = A @ A
        A = A / A.diagonal(dim1=-2, dim2=-1).sum(-1)[..., None, None]
    col = A.diagonal(dim1=-2, dim2=-1).argmax(-1)
    q = torch.gather(A, -1, col[..., None, None].expand(*A.shape[:-1], 1))[..., 0]
    return quat_to_rotmat(torch.cat([q[..., 1:], q[..., :1]], dim=-1)).to(H.dtype)  # (w, x, y, z) -> xyzw


def weighted_procrustes(
    src: torch.Tensor,  # [..., N, 3]
    dst: torch.Tensor,  # [..., N, 3]
    w: torch.Tensor,  # [..., N] non-negative
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-form weighted rigid alignment src -> dst (Kabsch, `_kabsch`):
    (R [..., 3, 3], t [..., 3])."""
    wc = w[..., None]
    wsum = torch.clamp(w.sum(dim=-1), min=1e-9)[..., None]
    p_bar = (wc * src).sum(dim=-2) / wsum
    q_bar = (wc * dst).sum(dim=-2) / wsum
    P = src - p_bar[..., None, :]
    Q = dst - q_bar[..., None, :]
    R = _kabsch((wc * P).transpose(-1, -2) @ Q)
    t = q_bar - (R @ p_bar[..., None])[..., 0]
    return R, t


def gnc_tls_registration(
    src: torch.Tensor,  # [..., N, 3]
    dst: torch.Tensor,  # [..., N, 3]
    valid: torch.Tensor,  # [..., N] bool
    noise_bound: float = 0.01,
    gnc_factor: float = 1.4,
    n_iterations: int = 50,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """GNC-TLS rigid registration of correspondences src[i] <-> dst[i].
    Returns (T [..., 4, 4] aligning src -> dst, n_inliers [...]): an inlier
    is a valid pair whose residual after alignment is below `noise_bound`."""
    c2 = noise_bound ** 2
    vf = valid.to(src.dtype)

    def residuals2(R, t):
        return ((src @ R.transpose(-1, -2) + t[..., None, :] - dst) ** 2).sum(dim=-1)

    # initial fit with all valid points; mu from the largest residual
    R, t = weighted_procrustes(src, dst, vf)
    r2 = torch.where(valid, residuals2(R, t), torch.zeros_like(vf))
    r2_max = torch.clamp(r2.amax(dim=-1), min=c2 * (1.0 + 1e-3))
    mu = (c2 / (2.0 * r2_max - c2))[..., None]
    for _ in range(n_iterations):
        r2 = residuals2(R, t)
        # TLS surrogate weights for the current mu
        lo = mu / (mu + 1.0) * c2
        hi = (mu + 1.0) / mu * c2
        w_mid = torch.sqrt(c2 * mu * (mu + 1.0) / torch.clamp(r2, min=1e-18)) - mu
        w = torch.where(r2 <= lo, torch.ones_like(r2),
                        torch.where(r2 >= hi, torch.zeros_like(r2), w_mid))
        R, t = weighted_procrustes(src, dst, torch.clamp(w, 0.0, 1.0) * vf)
        mu = mu * gnc_factor
    n_inliers = (valid & (residuals2(R, t) < c2)).sum(dim=-1)
    return make_T(R, t), n_inliers


def farthest_point_sample(
    pts: torch.Tensor,  # [..., N, 3]
    valid: torch.Tensor,  # [..., N]
    n: int,
    generator: torch.Generator,
) -> torch.Tensor:
    """Indices [..., n] of n farthest-point samples among the valid points,
    O(n N), starting from a random valid point."""
    noise = torch.rand(valid.shape, generator=generator, device=valid.device)
    return _farthest_point_from(pts, valid, n, noise)


def _farthest_point_from(pts, valid, n: int, uniform: torch.Tensor) -> torch.Tensor:
    """`farthest_point_sample` with its U[0, 1) draw `uniform` given."""
    return _farthest_point_scan(pts, valid, n, (uniform + valid.to(pts.dtype)).argmax(dim=-1))


def _farthest_point_scan(pts, valid, n: int, start: torch.Tensor) -> torch.Tensor:
    """The farthest-point scan from the sample `start` [...]. Invalid points
    carry a -inf penalty; distances are finite after the first step, so no
    inf - inf arises. Once the valid points are used up the scan repeats the
    first of them (their distances are all 0 and `argmax` returns the first
    maximum, as `jnp.argmax`)."""
    invalid_pen = torch.zeros_like(pts[..., 0]).masked_fill(~valid, -torch.inf)
    mind = torch.full_like(pts[..., 0], torch.inf)
    last = start
    idx = []
    for _ in range(n):
        idx.append(last)
        d = ((pts - _take(pts, last[..., None])) ** 2).sum(dim=-1)
        mind = torch.minimum(mind, d)
        last = (mind + invalid_pen).argmax(dim=-1)
    return torch.stack(idx, dim=-1)


class TeaserRefiner:
    """Drop-in alternative to `ICPRefiner` for `run_depth_refiner`
    (`InferenceConfig.depth_refiner = "teaserpp"`); `renderer_fn` as there.
    `n_outer_iterations` > 1 re-renders at the refined pose and solves
    again, which removes the residual that same-pixel correspondences
    leave on curved geometry."""

    def __init__(
        self,
        assets,
        renderer_fn,
        resolution=(120, 160),
        n_points: int = 512,
        n_min_points: int = 100,
        noise_bound: float = 0.01,
        min_num_inliers: int = 50,
        n_iterations: int = 50,
        n_outer_iterations: int = 1,
        use_farthest_point_sampling: bool = True,
    ):
        self.assets = assets
        self.renderer_fn = renderer_fn
        self.resolution = resolution
        self.n_points = n_points
        self.n_min_points = n_min_points
        self.noise_bound = noise_bound
        self.min_num_inliers = min_num_inliers
        self.n_iterations = n_iterations
        self.n_outer_iterations = n_outer_iterations
        self.use_fps = use_farthest_point_sampling
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
        """Returns refined TCO [B, 4, 4]; an instance with fewer than
        `n_min_points` correspondences or `min_num_inliers` inliers keeps
        its pose."""
        tgt_all, tgt_v = backproject_depth(depth_obs, K)
        # one draw of the correspondences' shape an outer iteration
        draws = self._draws(generator, [tgt_v.shape] * self.n_outer_iterations, TCO)
        for uniform in draws:
            render = self.renderer_fn(self.assets, obj_ids, TCO, K, resolution=self.resolution)
            src_all, src_v = backproject_depth(render.depth, K)
            corr_v = src_v & tgt_v  # same-pixel correspondences
            if self.use_fps:
                idx = _farthest_point_from(src_all, corr_v, self.n_points, uniform)
            else:
                idx = _subsample_idx(corr_v, self.n_points, uniform)
            dT, n_inl = gnc_tls_registration(
                _take(src_all, idx), _take(tgt_all, idx), _take(corr_v, idx),
                noise_bound=self.noise_bound, n_iterations=self.n_iterations,
            )
            ok = (corr_v.sum(dim=-1) >= self.n_min_points) & (n_inl >= self.min_num_inliers)
            TCO = torch.where(ok[:, None, None], dT @ TCO, TCO)
        return TCO
