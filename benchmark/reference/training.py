"""The refiner's training step in plain PyTorch (MegaPose's refiner loss,
CosyPose's disentangled point-matching L1 anchored at the reference
point): the synthetic batch, the noised input poses, three iterations in
train mode, the loss averaged over them, the gradient, optax's global-norm
clip and Adam at a linearly warmed-up rate.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from benchmark.reference import geometry as G
from benchmark.reference import megapose as ref
from benchmark.reference import raster

NOISE = 0.02  # the synthetic images' pixel noise


def euler_sxyz(e: torch.Tensor) -> torch.Tensor:
    """Static-axis XYZ euler angles [B, 3] -> Rz(c) Ry(b) Rx(a)."""
    a, b, c = e.unbind(-1)
    ca, sa, cb, sb, cc, sc = a.cos(), a.sin(), b.cos(), b.sin(), c.cos(), c.sin()
    return torch.stack([cb * cc, sa * sb * cc - ca * sc, ca * sb * cc + sa * sc,
                        cb * sc, sa * sb * sc + ca * cc, ca * sb * sc - sa * cc,
                        -sb, sa * cb, ca * cb], -1).reshape(*e.shape[:-1], 3, 3)


def synth_images(meshes: raster.Meshes, K1, draws) -> torch.Tensor:
    """The drawn objects rendered at the background's size over the
    background smoothed to 1/8 and back (antialiased bilinear down,
    bilinear up), plus the pixel noise: [B, 3, H, W] in [0, 1]."""
    B, H, W, _ = draws["bg"].shape
    T = G.make_T(draws["R"], torch.cat([draws["xy"], draws["z"]], dim=-1))
    rgb, _, hit = raster.render(meshes, draws["obj_ids"], T, K1.expand(B, 3, 3), (H, W))
    bg = F.interpolate(draws["bg"].permute(0, 3, 1, 2), size=(H // 8, W // 8), mode="bilinear",
                       antialias=True, align_corners=False)
    bg = F.interpolate(bg, size=(H, W), mode="bilinear", align_corners=False)
    img = torch.where(hit[:, None], rgb.permute(0, 3, 1, 2), bg)
    return torch.clamp(img + NOISE * draws["noise"].permute(0, 3, 1, 2), 0.0, 1.0), T


def _points_l1(T_gt, T, pts):
    """Mean over the points of the L1 distance of their two placements."""
    a = torch.einsum("bij,bpj->bpi", T[:, :3, :3], pts) + T[:, None, :3, 3]
    b = torch.einsum("bij,bpj->bpi", T_gt[:, :3, :3], pts) + T_gt[:, None, :3, 3]
    return (a - b).abs().sum(dim=(-1, -2)) / pts.shape[1]


def disentangled_loss(T_gt, T_in, raw, K_crop, pts, tCR) -> torch.Tensor:
    """[B]: three poses, each the ground truth with one block from the
    network's update (rotation; image-plane xy; depth), each scored by
    the points' L1, summed."""
    dR = G.rotation_from_6d(raw[:, 0:6])
    f = torch.stack([K_crop[:, 0, 0], K_crop[:, 1, 1]], dim=-1)
    dR_gt = T_gt[:, :3, :3] @ T_in[:, :3, :3].transpose(-1, -2)
    tCR_gt = T_gt[:, :3, 3] - (dR_gt @ (T_in[:, :3, 3] - tCR)[..., None])[..., 0]
    vz_gt = tCR_gt[:, 2:3] / tCR[:, 2:3]
    vxvy_gt = f * (tCR_gt[:, 0:2] / tCR_gt[:, 2:3] - tCR[:, 0:2] / tCR[:, 2:3])
    total = 0.0
    for v, R, rows, cols in ((torch.cat([vxvy_gt, vz_gt], -1), dR, slice(0, 3), slice(0, 3)),
                             (torch.cat([raw[:, 6:8], vz_gt], -1), dR_gt, slice(0, 2), slice(3, 4)),
                             (torch.cat([vxvy_gt, raw[:, 8:9]], -1), dR_gt, slice(2, 3), slice(3, 4))):
        upd = G.update_pose(T_in, K_crop, v, R, tCR)
        mask = torch.zeros(4, 4, dtype=torch.bool, device=upd.device)
        mask[rows, cols] = True
        total = total + _points_l1(T_gt, torch.where(mask, upd, T_gt), pts)
    return total


def step_loss(P, images, K, obj_ids, T_gt, T_in, meshes, points, points_mask, size,
              n_iterations, tf32=False, rows=None):
    """The loss of one batch: `n_iterations` train-mode iterations, each
    from the last one's output (detached), the batch-mean loss averaged
    over them; `rows`: the mean over the first `rows` samples only."""
    total = 0.0
    T = T_in
    with ref.precision(tf32, T_in.device):
        for _ in range(n_iterations):
            with torch.no_grad():
                x, T0, K_crop, tCR = ref.network_input(images, K, meshes, points, points_mask,
                                                       obj_ids, T, size, tf32=tf32)
            raw, T_out = ref.refine_outputs(P, x, T0, K_crop, tCR, tf32, train=True)
            loss = disentangled_loss(T_gt, T0, raw, K_crop, points[obj_ids], tCR)
            total = total + loss[:rows].mean()
            T = T_out.detach()
    return total / n_iterations


class Adam:
    """optax's Adam behind `clip_by_global_norm`, at the rate
    lr * min((count + 1) / warmup, 1)."""

    def __init__(self, params: List[torch.Tensor], lr: float, warmup: int, clip: float,
                 b1=0.9, b2=0.999, eps=1e-8):
        self.params, self.lr, self.warmup, self.clip = params, lr, warmup, clip
        self.b1, self.b2, self.eps, self.count = b1, b2, eps, 0
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Apply one update; returns the clipped gradients."""
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        scale = self.clip / torch.clamp(norm, min=self.clip)
        grads = [g * scale for g in grads]
        lr = self.lr * min((self.count + 1) / max(self.warmup, 1), 1.0)
        t = self.count + 1
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(lr * (m / (1 - self.b1 ** t)) / ((v / (1 - self.b2 ** t)).sqrt() + self.eps))
        self.count += 1
        return grads


def trainable(P: Dict[str, torch.Tensor]) -> List[str]:
    """The names the optimizer updates: all but the batch norms' statistics."""
    return [k for k in P if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))]
