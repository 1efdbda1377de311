"""BOP19 pose errors (VSD / MSSD / MSPD) and their recalls (PyTorch port of
`happypose_tpu/evaluation/bop19.py`).

- **MSSD**: maximum symmetry-aware surface distance,
  ``min_sym max_pt || T_est x - T_gt S x ||``.
- **MSPD**: maximum symmetry-aware projection distance (2D, pixels).
- **VSD**: visible surface discrepancy. Depth maps of the object at the
  estimated and the GT pose are rendered by `render_batch_fused` (the
  hand-written CUDA rasterizer for CUDA tensors, two launches per scored
  image), visibility masks are estimated against the observed test depth
  (BOP19 ``visib_mode``), and the step-cost discrepancy is averaged over
  the visibility union for a range of misalignment tolerances tau.

Scoring follows the BOP19 protocol: per-(tau, theta) greedy score-ordered
matching of estimates to GT instances, recall over the GT with
``visib_fract >= 0.1``, ``AR = (AR_VSD + AR_MSSD + AR_MSPD) / 3``. All
pairwise errors of one image are computed in one batch on the device of the
mesh database; the greedy matching runs on the host with numpy.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from happypose_tpu_torch.lib3d.transforms import transform_pts
from happypose_tpu_torch.meshes.database import BatchedMeshes, RenderAssets
from happypose_tpu_torch.ops.rasterizer_fused import render_batch_fused

# BOP19 constants (the bop_toolkit configuration)
VSD_DELTA = 0.015  # visibility tolerance [m]
VSD_TAUS = tuple(np.arange(0.05, 0.51, 0.05))  # relative to the diameter
CORRECTNESS_THS = tuple(np.arange(0.05, 0.51, 0.05))  # theta for VSD + MSSD (x d)
MSPD_THS = tuple(np.arange(5.0, 51.0, 5.0))  # theta for MSPD (x r, r = w / 640)
VISIB_GT_MIN = 0.1


@torch.inference_mode()
def mssd_mspd_batch(
    TCO_pred: torch.Tensor,  # [N, 4, 4]
    TCO_gt: torch.Tensor,  # [N, 4, 4]
    K: torch.Tensor,  # [N, 3, 3]
    points: torch.Tensor,  # [N, P, 3]
    points_mask: torch.Tensor,  # [N, P]
    symmetries: torch.Tensor,  # [N, S, 4, 4]
    sym_mask: torch.Tensor,  # [N, S]
) -> Dict[str, torch.Tensor]:
    """"mssd" [m] and "mspd" [px], each [N], of N (estimate, GT) pairs."""
    TCO_gt_sym = torch.einsum("nij,nsjk->nsik", TCO_gt, symmetries)
    gt_pts = transform_pts(TCO_gt_sym, points)  # [N, S, P, 3]
    pred_pts = transform_pts(TCO_pred, points)  # [N, P, 3]
    pm = points_mask[:, None, :]

    def min_sym_max_pt(a, b):  # [N, S, P, C], [N, P, C] -> [N]
        d = torch.linalg.vector_norm(a - b[:, None], dim=-1)
        per_sym = d.masked_fill(~pm, 0.0).amax(dim=-1)
        return per_sym.masked_fill(~sym_mask, torch.inf).amin(dim=-1)

    def pinhole(cam_pts):  # camera-frame [N, ..., 3] -> pixels [N, ..., 2]
        suv = torch.einsum("nij,n...j->n...i", K, cam_pts)
        return suv[..., :2] / torch.clamp(suv[..., 2:3], min=1e-6)

    return {
        "mssd": min_sym_max_pt(gt_pts, pred_pts),
        "mspd": min_sym_max_pt(pinhole(gt_pts), pinhole(pred_pts)),
    }


def _dist_from_depth(depth: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Along-ray distance images from z-depth images [N, H, W], K [N, 3, 3]."""
    H, W = depth.shape[-2:]
    u = torch.arange(W, dtype=depth.dtype, device=depth.device)
    v = torch.arange(H, dtype=depth.dtype, device=depth.device)[:, None]
    x = (u - K[:, 0, 2, None, None]) / K[:, 0, 0, None, None]
    y = (v - K[:, 1, 2, None, None]) / K[:, 1, 1, None, None]
    return depth * torch.sqrt(x * x + y * y + 1.0)


@torch.inference_mode()
def _vsd_from_depths(
    depth_est: torch.Tensor,  # [N, H, W] rendered z-depth at the estimated pose
    depth_gt: torch.Tensor,  # [N, H, W] rendered z-depth at the GT pose
    depth_test: torch.Tensor,  # [N, H, W] observed scene z-depth (0 = invalid)
    K: torch.Tensor,  # [N, 3, 3]
    taus: torch.Tensor,  # [N, n_taus] absolute tolerances [m]
) -> torch.Tensor:
    """BOP19 VSD step-cost errors, [N, n_taus]."""
    d_est = _dist_from_depth(depth_est, K)
    d_gt = _dist_from_depth(depth_gt, K)
    d_test = _dist_from_depth(depth_test, K)

    # bop_toolkit visibility.py, visib_mode='bop19': a rendered pixel is
    # visible if it is in front of the measured surface (within delta) or
    # the test depth is invalid there
    visib_gt = (d_gt > 0) & ((d_gt - d_test <= VSD_DELTA) | (d_test == 0))
    visib_est = (d_est > 0) & ((d_est - d_test <= VSD_DELTA) | (d_test == 0))
    # the estimate also counts the pixels it shares with the visible GT mask
    visib_est = visib_est | (visib_gt & (d_est > 0))

    inter = visib_gt & visib_est
    union_count = (visib_gt | visib_est).sum(dim=(1, 2))  # [N]
    comp_count = union_count - inter.sum(dim=(1, 2))

    d_diff = (d_gt - d_est).abs()
    # one boolean image per tau, never a float [N, H, W, n_taus]
    over = torch.stack(
        [((d_diff > taus[:, i, None, None]) & inter).sum(dim=(1, 2))
         for i in range(taus.shape[1])], dim=1,
    )
    bad = over + comp_count[:, None]  # [N, n_taus]
    e = bad / torch.clamp(union_count, min=1)[:, None]
    return torch.where(union_count[:, None] == 0, torch.ones_like(e), e)


def vsd_batch(
    TCO_pred: np.ndarray,  # [N, 4, 4]
    TCO_gt: np.ndarray,  # [N, 4, 4]
    obj_ids: np.ndarray,  # [N]
    K: np.ndarray,  # [N, 3, 3]
    depth_test: np.ndarray,  # [N, H, W]
    assets: RenderAssets,
    diameters: np.ndarray,  # [N]
    resolution: Optional[Tuple[int, int]] = None,
    taus_rel: Tuple[float, ...] = VSD_TAUS,
) -> np.ndarray:
    """VSD errors [N, n_taus] (taus relative to the object diameter), on
    the device of `assets`: two renders (estimates, GT). If `resolution`
    differs from the test depth's shape, K and the test depth are rescaled
    (nearest neighbour, which keeps 0 = invalid)."""
    N, H, W = depth_test.shape
    rh, rw = resolution if resolution is not None else (H, W)
    if (rh, rw) != (H, W):
        sy, sx = rh / H, rw / W
        S = np.asarray([[sx, 0, 0], [0, sy, 0], [0, 0, 1]], np.float32)
        K = S[None] @ np.asarray(K, np.float32)
        yi = np.clip((np.arange(rh) / sy).astype(int), 0, H - 1)
        xi = np.clip((np.arange(rw) / sx).astype(int), 0, W - 1)
        depth_test = depth_test[:, yi][:, :, xi]
    dev = assets.vertices.device

    def f32(x):  # a copy: a broadcast view is not writable
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    ids = torch.as_tensor(np.asarray(obj_ids), dtype=torch.long, device=dev)
    Kt = f32(K)
    r_est = render_batch_fused(assets, ids, f32(TCO_pred), Kt, resolution=(rh, rw))
    r_gt = render_batch_fused(assets, ids, f32(TCO_gt), Kt, resolution=(rh, rw))
    taus = np.asarray(taus_rel, np.float32)[None] * np.asarray(diameters, np.float32)[:, None]
    e = _vsd_from_depths(r_est.depth, r_gt.depth, f32(depth_test), Kt, f32(taus))
    return e.cpu().numpy()


def _match_recall(
    errors: np.ndarray,  # [n_est, n_gt] pairwise (inf = different object)
    est_scores: np.ndarray,  # [n_est]
    gt_valid: np.ndarray,  # [n_gt] bool (visib >= 0.1)
    ths: np.ndarray,  # [n_est, n_gt] per-pair correctness thresholds
) -> Tuple[int, int]:
    """BOP19 greedy matching for one image and threshold setting: estimates
    in descending score order claim the unmatched GT with the lowest error
    among those with error < threshold; a match to an invalid (barely
    visible) GT uses up the estimate and scores nothing.
    Returns (n_valid_matched, n_valid_gt)."""
    gt_used = np.zeros(errors.shape[1], bool)
    matched_valid = 0
    for ei in np.argsort(-est_scores):
        ok = np.where(~gt_used & (errors[ei] < ths[ei]))[0]
        if len(ok) == 0:
            continue
        gi = ok[np.argmin(errors[ei, ok])]
        gt_used[gi] = True
        if gt_valid[gi]:
            matched_valid += 1
    return matched_valid, int(gt_valid.sum())


@dataclass
class Bop19Evaluator:
    """Accumulates BOP19 AR over images. `add_image` takes one image's
    predictions and GT annotations as arrays and the observed depth map
    (without it, or without `assets`, VSD is skipped and AR is the mean of
    the MSSD and MSPD recalls). Errors are computed on the device of
    `meshes` / `assets`."""

    meshes: BatchedMeshes
    assets: Optional[RenderAssets] = None
    vsd_resolution: Optional[Tuple[int, int]] = None
    # per error type, one [n_settings, 2] (n_matched, n_valid) array an image
    _tallies: Dict[str, List[np.ndarray]] = field(default_factory=dict)

    def add_image(
        self,
        TCO_pred: np.ndarray,
        pred_obj_ids: np.ndarray,
        pred_scores: np.ndarray,
        TCO_gt: np.ndarray,
        gt_obj_ids: np.ndarray,
        K: np.ndarray,  # [3, 3]
        gt_visib_fract: Optional[np.ndarray] = None,
        depth_test: Optional[np.ndarray] = None,  # [H, W], meters
        im_width: int = 640,
    ) -> None:
        n_gt = len(TCO_gt)
        if n_gt == 0:
            return
        if gt_visib_fract is None:
            gt_visib_fract = np.ones(n_gt, np.float32)
        gt_valid = np.asarray(gt_visib_fract) >= VISIB_GT_MIN
        with_vsd = depth_test is not None and self.assets is not None

        pred_obj_ids = np.asarray(pred_obj_ids, int)
        gt_obj_ids = np.asarray(gt_obj_ids, int)

        # BOP19 n_top = -1: per object, only the top-n scored estimates take
        # part, where n counts the object's GT instances visible >= 10%
        # (otherwise extra estimates inflate recall)
        if len(TCO_pred):
            keep = np.zeros(len(TCO_pred), bool)
            taken: Dict[int, int] = {}
            for ei in np.argsort(-np.asarray(pred_scores)):
                o = int(pred_obj_ids[ei])
                budget = int(((gt_obj_ids == o) & gt_valid).sum())
                if taken.get(o, 0) < budget:
                    taken[o] = taken.get(o, 0) + 1
                    keep[ei] = True
            TCO_pred = np.asarray(TCO_pred)[keep]
            pred_obj_ids = pred_obj_ids[keep]
            pred_scores = np.asarray(pred_scores)[keep]
        n_est = len(TCO_pred)
        diam = self.meshes.diameters.cpu().numpy()

        if n_est == 0:
            # one (0, n_valid) row per threshold setting, so the image
            # weighs as much as one that has estimates
            n_settings = {"mssd": len(CORRECTNESS_THS), "mspd": len(MSPD_THS)}
            if with_vsd:
                n_settings["vsd"] = len(VSD_TAUS) * len(CORRECTNESS_THS)
            zero = np.asarray([[0, int(gt_valid.sum())]], int)
            for name, ns in n_settings.items():
                self._tallies.setdefault(name, []).append(np.repeat(zero, ns, axis=0))
            return

        # all same-object (est, gt) pairs
        pi, gi = np.meshgrid(np.arange(n_est), np.arange(n_gt), indexing="ij")
        pi, gi = pi.ravel(), gi.ravel()
        same = pred_obj_ids[pi] == gt_obj_ids[gi]
        pairs_p, pairs_g = pi[same], gi[same]

        err_mssd = np.full((n_est, n_gt), np.inf)
        err_mspd = np.full((n_est, n_gt), np.inf)
        err_vsd = np.full((n_est, n_gt, len(VSD_TAUS)), np.inf)
        n_pairs = len(pairs_p)
        if n_pairs:
            dev = self.meshes.points.device
            ids = gt_obj_ids[pairs_g]
            pred = np.asarray(TCO_pred, np.float32)[pairs_p]
            gt = np.asarray(TCO_gt, np.float32)[pairs_g]
            Kb = np.tile(np.asarray(K, np.float32), (n_pairs, 1, 1))
            inst = self.meshes.select(torch.as_tensor(ids, dtype=torch.long, device=dev))
            out = mssd_mspd_batch(
                torch.as_tensor(pred, device=dev), torch.as_tensor(gt, device=dev),
                torch.as_tensor(Kb, device=dev),
                inst.points, inst.points_mask, inst.symmetries, inst.symmetries_mask,
            )
            err_mssd[pairs_p, pairs_g] = out["mssd"].cpu().numpy()
            err_mspd[pairs_p, pairs_g] = out["mspd"].cpu().numpy()
            if with_vsd:
                err_vsd[pairs_p, pairs_g] = vsd_batch(
                    pred, gt, ids, Kb,
                    np.broadcast_to(depth_test, (n_pairs,) + depth_test.shape),
                    self.assets, diam[ids], resolution=self.vsd_resolution,
                )

        gt_diam = diam[gt_obj_ids][None, :]  # [1, n_gt]
        r = im_width / 640.0
        scores = np.asarray(pred_scores, np.float32)

        def tally(errors, thresholds):
            return np.asarray([_match_recall(errors, scores, gt_valid, th) for th in thresholds])

        self._tallies.setdefault("mssd", []).append(tally(
            err_mssd, [np.broadcast_to(th * gt_diam, (n_est, n_gt)) for th in CORRECTNESS_THS]
        ))
        self._tallies.setdefault("mspd", []).append(tally(
            err_mspd, [np.full((n_est, n_gt), th * r) for th in MSPD_THS]
        ))
        if with_vsd:
            t = [tally(err_vsd[:, :, ti], [np.full((n_est, n_gt), th) for th in CORRECTNESS_THS])
                 for ti in range(len(VSD_TAUS))]
            self._tallies.setdefault("vsd", []).append(np.concatenate(t, axis=0))

    def summary(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        ars = []
        for name in ("vsd", "mssd", "mspd"):
            if name not in self._tallies:
                continue
            t = np.concatenate(self._tallies[name], axis=0)
            n_matched, n_valid = t[:, 0].sum(), t[:, 1].sum()
            ar = float(n_matched / max(n_valid, 1))
            out[f"AR_{name.upper()}"] = ar
            ars.append(ar)
        out["bop19_AR"] = float(np.mean(ars)) if ars else float("nan")
        return out
