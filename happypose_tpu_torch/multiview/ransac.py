"""Multi-view candidate matching by RANSAC on relative camera poses
(PyTorch port of `happypose_tpu/multiview/ransac.py`).

Tentative matches (candidates of one label in two views) are listed per
ordered view pair on the host; each hypothesis comes from one seed match,
with the symmetry of its object chosen to explain a second match; every
tentative match is scored under every hypothesis in one batch on the
device (the meshes' device); inliers are chosen greedily 1-1 on the host
and grouped into strongly connected components with scipy.

As in the JAX package, the best hypothesis is any with at least
`n_min_inliers` inliers (`>= 0` on its index, where CosyPose's C++
extension skipped hypothesis 0), and the seeds are numpy `RandomState`
draws in the JAX package's order, so one seed picks the same seeds in both.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import connected_components

from happypose_tpu_torch.lib3d.transforms import invert_transforms, transform_pts
from happypose_tpu_torch.meshes.database import BatchedMeshes


@dataclass
class MultiviewCandidates:
    """Single-view pose candidates across the views of one scene (numpy)."""

    poses: np.ndarray  # [N, 4, 4] TCO in each candidate's own view
    view_ids: np.ndarray  # [N] int
    obj_ids: np.ndarray  # [N] int (mesh-db object ids)
    scores: np.ndarray  # [N]
    K: Optional[np.ndarray] = None  # [n_views, 3, 3] if needed downstream

    def __len__(self) -> int:
        return len(self.poses)


def _sym_distances(
    T1: torch.Tensor, T2: torch.Tensor, points: torch.Tensor, points_mask: torch.Tensor,
    symmetries: torch.Tensor, sym_mask: torch.Tensor,
) -> torch.Tensor:
    """mean_p || T1 S p - T2 p || for every symmetry slot S, +inf on unused
    slots; all [B, ...] batched. Returns [B, S]."""
    T1s = torch.einsum("bij,bsjk->bsik", T1, symmetries)
    p1 = transform_pts(T1s, points)  # [B, S, P, 3]
    p2 = transform_pts(T2, points)  # [B, P, 3]
    diff = p1 - p2[:, None]
    d = torch.sqrt((diff * diff).sum(-1))  # jnp.linalg.norm's formula
    m = points_mask[:, None, :].to(d.dtype)
    dist = (d * m).sum(-1) / torch.clamp(m.sum(-1), min=1.0)
    return torch.where(sym_mask, dist, torch.full_like(dist, float("inf")))


def _sym_dist_pairs(
    T1: torch.Tensor, T2: torch.Tensor, points: torch.Tensor, points_mask: torch.Tensor,
    symmetries: torch.Tensor, sym_mask: torch.Tensor,
) -> torch.Tensor:
    """min_s mean_p || T1 S p - T2 p ||; all [B, ...] batched. Returns [B]."""
    return _sym_distances(T1, T2, points, points_mask, symmetries, sym_mask).amin(dim=-1)


def _best_symmetry(
    T1: torch.Tensor, T2: torch.Tensor, points: torch.Tensor, points_mask: torch.Tensor,
    symmetries: torch.Tensor, sym_mask: torch.Tensor,
) -> torch.Tensor:
    """argmin_s of the same distance (the first on ties); returns S* [B, 4, 4]."""
    dist = _sym_distances(T1, T2, points, points_mask, symmetries, sym_mask)
    best = torch.argmin(dist, dim=-1)
    return symmetries[torch.arange(len(best), device=best.device), best]


def multiview_candidate_matching(
    candidates: MultiviewCandidates,
    meshes: BatchedMeshes,
    n_ransac_iter: int = 20,
    dist_threshold: float = 0.02,
    n_min_inliers: int = 3,
    max_tentative_per_pair: int = 64,
    seed: int = 0,
    known_TWC: Optional[np.ndarray] = None,  # [n_views, 4, 4]
) -> Dict:
    """Match candidates across views; estimate relative camera poses. The
    batched scoring runs on the device of `meshes`.

    Returns dict with:
      edges: [E, 2] candidate index pairs (inlier matches of best hypotheses)
      component_ids: [N] scene-object id per candidate (-1 = unmatched)
      view_pairs: [(v1, v2)] with TC1C2: [n_pairs, 4, 4]
    """
    N = len(candidates)
    view_ids = np.asarray(candidates.view_ids)
    obj_ids = np.asarray(candidates.obj_ids)
    views = np.unique(view_ids)
    rng = np.random.RandomState(seed)
    device = meshes.points.device

    # ---- tentative matches per ordered view pair (host: tiny) ----
    pair_list = []  # (v1, v2, matches [M, 2])
    for v1 in views:
        for v2 in views:
            if v1 == v2:
                continue
            c1s = np.where(view_ids == v1)[0]
            c2s = np.where(view_ids == v2)[0]
            matches = [
                (a, b) for a in c1s for b in c2s if obj_ids[a] == obj_ids[b]
            ]
            if matches:
                pair_list.append((v1, v2, np.asarray(matches[:max_tentative_per_pair])))
    if not pair_list:
        return {
            "edges": np.zeros((0, 2), int),
            "component_ids": np.full(N, -1),
            "view_pairs": [],
            "TC1C2": np.zeros((0, 4, 4)),
        }

    poses = torch.as_tensor(np.asarray(candidates.poses), dtype=torch.float32, device=device)

    def select(idx: np.ndarray) -> BatchedMeshes:
        return meshes.select(torch.as_tensor(obj_ids[idx], dtype=torch.int64, device=device))

    results_edges = []
    best_TC1C2 = []
    best_pairs = []
    for (v1, v2, matches) in pair_list:
        M = len(matches)
        a_idx = matches[:, 0]
        b_idx = matches[:, 1]
        if known_TWC is not None:
            vmap_ = {v: i for i, v in enumerate(views)}
            TC1C2_h = (
                np.linalg.inv(known_TWC[vmap_[v1]]) @ known_TWC[vmap_[v2]]
            )[None]
            R = 1
            TC1C2_h = torch.as_tensor(TC1C2_h, dtype=torch.float32, device=device)
        else:
            # ---- seeds: pairs of distinct tentative matches ----
            R = min(n_ransac_iter, M * max(M - 1, 1))
            if M < 2:
                seeds = np.zeros((R, 2), int)
            else:
                seeds = np.stack(
                    [rng.choice(M, 2, replace=False) for _ in range(R)]
                )
            m1, m2 = seeds[:, 0], seeds[:, 1]
            # hypothesis from match1 with symmetry chosen to best explain match2
            TC1Oa = poses[a_idx[m1]]
            TC2Ob = poses[b_idx[m1]]
            TC1Og = poses[a_idx[m2]]
            TC2Od = poses[b_idx[m2]]
            TObC2 = invert_transforms(TC2Ob)
            mesh_ab = select(a_idx[m1])
            mesh_gd = select(a_idx[m2])

            # evaluate all symmetries of the first match's object
            S = mesh_ab.symmetries  # [R, S, 4, 4]
            n_sym = S.shape[1]
            TC1C2_all = torch.einsum(
                "rij,rsjk,rkl->rsil", TC1Oa, S, TObC2
            )  # [R, S, 4, 4]
            pred = torch.einsum("rsij,rjk->rsik", TC1C2_all, TC2Od)
            # dist of TC1Og vs pred under gd symmetries: flatten (R*S)
            flat = pred.reshape(-1, 4, 4)

            def rep(x):
                return torch.repeat_interleave(x, n_sym, dim=0)

            d = _sym_dist_pairs(
                rep(TC1Og), flat, rep(mesh_gd.points), rep(mesh_gd.points_mask),
                rep(mesh_gd.symmetries), rep(mesh_gd.symmetries_mask),
            ).reshape(R, n_sym)
            d = torch.where(mesh_ab.symmetries_mask, d, torch.full_like(d, float("inf")))
            s_star = torch.argmin(d, dim=-1)
            TC1C2_h = TC1C2_all[torch.arange(R, device=device), s_star]

        # ---- score all tentative matches under all R hypotheses ----
        TC1Oa_all = poses[a_idx]  # [M, 4, 4]
        TC2Ob_all = poses[b_idx]
        TWOb = torch.einsum("rij,mjk->rmik", TC1C2_h, TC2Ob_all)  # [R, M, 4, 4]
        flat2 = TWOb.reshape(-1, 4, 4)

        def tile(x):
            return x.repeat((R,) + (1,) * (x.ndim - 1))

        mesh_a = select(a_idx)
        dists = _sym_dist_pairs(
            tile(TC1Oa_all), flat2, tile(mesh_a.points),
            tile(mesh_a.points_mask), tile(mesh_a.symmetries),
            tile(mesh_a.symmetries_mask),
        ).reshape(R, M)
        dists = dists.cpu().numpy()  # one host synchronization a view pair

        # ---- greedy unique 1-1 per hypothesis (host, tiny) ----
        best = None  # (n_inliers, -dists_sum, hyp_id, edges)
        for r in range(R):
            order = np.argsort(dists[r])
            used1, used2 = set(), set()
            edges_r = []
            dsum = 0.0
            for i in order:
                if dists[r][i] > dist_threshold:
                    break
                c1, c2 = int(a_idx[i]), int(b_idx[i])
                if c1 in used1 or c2 in used2:
                    continue
                used1.add(c1)
                used2.add(c2)
                edges_r.append((c1, c2))
                dsum += float(dists[r][i])
            n_inl = len(edges_r)
            if n_inl >= n_min_inliers:
                key = (n_inl, -dsum)
                if best is None or key > (best[0], best[1]):
                    best = (n_inl, -dsum, r, edges_r)
        if best is not None:
            results_edges.extend(best[3])
            best_TC1C2.append(TC1C2_h[best[2]].cpu().numpy())
            best_pairs.append((int(v1), int(v2)))

    # ---- strongly-connected-component grouping ----
    if results_edges:
        e = np.asarray(results_edges)
        graph = csr_matrix(
            (np.ones(len(e), int), (e[:, 0], e[:, 1])), shape=(N, N)
        )
        n_comp, comp = connected_components(
            graph, directed=True, connection="strong"
        )
        sizes = np.bincount(comp, minlength=n_comp)
        component_ids = np.where(sizes[comp] >= 2, comp, -1)
        # renumber surviving components densely
        uniq = np.unique(component_ids[component_ids >= 0])
        remap = {int(u): i for i, u in enumerate(uniq)}
        component_ids = np.asarray(
            [remap.get(int(c), -1) for c in component_ids]
        )
    else:
        component_ids = np.full(N, -1)

    return {
        "edges": np.asarray(results_edges).reshape(-1, 2),
        "component_ids": component_ids,
        "view_pairs": best_pairs,
        "TC1C2": np.stack(best_TC1C2) if best_TC1C2 else np.zeros((0, 4, 4)),
    }
