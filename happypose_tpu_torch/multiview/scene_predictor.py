"""Multi-view scene-level prediction, CosyPose stage 2 (PyTorch port of
`happypose_tpu/multiview/scene_predictor.py`): score-filter single-view
candidates -> RANSAC candidate matching -> bundle adjustment of the matched
objects and their views -> reprojected per-view predictions; `nms3d` over
the reconstructed objects.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from happypose_tpu_torch.meshes.database import BatchedMeshes
from happypose_tpu_torch.multiview.bundle_adjustment import MultiviewRefinement
from happypose_tpu_torch.multiview.ransac import (
    MultiviewCandidates,
    multiview_candidate_matching,
)


@dataclass
class SceneState:
    """Reconstructed scene: objects + cameras in a common world frame."""

    TWO: np.ndarray  # [n_obj, 4, 4]
    TWC: np.ndarray  # [n_views, 4, 4]
    obj_ids: np.ndarray  # [n_obj] mesh-db ids
    obj_scores: np.ndarray  # [n_obj] summed candidate scores
    view_ids: np.ndarray  # [n_views]
    ba_loss: float

    def predictions_per_view(self) -> Dict[int, Dict[str, np.ndarray]]:
        """Reproject objects into every camera."""
        out = {}
        for i, v in enumerate(self.view_ids):
            TCW = np.linalg.inv(self.TWC[i])
            out[int(v)] = {
                "TCO": np.einsum("ij,ojk->oik", TCW, self.TWO),
                "obj_ids": self.obj_ids,
                "scores": self.obj_scores,
            }
        return out


class MultiviewScenePredictor:
    """Candidates of one scene -> `SceneState`; matching and bundle
    adjustment run on `device`, where the meshes are placed."""

    def __init__(
        self,
        meshes: BatchedMeshes,
        score_th: float = 0.3,
        n_ransac_iter: int = 20,
        dist_threshold: float = 0.02,
        n_min_inliers: int = 3,
        ba_n_iterations: int = 50,
        ba_n_points: int = 8,
        ba_solver: str = "dense",  # dense | schur (Schur-complement LM)
        device="cuda",
    ):
        self.device = device
        self.meshes = meshes.to(device)
        self.score_th = score_th
        self.n_ransac_iter = n_ransac_iter
        self.dist_threshold = dist_threshold
        self.n_min_inliers = n_min_inliers
        self.ba_n_iterations = ba_n_iterations
        self.ba_n_points = ba_n_points
        self.ba_solver = ba_solver

    def predict_scene_state(
        self,
        candidates: MultiviewCandidates,
        K: np.ndarray,  # [n_views, 3, 3] (row per *dense* view index)
        known_TWC: Optional[np.ndarray] = None,
        seed: int = 0,
    ) -> Optional[SceneState]:
        """Returns the reconstructed SceneState (None if nothing matched)."""
        keep = candidates.scores >= self.score_th
        cands = MultiviewCandidates(
            poses=candidates.poses[keep],
            view_ids=candidates.view_ids[keep],
            obj_ids=candidates.obj_ids[keep],
            scores=candidates.scores[keep],
            K=candidates.K,
        )
        if len(cands) == 0:
            return None

        match = multiview_candidate_matching(
            cands, self.meshes,
            n_ransac_iter=self.n_ransac_iter,
            dist_threshold=self.dist_threshold,
            n_min_inliers=self.n_min_inliers,
            seed=seed,
            known_TWC=known_TWC,
        )
        comp = match["component_ids"]
        sel = comp >= 0
        if not sel.any():
            return None

        # dense view reindexing over the views that survive
        views = np.unique(cands.view_ids[sel])
        vmap_ = {int(v): i for i, v in enumerate(views)}
        v_idx = np.asarray([vmap_[int(v)] for v in cands.view_ids[sel]])
        pairs = [
            (vmap_[v1], vmap_[v2])
            for (v1, v2) in match["view_pairs"]
            if v1 in vmap_ and v2 in vmap_
        ]
        TC1C2 = np.asarray(
            [
                T
                for (v1, v2), T in zip(match["view_pairs"], match["TC1C2"])
                if v1 in vmap_ and v2 in vmap_
            ]
        )

        refiner = MultiviewRefinement(
            cand_TCO=cands.poses[sel],
            cand_view_idx=v_idx,
            cand_obj_idx=comp[sel],
            cand_obj_ids=cands.obj_ids[sel],
            K=K[[vmap_[int(v)] for v in views]] if K.shape[0] != len(views)
            else K,
            meshes=self.meshes,
            n_points=self.ba_n_points,
            solver=self.ba_solver,
            device=self.device,
        )
        result = refiner.solve(pairs, TC1C2, n_iterations=self.ba_n_iterations)

        # per-object metadata: majority obj id + summed score per component
        n_obj = int(comp[sel].max()) + 1
        obj_ids = np.zeros(n_obj, int)
        obj_scores = np.zeros(n_obj)
        for o in range(n_obj):
            members = np.where(comp[sel] == o)[0]
            ids, counts = np.unique(
                cands.obj_ids[sel][members], return_counts=True
            )
            obj_ids[o] = ids[np.argmax(counts)]
            obj_scores[o] = cands.scores[sel][members].sum()

        return SceneState(
            TWO=result["TWO"],
            TWC=result["TWC"],
            obj_ids=obj_ids,
            obj_scores=obj_scores,
            view_ids=views,
            ba_loss=result["loss"],
        )


def nms3d(
    TWO: np.ndarray, scores: np.ndarray, th: float = 0.04
) -> np.ndarray:
    """3D translation NMS over reconstructed objects; returns kept indices:
    greedily keep the best-scored object, suppress others whose translation
    is within `th` meters (CosyPose's `nms3d`)."""
    t = np.asarray(TWO)[:, :3, 3]
    order = np.argsort(-np.asarray(scores))
    suppressed = set()
    keep = []
    for idx in order:
        if idx in suppressed:
            continue
        dists = np.linalg.norm(t[idx] - t, axis=-1)
        dists[idx] = np.inf
        for j in np.where(dists <= th)[0]:
            suppressed.add(int(j))
        keep.append(int(idx))
    return np.asarray(sorted(keep), int)
