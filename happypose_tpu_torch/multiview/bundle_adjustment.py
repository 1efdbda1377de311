"""Object-level bundle adjustment: Levenberg-Marquardt over 9D poses
(PyTorch port of `happypose_tpu/multiview/bundle_adjustment.py`).

Residuals are the reprojection errors of each candidate's points under
the model poses against the candidate's symmetry-aligned pose, clipped at
`residuals_threshold`. Two solvers:

- "dense": one `torch.func.jacfwd` over all parameters, Jacobi-scaled
  normal equations, one `torch.linalg.solve`.
- "schur": per-candidate Jacobian blocks (`vmap` of `jacfwd`), summed per
  object and camera with `index_add` / `index_put(accumulate=True)`; the
  object blocks are eliminated through a truncated `eigh` pseudo-inverse
  and the reduced (9 n_views)^2 camera system is solved.

- "schur_sharded": the same step with the candidates split over the ranks
  of `device_mesh`'s first axis (zero-weight candidates pad them to a
  multiple of its size). Each rank builds the blocks and the loss sum of
  its candidates, one `all_reduce(SUM)` adds them up, and every rank solves
  the small reduced camera system.

The first camera is the gauge: its parameters never move. Each LM
iteration reads its loss on the host to accept or reject the step, as the
JAX package does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from happypose_tpu_torch.lib3d.camera import project_points
from happypose_tpu_torch.lib3d.transforms import T_to_pose9d, pose9d_to_T
from happypose_tpu_torch.meshes.database import BatchedMeshes
from happypose_tpu_torch.parallel.mesh import shard_leading

SOLVERS = ("dense", "schur", "schur_sharded")


class SamplerError(RuntimeError):
    pass


def initialize_TWO_TWC(
    n_views: int,
    n_objects: int,
    cand_view_idx: np.ndarray,  # [C] view index per candidate
    cand_obj_idx: np.ndarray,  # [C] object index per candidate
    cand_TCO: np.ndarray,  # [C, 4, 4]
    view_pairs: list,  # [(v1_idx, v2_idx)]
    TC1C2: np.ndarray,  # [n_pairs, 4, 4]
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy spanning initialization (numpy, float64): camera 0 of a
    random order is the world; others chain through known relative poses;
    objects initialize from the first view that sees them."""
    rng = np.random.RandomState(seed)
    TWC = np.full((n_views, 4, 4), np.nan)
    TWO = np.full((n_objects, 4, 4), np.nan)
    rel = {}
    for (v1, v2), T in zip(view_pairs, TC1C2):
        rel[(v1, v2)] = T
        rel[(v2, v1)] = np.linalg.inv(T)

    order = rng.permutation(n_views)
    TWC[order[0]] = np.eye(4)
    initialized = {order[0]}
    for _ in range(n_views):
        for v1 in order:
            if v1 in initialized:
                continue
            for v2 in order:
                if v2 in initialized and (v2, v1) in rel:
                    TWC[v1] = TWC[v2] @ rel[(v2, v1)]
                    initialized.add(v1)
                    break
    if len(initialized) < n_views:
        raise SamplerError("view graph is not connected")

    for o in range(n_objects):
        cands = np.where(cand_obj_idx == o)[0]
        if len(cands) == 0:
            TWO[o] = np.eye(4)
            continue
        c = cands[0]
        TWO[o] = TWC[cand_view_idx[c]] @ cand_TCO[c]
    return TWO, TWC


@dataclass(eq=False)
class MultiviewRefinement:
    """LM bundle adjustment of all object & camera poses of one scene, on
    `device`.

    Args:
      cand_TCO: [C, 4, 4] single-view estimates.
      cand_view_idx / cand_obj_idx: [C] dense indices.
      cand_obj_ids: [C] mesh-db ids (for symmetries and points).
      K: [n_views, 3, 3].
      meshes: padded mesh db; points used for residuals are subsampled to
        `n_points`.
      solver: "dense", "schur" or "schur_sharded" (needs `device_mesh`, a
        `DeviceMesh` whose first axis splits the candidates; its device
        type is `device`'s).
    """

    cand_TCO: np.ndarray
    cand_view_idx: np.ndarray
    cand_obj_idx: np.ndarray
    cand_obj_ids: np.ndarray
    K: np.ndarray
    meshes: BatchedMeshes
    n_points: int = 8
    solver: str = "dense"
    device_mesh: object = None
    device: str = "cuda"

    def __post_init__(self):
        if self.solver not in SOLVERS:
            raise ValueError(f"solver {self.solver!r} is not one of {SOLVERS}")
        if self.solver == "schur_sharded" and self.device_mesh is None:
            raise ValueError("solver='schur_sharded' needs a device_mesh")
        dev = torch.device(self.device)
        self.n_views = int(self.K.shape[0])
        self.n_objects = int(np.max(self.cand_obj_idx)) + 1
        ids = torch.as_tensor(np.asarray(self.cand_obj_ids), dtype=torch.int64,
                              device=self.meshes.points.device)
        inst = self.meshes.select(ids).to(dev)
        # deterministic point subsample for residuals
        P = inst.points.shape[1]
        sel = np.linspace(0, P - 1, self.n_points).astype(np.int64)
        self.cand_points = inst.points[:, torch.as_tensor(sel, device=dev)]  # [C, p, 3]
        self.cand_sym = inst.symmetries
        self.cand_sym_mask = inst.symmetries_mask
        self.K_t = torch.as_tensor(np.asarray(self.K), dtype=torch.float32, device=dev)
        self.TCO_t = torch.as_tensor(np.asarray(self.cand_TCO), dtype=torch.float32, device=dev)
        self.v_idx = torch.as_tensor(np.asarray(self.cand_view_idx), dtype=torch.int64, device=dev)
        self.o_idx = torch.as_tensor(np.asarray(self.cand_obj_idx), dtype=torch.int64, device=dev)
        # the gauge: camera 0's parameters never move
        start = self.n_objects * 9
        idx = torch.arange(start + self.n_views * 9, device=dev)
        self.free = (idx < start) | (idx >= start + 9)
        self.cand_weight = torch.ones(len(self.cand_view_idx), device=dev)
        if self.solver == "schur_sharded":
            mesh = self.device_mesh
            axis = mesh.mesh_dim_names[0]
            self._sh_group = mesh.get_group(axis)
            # zero-weight candidates pad the axis to equal blocks; they add
            # nothing to the block sums
            self._sh_pad = -len(self.cand_view_idx) % mesh.size(0)

            def pad(x):
                return torch.cat([x, x.new_zeros((self._sh_pad,) + x.shape[1:])])

            self._sh_o_idx, self._sh_v_idx, self._sh_points, self._sh_weight = shard_leading(
                tuple(pad(x) for x in (self.o_idx, self.v_idx, self.cand_points,
                                       self.cand_weight)), mesh, axis)

    def _split(self, params: torch.Tensor):
        n = self.n_objects * 9
        return params[:n].reshape(self.n_objects, 9), params[n:].reshape(self.n_views, 9)

    # -------------------- residuals --------------------

    @torch.no_grad()
    def _align_targets(self, TWO_9d: torch.Tensor, TCW_9d: torch.Tensor) -> torch.Tensor:
        """Symmetry-align each candidate to the current model: pick S*
        minimizing the reprojected distance, target = TCO_cand @ S*."""
        TWO = pose9d_to_T(TWO_9d)
        TCW = pose9d_to_T(TCW_9d)
        TCO_model = torch.einsum("cij,cjk->cik", TCW[self.v_idx], TWO[self.o_idx])
        Kc = self.K_t[self.v_idx]
        T_sym = torch.einsum("cij,csjk->csik", self.TCO_t, self.cand_sym)
        C, S = T_sym.shape[:2]
        pts = self.cand_points
        # uv of every symmetry variant: [C, S, p, 2]
        uv_s = project_points(
            torch.repeat_interleave(pts, S, dim=0), torch.repeat_interleave(Kc, S, dim=0),
            T_sym.reshape(C * S, 4, 4),
        ).reshape(C, S, -1, 2)
        uv_model = project_points(pts, Kc, TCO_model)  # [C, p, 2]
        diff = uv_s - uv_model[:, None]
        d = torch.sqrt((diff * diff).sum(-1)).mean(-1)  # jnp.linalg.norm's formula
        d = torch.where(self.cand_sym_mask, d, torch.full_like(d, float("inf")))
        best = torch.argmin(d, dim=-1)
        return T_sym[torch.arange(C, device=best.device), best]

    def _residuals(self, params: torch.Tensor, T_target: torch.Tensor) -> torch.Tensor:
        """Flat residual vector [C * p * 2] of reprojection errors."""
        TWO_9d, TCW_9d = self._split(params)
        TWO = pose9d_to_T(TWO_9d)
        TCW = pose9d_to_T(TCW_9d)
        TCO_model = torch.einsum("cij,cjk->cik", TCW[self.v_idx], TWO[self.o_idx])
        Kc = self.K_t[self.v_idx]
        uv_model = project_points(self.cand_points, Kc, TCO_model)
        uv_target = project_points(self.cand_points, Kc, T_target)
        return (uv_target - uv_model).reshape(-1)

    # -------------------- LM --------------------

    def _lm_step(self, params, T_target, lambd: float, residuals_threshold: float):
        errors = self._residuals(params, T_target)
        J = jacfwd(self._residuals)(params, T_target)  # [R, D]
        clipped = torch.clamp(errors, -residuals_threshold, residuals_threshold)
        loss = torch.mean(torch.clamp(errors**2, max=residuals_threshold**2))
        JtJ = J.T @ J
        # Jacobi scaling: solve S(J^TJ+λI)S y = S J^T e, h = S y — exact
        # in real arithmetic but keeps the f32 solve well-conditioned
        # (pixel-per-unit column norms differ by orders of magnitude)
        s = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(JtJ), min=1e-12))
        A = JtJ * s[:, None] * s[None, :] + lambd * torch.diag(s**2)
        b = (J.T @ clipped) * s
        h = torch.linalg.solve(A, b) * s
        # where, not multiply: a non-finite entry must not poison the gauge
        return params + torch.where(self.free, h, torch.zeros_like(h)), loss

    # -------------------- Schur-complement LM --------------------

    @staticmethod
    def _cand_residual(two9, tcw9, pts, K, T_target):
        """Residuals of ONE candidate as a function of its own two pose
        blocks only — the sparsity unit of the BA problem."""
        TWO = pose9d_to_T(two9[None])[0]
        TCW = pose9d_to_T(tcw9[None])[0]
        TCO = TCW @ TWO
        uv_model = project_points(pts[None], K[None], TCO[None])[0]
        uv_target = project_points(pts[None], K[None], T_target[None])[0]
        return (uv_target - uv_model).reshape(-1)  # [p*2]

    def _cand_blocks(self, params, T_target, o_idx, v_idx, pts, weight,
                     residuals_threshold: float):
        """JᵀJ / Jᵀe blocks of the candidates (`o_idx`, `v_idx`, points
        `pts`, targets `T_target`), each weighted by `weight` (0 for a
        padding candidate), summed into the objects' and cameras' blocks: U
        [n_obj, 9, 9], V [n_views, 9, 9], W [n_obj, n_views, 9, 9], b_o
        [n_obj, 9], b_v [n_views, 9], and the clipped loss summed over
        residuals."""
        n_obj, n_views = self.n_objects, self.n_views
        two, tcw = self._split(params)
        args = (two[o_idx], tcw[v_idx], pts, self.K_t[v_idx], T_target)

        f = self._cand_residual
        r = vmap(f)(*args)
        A = vmap(jacfwd(f, argnums=0))(*args)  # [c, m, 9]
        Bj = vmap(jacfwd(f, argnums=1))(*args)  # [c, m, 9]
        e = torch.clamp(r, -residuals_threshold, residuals_threshold) * weight[:, None]
        loss_sum = torch.sum(torch.clamp(r**2, max=residuals_threshold**2).sum(-1) * weight)
        w2 = weight[:, None, None]
        AtA = torch.einsum("cmi,cmj->cij", A, A) * w2
        BtB = torch.einsum("cmi,cmj->cij", Bj, Bj) * w2
        AtB = torch.einsum("cmi,cmj->cij", A, Bj) * w2
        Ate = torch.einsum("cmi,cm->ci", A, e)
        Bte = torch.einsum("cmi,cm->ci", Bj, e)

        o, v = o_idx, v_idx
        U = AtA.new_zeros((n_obj, 9, 9)).index_add(0, o, AtA)
        V = BtB.new_zeros((n_views, 9, 9)).index_add(0, v, BtB)
        W = AtB.new_zeros((n_obj, n_views, 9, 9)).index_put((o, v), AtB, accumulate=True)
        b_o = Ate.new_zeros((n_obj, 9)).index_add(0, o, Ate)
        b_v = Bte.new_zeros((n_views, 9)).index_add(0, v, Bte)
        return U, V, W, b_o, b_v, loss_sum

    def _schur_reduce_solve(self, U, V, W, b_o, b_v, lambd: float) -> torch.Tensor:
        """Eliminate the object blocks and solve the reduced camera system.

        J^T J = [[U, W], [W^T, V]] with U block-diagonal over objects and V
        over cameras; (V - WᵀU⁻¹W) h_c = b_c - WᵀU⁻¹b_o, back-substitute."""
        n_views = self.n_views
        # Jacobi preconditioning: the 9d ortho6d blocks are singular along
        # the parameterization's scale directions, so eliminating U in f32
        # without scaling is unstable. Solving S(J^TJ+λI)S y = S b with
        # S = diag(J^TJ)^{-1/2} is exact-arithmetic-equivalent and stable.
        eps = 1e-12
        s_o = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(U, dim1=-2, dim2=-1), min=eps))
        s_v = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(V, dim1=-2, dim2=-1), min=eps))
        U = U * s_o[:, :, None] * s_o[:, None, :]
        V = V * s_v[:, :, None] * s_v[:, None, :]
        W = W * s_o[:, None, :, None] * s_v[None, :, None, :]
        diag9 = torch.eye(9, dtype=U.dtype, device=U.device)
        U = U + lambd * diag9 * (s_o**2)[:, None, :]
        V = V + lambd * diag9 * (s_v**2)[:, None, :]
        b_o = b_o * s_o
        b_v = b_v * s_v

        # truncated pseudo-inverse of the object blocks: the ortho6d
        # parameterization has non-axis-aligned null directions that
        # diagonal scaling cannot lift, and plainly inverting them poisons
        # the Schur complement. Eigenvalues below 1e-5 of the block max are
        # treated as null (their b components are ~0 too). The input is
        # symmetrized first, as `jnp.linalg.eigh` does.
        w, Q = torch.linalg.eigh((U + U.transpose(-1, -2)) / 2)
        w_floor = torch.clamp(w[..., -1:], min=1e-12) * 1e-5
        w_inv = torch.where(w > w_floor, 1.0 / torch.clamp(w, min=1e-12), torch.zeros_like(w))
        Uinv = torch.einsum("oij,oj,okj->oik", Q, w_inv, Q)
        # reduced camera system
        S = -torch.einsum("ovki,okl,owlj->vwij", W, Uinv, W)
        views = torch.arange(n_views, device=S.device)
        S = S.index_put((views, views), V, accumulate=True)
        S = S.permute(0, 2, 1, 3).reshape(n_views * 9, n_views * 9)
        rhs = b_v - torch.einsum("ovki,okl,ol->vi", W, Uinv, b_o)
        rhs = rhs.reshape(-1)
        # gauge fix INSIDE the system: camera 0's rows/cols become the
        # identity with zero rhs, so S is structurally nonsingular and
        # h_c[0] == 0 exactly (fixing it only after the solve leaves S
        # singular, and LU then returns NaN)
        gauge = torch.arange(n_views * 9, device=S.device) < 9
        S = torch.where(gauge[:, None] | gauge[None, :],
                        torch.eye(n_views * 9, dtype=S.dtype, device=S.device), S)
        rhs = torch.where(gauge, torch.zeros_like(rhs), rhs)
        h_c = torch.linalg.solve(S, rhs).reshape(n_views, 9)
        h_o = torch.einsum(
            "okl,ol->ok", Uinv, b_o - torch.einsum("ovij,vj->oi", W, h_c),
        )
        h_o = h_o * s_o  # undo the scaling
        h_c = h_c * s_v
        return torch.cat([h_o.reshape(-1), h_c.reshape(-1)])

    def _n_residuals(self) -> float:
        return float(len(self.cand_view_idx) * self.cand_points.shape[1] * 2)

    def _apply_step(self, params, h, loss_sum):
        # where, not multiply: a non-finite entry must not poison the gauge
        h = torch.where(self.free, h, torch.zeros_like(h))
        return params + h, loss_sum / self._n_residuals()

    def _lm_step_schur(self, params, T_target, lambd: float, residuals_threshold: float):
        """One Schur-complement LM step."""
        blocks = self._cand_blocks(params, T_target, self.o_idx, self.v_idx, self.cand_points,
                                   self.cand_weight, residuals_threshold)
        h = self._schur_reduce_solve(*blocks[:5], lambd)
        return self._apply_step(params, h, blocks[5])

    def _lm_step_schur_sharded(self, params, T_target, lambd: float,
                               residuals_threshold: float):
        """One Schur-complement LM step with the candidates split over the
        mesh axis: this rank's block sums, one `all_reduce(SUM)` of all of
        them in one buffer, and the reduced solve on every rank."""
        mesh = self.device_mesh
        # padding targets sit 1 m in front of the camera: their residuals are
        # finite (projection divides by z) and their zero weight drops them
        T_pad = torch.eye(4, dtype=T_target.dtype, device=T_target.device)
        T_pad[2, 3] = 1.0
        T_t = torch.cat([T_target, T_pad.expand(self._sh_pad, 4, 4)])
        T_t = shard_leading(T_t, mesh, mesh.mesh_dim_names[0])
        blocks = self._cand_blocks(params, T_t, self._sh_o_idx, self._sh_v_idx, self._sh_points,
                                   self._sh_weight, residuals_threshold)
        flat = torch.cat([b.reshape(-1) for b in blocks])
        torch.distributed.all_reduce(flat, group=self._sh_group)
        U, V, W, b_o, b_v, loss_sum = (
            x.view_as(b) for x, b in zip(flat.split([b.numel() for b in blocks]), blocks))
        h = self._schur_reduce_solve(U, V, W, b_o, b_v, lambd)
        return self._apply_step(params, h, loss_sum)

    def _loss(self, params, T_target, residuals_threshold: float) -> torch.Tensor:
        e = self._residuals(params, T_target)
        return torch.mean(torch.clamp(e**2, max=residuals_threshold**2))

    def solve(
        self,
        view_pairs: list,
        TC1C2: np.ndarray,
        n_iterations: int = 50,
        residuals_threshold: float = 25.0,
        lambd0: float = 1e-3,
        n_init: int = 1,
    ) -> Dict:
        """Run LM from `n_init` random greedy initializations, keep the best.

        Returns dict(TWO [n_obj, 4, 4], TWC [n_views, 4, 4], loss) (numpy)."""
        dev = self.K_t.device
        step = {"schur": self._lm_step_schur,
                "schur_sharded": self._lm_step_schur_sharded}.get(self.solver, self._lm_step)
        best = None
        for s in range(n_init):
            TWO0, TWC0 = initialize_TWO_TWC(
                self.n_views, self.n_objects, self.cand_view_idx,
                self.cand_obj_idx, self.cand_TCO, view_pairs, TC1C2, seed=s,
            )
            # the inverse in float64, then float32, as the JAX package casts
            TCW0 = torch.as_tensor(np.linalg.inv(TWC0), dtype=torch.float32, device=dev)
            TWO0 = torch.as_tensor(TWO0, dtype=torch.float32, device=dev)
            params = torch.cat([T_to_pose9d(TWO0).reshape(-1), T_to_pose9d(TCW0).reshape(-1)])
            T_target = self._align_targets(*self._split(params))
            lambd = lambd0
            loss = float(self._loss(params, T_target, residuals_threshold))
            for _ in range(n_iterations):
                new_params, _ = step(params, T_target, lambd, residuals_threshold)
                new_loss = float(self._loss(new_params, T_target, residuals_threshold))
                if new_loss < loss:
                    params = new_params
                    loss = new_loss
                    lambd = max(lambd / 10.0, 1e-8)
                    # re-align symmetry targets as the model moves
                    T_target = self._align_targets(*self._split(params))
                else:
                    lambd = min(lambd * 10.0, 1e6)
            if best is None or loss < best["loss"]:
                TWO_9d, TCW_9d = self._split(params)
                best = {
                    "TWO": pose9d_to_T(TWO_9d).cpu().numpy(),
                    "TWC": torch.linalg.inv(pose9d_to_T(TCW_9d)).cpu().numpy(),
                    "loss": loss,
                }
        return best
