"""Forward + loss of refiner and coarse-classifier training (PyTorch port
of `happypose_tpu/training/forward_loss.py`).

Each `make_*_loss_fn` returns a `LossFn`: `sample(generator, batch)` makes
the step's random draws (pose noise, multiview picks, grid indices) with a
`torch.Generator` on the batch's device, and `loss_fn(batch, draws)` is
deterministic in them. `torch.Generator` is not `jax.random`, so only the
second half is held to JAX, on draws JAX made and the test hands over.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Sequence, Tuple

import torch

from happypose_tpu_torch.lib3d.multiview_geom import make_TCO_multiview
from happypose_tpu_torch.lib3d.so3_grid import load_SO3_grid
from happypose_tpu_torch.lib3d.transforms import apply_pose_noise, make_T, sample_pose_noise
from happypose_tpu_torch.meshes.database import BatchedMeshes, RenderAssets
from happypose_tpu_torch.models.pose_predictor import PosePredictor
from happypose_tpu_torch.training.losses import (
    coarse_classification_loss,
    loss_refiner_CO_disentangled_reference_point,
)

Draws = Dict[str, torch.Tensor]
EULER_DEG_STD = (15.0, 15.0, 15.0)
TRANS_STD = (0.01, 0.01, 0.05)
# the multiview negatives: sphere_26views x 4 in-plane rotations, without the input pose
MULTIVIEW = dict(multiview_type="sphere_26views", remove_TCO_rendering=True,
                 views_inplane_rotations=True)
N_MULTIVIEW = 26 * 4


class PoseTrainingBatch(NamedTuple):
    """One training batch."""

    images: torch.Tensor  # [B, 3(+1), H, W]
    K: torch.Tensor  # [B, 3, 3]
    obj_ids: torch.Tensor  # [B] int64
    TCO_gt: torch.Tensor  # [B, 4, 4]

    def to(self, device) -> "PoseTrainingBatch":
        return PoseTrainingBatch(*(x.to(device) for x in self))


@dataclass
class LossFn:
    """`sample(generator, batch) -> draws`; `loss_fn(batch, draws) ->
    (scalar loss, metrics)`, with the model in train mode."""

    sample: Callable[[torch.Generator, PoseTrainingBatch], Draws]
    loss: Callable[[PoseTrainingBatch, Draws], Tuple[torch.Tensor, Dict[str, torch.Tensor]]]

    def __call__(self, batch: PoseTrainingBatch, draws: Draws):
        return self.loss(batch, draws)


def _noise_sampler(euler_deg_std, trans_std):
    def sample(generator, batch):
        euler, trans = sample_pose_noise(
            generator, batch.TCO_gt.shape[0], euler_deg_std, trans_std)
        return {"euler": euler, "trans": trans}

    return sample


def _rep(x: torch.Tensor, n: int) -> torch.Tensor:
    return x.repeat_interleave(n, dim=0)


def make_refiner_loss_fn(
    model: PosePredictor,
    assets: RenderAssets,
    meshes: BatchedMeshes,
    n_iterations: int = 3,
    euler_deg_std: Sequence[float] = EULER_DEG_STD,
    trans_std: Sequence[float] = TRANS_STD,
) -> LossFn:
    """Refiner training: input = ground truth + SE(3) noise, loss = the
    disentangled reference-point loss averaged over iterations."""

    def loss_fn(batch: PoseTrainingBatch, draws: Draws):
        inst = meshes.select(batch.obj_ids)
        TCO_input = apply_pose_noise(batch.TCO_gt, draws["euler"], draws["trans"])
        out = model.train()(
            batch.images, batch.K, batch.obj_ids, TCO_input, assets, inst,
            n_iterations=n_iterations,
        )
        TCO_possible_gt = torch.einsum("bij,bsjk->bsik", batch.TCO_gt, inst.symmetries)
        total = 0.0
        metrics: Dict[str, torch.Tensor] = {}
        for it in range(n_iterations):
            loss, parts = loss_refiner_CO_disentangled_reference_point(
                TCO_possible_gt=TCO_possible_gt,
                TCO_input=out.TCO_input[it],
                refiner_outputs=out.pose_raw[it],
                K_crop=out.K_crop[it],
                points=inst.points,
                tCR=out.tCR[it],
                points_mask=inst.points_mask,
                sym_mask=inst.symmetries_mask,
            )
            total = total + loss.mean()
            metrics[f"loss_TCO_iter{it + 1}"] = loss.mean()
            metrics[f"loss_orn_iter{it + 1}"] = parts["loss_orn"].mean()
        return total / n_iterations, metrics

    return LossFn(_noise_sampler(euler_deg_std, trans_std), loss_fn)


def multiview_hypotheses(
    TCV_O: torch.Tensor,  # [B, V, 4, 4]
    perm: torch.Tensor,  # [B, n] distinct view indices
    include: torch.Tensor,  # [B] bool: force the positive (view 0) in
    slot: torch.Tensor,  # [B] where it goes
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The hypothesis set of the multiview coarse loss: the drawn views,
    with view 0 put at `slot` where `include` holds and it was not drawn.
    Returns (poses [B, n, 4, 4], is_positive [B, n] float)."""
    n = perm.shape[1]
    has_pos = (perm == 0).any(dim=1)
    force = (include & ~has_pos)[:, None] & (
        torch.arange(n, device=perm.device)[None, :] == slot[:, None])
    perm = torch.where(force, torch.zeros_like(perm), perm)
    hyp = torch.gather(TCV_O, 1, perm[:, :, None, None].expand(-1, -1, 4, 4))
    return hyp, (perm == 0).to(TCV_O.dtype)


def make_coarse_loss_fn(
    model: PosePredictor,
    assets: RenderAssets,
    meshes: BatchedMeshes,
    n_hypotheses: int = 2,
    positive_inclusion_prob: float = 0.7,
    euler_deg_std: Sequence[float] = EULER_DEG_STD,
    trans_std: Sequence[float] = TRANS_STD,
    logits_temperature: float = 1.0,
) -> LossFn:
    """Coarse-classifier training on the reference's multiview protocol:
    negatives are renders of the noised pose seen from the 26-sphere x 4
    in-plane viewpoints; the positive (view 0) is put into the sampled set
    with probability `positive_inclusion_prob` when it was not drawn."""
    noise = _noise_sampler(euler_deg_std, trans_std)

    def sample(generator, batch):
        B, dev = batch.TCO_gt.shape[0], batch.TCO_gt.device
        draws = noise(generator, batch)
        draws["perm"] = torch.rand(
            B, N_MULTIVIEW, generator=generator, device=dev).argsort(dim=1)[:, :n_hypotheses]
        draws["include"] = torch.rand(B, generator=generator, device=dev) < positive_inclusion_prob
        draws["slot"] = torch.randint(0, n_hypotheses, (B,), generator=generator, device=dev)
        return draws

    def loss_fn(batch: PoseTrainingBatch, draws: Draws):
        B = batch.TCO_gt.shape[0]
        TCO_noise = apply_pose_noise(batch.TCO_gt, draws["euler"], draws["trans"])
        TCV_O = make_TCO_multiview(TCO_noise, TCO_noise[:, :3, 3], **MULTIVIEW)
        hyp, is_positive = multiview_hypotheses(
            TCV_O, draws["perm"], draws["include"], draws["slot"])
        out = model.train()(
            _rep(batch.images, n_hypotheses), _rep(batch.K, n_hypotheses),
            _rep(batch.obj_ids, n_hypotheses), hyp.reshape(-1, 4, 4), assets,
            meshes.select(_rep(batch.obj_ids, n_hypotheses)), n_iterations=1,
        )
        logits = out.renderings_logits[0, :, 0].reshape(B, n_hypotheses) / logits_temperature
        loss = coarse_classification_loss(logits, is_positive)
        acc = ((logits > 0) == (is_positive > 0.5)).float().mean()
        return loss, {"coarse_acc": acc}

    return LossFn(sample, loss_fn)


def sample_grid_hypotheses(
    TCO_gt: torch.Tensor,  # [B, 4, 4]
    symmetries: torch.Tensor,  # [B, S, 4, 4]
    symmetries_mask: torch.Tensor,  # [B, S]
    grid_R: torch.Tensor,  # [M, 3, 3]
    draws: Draws,  # euler, trans [B, 3]; gidx [B, n - 1] grid indices
    rot_label_thresh_deg: float = 30.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Grid-negative hypotheses of the coarse classifier: slot 0 is the
    noised ground truth, the others the drawn grid rotations at slot 0's
    translation, so they differ only in rotation. Labels are
    `angle < rot_label_thresh_deg`, the angle the symmetry-aware geodesic
    distance to the ground truth.

    Returns (hyp_TCO [B, n, 4, 4], labels [B, n] float, ang [B, n] rad)."""
    TCO_noise = apply_pose_noise(TCO_gt, draws["euler"], draws["trans"])
    R_neg = grid_R[draws["gidx"]]  # [B, n-1, 3, 3]
    T_neg = make_T(R_neg, TCO_noise[:, None, :3, 3])
    hyp_TCO = torch.cat([TCO_noise[:, None], T_neg], dim=1)

    R_eq = torch.einsum("bij,bsjk->bsik", TCO_gt[:, :3, :3], symmetries[..., :3, :3])
    tr = torch.einsum("bnji,bsji->bns", hyp_TCO[:, :, :3, :3], R_eq)
    ang = torch.arccos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0))
    ang = ang.masked_fill(~symmetries_mask[:, None, :], torch.inf).amin(dim=-1)
    labels = (ang < math.radians(rot_label_thresh_deg)).to(TCO_gt.dtype)
    return hyp_TCO, labels, ang


def make_coarse_grid_loss_fn(
    model: PosePredictor,
    assets: RenderAssets,
    meshes: BatchedMeshes,
    n_hypotheses: int = 8,
    euler_deg_std: Sequence[float] = EULER_DEG_STD,
    trans_std: Sequence[float] = TRANS_STD,
    rot_label_thresh_deg: float = 30.0,
    so3_grid_size: int = 576,
) -> LossFn:
    """Coarse training against grid-rotation negatives, the task the
    inference pipeline runs (score a detection x SO(3)-grid hypotheses).
    The multiview protocol lets the classifier read the translation: its
    negatives sit on-axis at distance r while the positive keeps its
    off-axis translation. Here every hypothesis shares one translation."""
    grid_R = torch.from_numpy(load_SO3_grid(so3_grid_size)).to(meshes.points)
    noise = _noise_sampler(euler_deg_std, trans_std)

    def sample(generator, batch):
        draws = noise(generator, batch)
        draws["gidx"] = torch.randint(
            0, grid_R.shape[0], (batch.TCO_gt.shape[0], n_hypotheses - 1),
            generator=generator, device=generator.device)
        return draws

    def loss_fn(batch: PoseTrainingBatch, draws: Draws):
        B, n = batch.TCO_gt.shape[0], n_hypotheses
        inst0 = meshes.select(batch.obj_ids)
        hyp_TCO, labels, ang = sample_grid_hypotheses(
            batch.TCO_gt, inst0.symmetries, inst0.symmetries_mask, grid_R, draws,
            rot_label_thresh_deg=rot_label_thresh_deg,
        )
        out = model.train()(
            _rep(batch.images, n), _rep(batch.K, n), _rep(batch.obj_ids, n),
            hyp_TCO.reshape(B * n, 4, 4), assets, meshes.select(_rep(batch.obj_ids, n)),
            n_iterations=1,
        )
        logits = out.renderings_logits[0, :, 0].reshape(B, n)
        loss = coarse_classification_loss(logits, labels)
        acc = ((logits > 0) == (labels > 0.5)).float().mean()
        # does the best-scored hypothesis lie within the threshold?
        top1 = torch.gather(ang, 1, logits.argmax(dim=1, keepdim=True))[:, 0]
        top1_ok = (top1 < math.radians(rot_label_thresh_deg)).float().mean()
        return loss, {"coarse_acc": acc, "coarse_top1_within_thresh": top1_ok}

    return LossFn(sample, loss_fn)
