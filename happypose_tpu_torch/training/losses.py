"""Pose training losses (PyTorch port of `happypose_tpu/training/losses.py`).

The disentangled refiner losses evaluate three hypothetical poses, each
the ground truth with one block taken from the network's update (rotation,
image-space xy, depth), so each output gets its own gradient. A block is
put in with `torch.where` on a [4, 4] mask: nothing writes into a tensor
autograd still needs.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from happypose_tpu_torch.lib3d.distances import loss_CO_symmetric
from happypose_tpu_torch.lib3d.pose_update import pose_update_with_reference_point
from happypose_tpu_torch.lib3d.rotations import quat_to_rotmat, rotmat_from_ortho6d
from happypose_tpu_torch.lib3d.transforms import make_T
from happypose_tpu_torch.utils.cuda_graphs import device_constant


def _block(rows: Sequence[int], cols: Sequence[int], device) -> torch.Tensor:
    """[4, 4] bool mask of the (rows, cols) block, a kept device constant
    (no copy from the host inside a train step's capture)."""
    mask = tuple(tuple(i in rows and j in cols for j in range(4)) for i in range(4))
    return device_constant(mask, torch.bool, device)


def _symmetric_parts(TCO_possible_gt, preds, points, points_mask):
    losses = [
        loss_CO_symmetric(TCO_possible_gt, T, points, points_mask=points_mask)[0]
        for T in preds
    ]
    loss = losses[0] + losses[1] + losses[2]
    return loss, {"loss_orn": losses[0], "loss_xy": losses[1], "loss_z": losses[2],
                  "loss": loss}


def _mask_symmetries(TCO_possible_gt, sym_mask):
    """Invalid symmetry slots are replaced by slot 0."""
    if sym_mask is None:
        return TCO_possible_gt
    return torch.where(sym_mask[..., None, None], TCO_possible_gt, TCO_possible_gt[:, :1])


def loss_refiner_CO_disentangled_reference_point(
    TCO_possible_gt: torch.Tensor,  # [B, S, 4, 4] symmetry-expanded GT
    TCO_input: torch.Tensor,  # [B, 4, 4]
    refiner_outputs: torch.Tensor,  # [B, 9]
    K_crop: torch.Tensor,  # [B, 3, 3]
    points: torch.Tensor,  # [B, P, 3]
    tCR: torch.Tensor,  # [B, 3]
    points_mask: Optional[torch.Tensor] = None,
    sym_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Disentangled L1 point-matching loss. Returns (loss [B], parts)."""
    dR = rotmat_from_ortho6d(refiner_outputs[:, 0:6])
    vxvy = refiner_outputs[:, 6:8]
    vz = refiner_outputs[:, 8:9]
    TCO_gt = TCO_possible_gt[:, 0]
    fxfy = torch.stack([K_crop[:, 0, 0], K_crop[:, 1, 1]], dim=-1)

    # ground-truth values of the disentangled outputs
    dR_gt = TCO_gt[:, :3, :3] @ TCO_input[:, :3, :3].transpose(-1, -2)
    tCO_gt = TCO_gt[:, :3, 3]
    tCR_out_gt = tCO_gt - (dR_gt @ (TCO_input[:, :3, 3] - tCR)[..., None])[..., 0]
    vz_gt = tCR_out_gt[:, 2:3] / tCR[:, 2:3]
    vxvy_gt = fxfy * (tCR_out_gt[:, 0:2] / tCR_out_gt[:, 2:3] - tCR[:, 0:2] / tCR[:, 2:3])
    TCO_possible_gt = _mask_symmetries(TCO_possible_gt, sym_mask)

    def masked_update(vxvy_u, vz_u, dR_u, rows, cols):
        """GT pose with only the (rows, cols) block taken from the update."""
        upd = pose_update_with_reference_point(
            TCO_input, K_crop, torch.cat([vxvy_u, vz_u], dim=-1), dR_u, tCR
        )
        return torch.where(_block(rows, cols, upd.device), upd, TCO_gt)

    preds = (
        masked_update(vxvy_gt, vz_gt, dR, (0, 1, 2), (0, 1, 2)),  # network rotation
        masked_update(vxvy, vz_gt, dR_gt, (0, 1), (3,)),  # network vxvy
        masked_update(vxvy_gt, vz, dR_gt, (2,), (3,)),  # network vz
    )
    return _symmetric_parts(TCO_possible_gt, preds, points, points_mask)


def loss_refiner_CO_disentangled(
    TCO_possible_gt: torch.Tensor,  # [B, S, 4, 4] symmetry-expanded GT
    TCO_input: torch.Tensor,  # [B, 4, 4]
    refiner_outputs: torch.Tensor,  # [B, 9] ortho6d or [B, 7] quaternion
    K_crop: torch.Tensor,  # [B, 3, 3]
    points: torch.Tensor,  # [B, P, 3]
    points_mask: Optional[torch.Tensor] = None,
    sym_mask: Optional[torch.Tensor] = None,
    rotation_param: str = "ortho6d",  # ortho6d | quaternion
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """CosyPose's object-centre disentangled loss (no reference point): the
    three hypothetical updates are anchored at the input pose's own
    translation, xy by the image-space offset scaled to the GT depth, z by
    `vz * z_input`."""
    if rotation_param == "quaternion":
        dR = quat_to_rotmat(refiner_outputs[:, 0:4])
        vxvyvz = refiner_outputs[:, 4:7]
    else:
        dR = rotmat_from_ortho6d(refiner_outputs[:, 0:6])
        vxvyvz = refiner_outputs[:, 6:9]
    TCO_gt = TCO_possible_gt[:, 0]
    TCO_possible_gt = _mask_symmetries(TCO_possible_gt, sym_mask)

    z_gt = TCO_gt[:, 2, 3:4]
    z_input = TCO_input[:, 2, 3:4]
    fxfy = torch.stack([K_crop[:, 0, 0], K_crop[:, 1, 1]], dim=-1)
    xy = (vxvyvz[:, :2] / fxfy + TCO_input[:, :2, 3] / z_input) * z_gt
    upd = make_T(dR @ TCO_input[:, :3, :3], torch.cat([xy, vxvyvz[:, 2:3] * z_input], dim=-1))
    preds = tuple(
        torch.where(_block(rows, cols, upd.device), upd, TCO_gt)
        for rows, cols in (((0, 1, 2), (0, 1, 2)), ((0, 1), (3,)), ((2,), (3,)))
    )
    return _symmetric_parts(TCO_possible_gt, preds, points, points_mask)


def coarse_classification_loss(
    logits: torch.Tensor,  # [B, n_views] or [B]
    positive_mask: torch.Tensor,  # same shape, 1.0 where the view is the positive
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sigmoid BCE over rendered-view logits. Returns the mean (scalar)."""
    per = -(positive_mask * F.logsigmoid(logits) + (1.0 - positive_mask) * F.logsigmoid(-logits))
    if valid is None:
        return per.mean()
    w = valid.to(per.dtype)
    if w.ndim < per.ndim:
        w = w[..., None]
    w = w.expand(per.shape)
    return (per * w).sum() / torch.clamp(w.sum(), min=1.0)
