"""SE(3) pose update from network outputs (PyTorch port of
`happypose_tpu/lib3d/pose_update.py`): image-space translation (vx, vy) in
focal-normalized units, multiplicative depth update vz, and a rotation
applied about the anchor point tCR."""

from __future__ import annotations

import torch

from happypose_tpu_torch.lib3d.transforms import make_T


def pose_update_with_reference_point(
    TCO: torch.Tensor,
    K: torch.Tensor,
    vxvyvz: torch.Tensor,
    dRCO: torch.Tensor,
    tCR: torch.Tensor,
) -> torch.Tensor:
    """TCO [B, 4, 4], crop intrinsics K [B, 3, 3], network translation
    outputs vxvyvz [B, 3], rotation update dRCO [B, 3, 3] (camera frame),
    reference point tCR [B, 3] -> updated pose [B, 4, 4]."""
    zsrc = tCR[:, 2:3]
    ztgt = vxvyvz[:, 2:3] * zsrc
    fxfy = torch.stack([K[:, 0, 0], K[:, 1, 1]], dim=-1)
    tCR_out_xy = (vxvyvz[:, 0:2] / fxfy + tCR[:, 0:2] / zsrc) * ztgt
    tCR_out = torch.cat([tCR_out_xy, ztgt], dim=-1)
    tCO_out = (dRCO @ (TCO[:, :3, 3] - tCR)[..., None])[..., 0] + tCR_out
    return make_T(dRCO @ TCO[:, :3, :3], tCO_out)


def apply_imagespace_predictions(
    TCO: torch.Tensor, K: torch.Tensor, vxvyvz: torch.Tensor, dRCO: torch.Tensor
) -> torch.Tensor:
    """The CosyPose update: the anchor is the object origin (tCR = tCO)."""
    return pose_update_with_reference_point(TCO, K, vxvyvz, dRCO, TCO[:, :3, 3])
