"""SE(3) transform ops (PyTorch port of `happypose_tpu/lib3d/transforms.py`)."""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from happypose_tpu_torch.lib3d.rotations import euler_to_rotmat, rotmat_from_ortho6d
from happypose_tpu_torch.utils.cuda_graphs import device_constant


def transform_pts(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply rigid transforms to point sets.

    T: [B, 4, 4] or [B, S, 4, 4]; pts: [B, P, 3] -> [B, P, 3] or [B, S, P, 3].
    """
    if T.ndim == 4:
        return (
            torch.einsum("bsij,bpj->bspi", T[..., :3, :3], pts)
            + T[..., None, :3, 3]
        )
    return torch.einsum("bij,bpj->bpi", T[..., :3, :3], pts) + T[:, None, :3, 3]


def make_T(
    R: torch.Tensor, t: torch.Tensor, dtype: Optional[torch.dtype] = None
) -> torch.Tensor:
    """Assemble [..., 4, 4] from R [..., 3, 3] and t [..., 3], in `dtype`
    (default: R's)."""
    dtype = dtype or R.dtype
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3)).to(dtype)
    t = t.expand(batch + (3,)).to(dtype)
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = device_constant((0.0, 0.0, 0.0, 1.0), dtype, R.device).expand(batch + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def invert_transforms(T: torch.Tensor) -> torch.Tensor:
    """Invert rigid transforms [..., 4, 4] without a linear solve."""
    R_inv = T[..., :3, :3].transpose(-1, -2)
    t_inv = -(R_inv @ T[..., :3, 3:4])[..., 0]
    return make_T(R_inv, t_inv)


def pose9d_to_T(pose9d: torch.Tensor) -> torch.Tensor:
    """[..., 9] = (ortho6d, txyz) -> [..., 4, 4]."""
    return make_T(rotmat_from_ortho6d(pose9d[..., :6]), pose9d[..., 6:9])


def T_to_pose9d(T: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] -> [..., 9]: first two columns of R + translation."""
    return torch.cat([T[..., :3, 0], T[..., :3, 1], T[..., :3, 3]], dim=-1)


def normalize_T(T: torch.Tensor) -> torch.Tensor:
    """Re-orthonormalize the rotation block via a 9D round-trip."""
    return pose9d_to_T(T_to_pose9d(T))


def sample_pose_noise(
    generator: torch.Generator,
    batch_size: int,
    euler_deg_std: Sequence[float] = (15.0, 15.0, 15.0),
    trans_std: Sequence[float] = (0.01, 0.01, 0.05),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The draw of `add_pose_noise`: gaussian euler angles [B, 3] (radians)
    and translations [B, 3] (m), on the generator's device."""
    dev = generator.device
    euler = torch.randn(batch_size, 3, generator=generator, device=dev) * (
        torch.tensor(euler_deg_std, device=dev) * (math.pi / 180.0)
    )
    trans = torch.randn(batch_size, 3, generator=generator, device=dev) * torch.tensor(
        trans_std, device=dev
    )
    return euler, trans


def apply_pose_noise(
    TCO: torch.Tensor, euler_rad: torch.Tensor, trans: torch.Tensor
) -> torch.Tensor:
    """Right-multiply the rotation by the euler noise, add the translation
    noise: [B, 4, 4] -> [B, 4, 4]."""
    R = TCO[:, :3, :3] @ euler_to_rotmat(euler_rad.to(TCO.dtype))
    return make_T(R, TCO[:, :3, 3] + trans.to(TCO.dtype))


def add_pose_noise(
    generator: torch.Generator,
    TCO: torch.Tensor,
    euler_deg_std: Sequence[float] = (15.0, 15.0, 15.0),
    trans_std: Sequence[float] = (0.01, 0.01, 0.05),
) -> torch.Tensor:
    """Gaussian SE(3) noise on poses (the refiner's training input): a draw
    from `generator`, then `apply_pose_noise`."""
    euler, trans = sample_pose_noise(generator, TCO.shape[0], euler_deg_std, trans_std)
    return apply_pose_noise(TCO, euler, trans)
