"""3D math on tensors: rotations, SE(3) transforms, camera geometry, crops,
pose init/update and SO(3) grids. Re-exports the names the JAX package's
`lib3d` exports."""

from happypose_tpu_torch.lib3d.rotations import (
    rotmat_from_ortho6d,
    quat_to_rotmat,
    rotmat_to_quat,
    axis_angle_to_rotmat,
    euler_to_rotmat,
    geodesic_distance,
)
from happypose_tpu_torch.lib3d.transforms import (
    transform_pts,
    invert_transforms,
    make_T,
    pose9d_to_T,
    T_to_pose9d,
    normalize_T,
    add_pose_noise,
)
from happypose_tpu_torch.lib3d.camera import (
    project_points,
    project_points_robust,
    boxes_from_uv,
    get_K_crop_resize,
    cropresize_backtransform_points2d,
)
from happypose_tpu_torch.lib3d.cropping import deepim_boxes, deepim_crops, deepim_crops_robust
from happypose_tpu_torch.lib3d.pose_init import (
    TCO_init_from_boxes,
    TCO_init_from_boxes_autodepth_with_R,
    TCO_init_from_boxes_zup_autodepth,
)
from happypose_tpu_torch.lib3d.pose_update import pose_update_with_reference_point
from happypose_tpu_torch.lib3d.distances import (
    dists_add,
    dists_add_symmetric,
    compute_ADD_L1_loss,
    compute_ADDS_loss,
    symmetric_distance_batched,
)
from happypose_tpu_torch.lib3d.symmetries import (
    DiscreteSymmetry,
    ContinuousSymmetry,
    make_symmetries_poses,
)

__all__ = [k for k in dir() if not k.startswith("_")]
