"""Render-and-compare pose predictor (PyTorch port of
`happypose_tpu/models/pose_predictor.py`).

One iteration: crop the observation around the reprojected model points,
render the object at the current pose in the crop camera (the hand-written
CUDA rasterizer for CUDA tensors), run the backbone (ResNet34 for
MegaPose, WideResNet18/34 for CosyPose; EfficientNet-B3 or FlowNetS by
name) on [crop (with its depth channel
when `input_depth`), rgb render, normals and depth renders when
configured; depth channels normalized by the reference point's depth],
then either apply the SE(3) update of the pose
head (ortho6d or quaternion; the refiner and the CosyPose coarse model) or
return the rendered-view logits (MegaPose coarse hypothesis classifier).
The pose head starts at the identity update, so an untrained refiner is a
no-op.

Training differentiates the network only. Each iteration detaches its input
pose, so iteration k + 1 does not train iteration k, and renders under
`torch.no_grad()`: the rasterizer has no backward pass, in the JAX package
(`stop_gradient` on the pose and the renders) as here, so the CUDA kernel
gets no `torch.autograd.Function` and runs forward only. With
`compute_dtype="bfloat16"` the crop's matrix products and the backbone run
in bfloat16 (`torch.autocast`); the parameters, the BatchNorm statistics
and the heads stay in float32, as Flax promotes the features to the heads'
float32.

An iteration runs under the spans `predictor.crop`, `predictor.render`
(the views' cameras, the render and its normalization), `predictor.net`
(backbone and heads) and `predictor.update` (the SE(3) update).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields
from typing import Optional, Tuple

import torch
from torch import nn

from happypose_tpu_torch.lib3d.camera import (
    get_K_crop_resize,
    masked_boxes_from_uv,
    project_points_robust,
)
from happypose_tpu_torch.lib3d.cropping import deepim_boxes
from happypose_tpu_torch.lib3d.multiview_geom import make_TCO_multiview
from happypose_tpu_torch.lib3d.pose_update import pose_update_with_reference_point
from happypose_tpu_torch.lib3d.rotations import quat_to_rotmat, rotmat_from_ortho6d
from happypose_tpu_torch.lib3d.transforms import make_T, normalize_T
from happypose_tpu_torch.meshes.database import BatchedMeshes, RenderAssets
from happypose_tpu_torch.models.backbones import (
    EfficientNetB3,
    set_bn_axis_name,
    FlowNetS,
    ResNet34,
    WideResNet18,
    WideResNet34,
)
from happypose_tpu_torch.ops.crop_resize import crop_images_matmul
from happypose_tpu_torch.ops.rasterizer_fused import render_batch_fused
from happypose_tpu_torch.utils.profiling import annotate

# head outputs of the identity update: ortho6d (x, y columns) + vxvyvz, and
# quaternion (xyzw) + vxvyvz, with vz = 1 (no depth change)
_IDENTITY_POSE = {
    "ortho6d": (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0),
    "quaternion": (0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 1.0),
}
_BACKBONES = {
    "resnet34": ResNet34,
    "wide_resnet18": WideResNet18,
    "wide_resnet34": WideResNet34,
    "efficientnet_b3": EfficientNetB3,
    "flownet": FlowNetS,
}


@dataclass(frozen=True)
class PosePredictorConfig:
    """Static model configuration."""

    backbone: str = "resnet34"  # resnet34 | wide_resnet18 | wide_resnet34
    #   | efficientnet_b3 | flownet
    render_size: Tuple[int, int] = (240, 320)
    multiview_type: str = "TCO"  # TCO | front_1view | front_3views | sphere_26views
    remove_TCO_rendering: bool = False
    views_inplane_rotations: bool = False
    render_normals: bool = True
    render_depth: bool = False
    input_depth: bool = False
    # tCR_scale | tCR_scale_clamp_center | tCR_center_clamp | none
    depth_normalization_type: str = "tCR_scale_clamp_center"
    predict_pose_update: bool = True
    predict_rendered_views_logits: bool = False
    # ortho6d (9 outputs) | quaternion (7 outputs, the CosyPose models' head)
    pose_head: str = "ortho6d"
    crop_lamb: float = 1.4
    compute_dtype: str = "float32"  # float32 | bfloat16 (the backbone and the crop)
    # the mesh axis whose ranks share the backbone's BatchNorm statistics in
    # train mode (the data-parallel step binds its group); None: this rank's
    bn_axis_name: Optional[str] = None

    @property
    def n_views(self) -> int:
        if self.multiview_type == "TCO":
            n = 1
        else:
            base = {"front_1view": 1, "front_3views": 3, "front_5views": 5,
                    "sphere_26views": 26}[self.multiview_type]
            n = base + (0 if self.remove_TCO_rendering else 1)
        return n * (4 if self.views_inplane_rotations else 1)

    @property
    def n_render_channels(self) -> int:
        return 3 + (3 if self.render_normals else 0) + (1 if self.render_depth else 0)


@dataclass
class PoseOutputs:
    """Per-iteration outputs, leading axis = iteration."""

    TCO_input: torch.Tensor  # [n_iter, B, 4, 4]
    TCO_output: torch.Tensor  # [n_iter, B, 4, 4]
    K_crop: torch.Tensor  # [n_iter, B, 3, 3]
    boxes_rend: torch.Tensor  # [n_iter, B, 4]
    boxes_crop: torch.Tensor  # [n_iter, B, 4]
    tCR: torch.Tensor  # [n_iter, B, 3]
    pose_raw: torch.Tensor  # [n_iter, B, 9] (ortho6d) or [n_iter, B, 7] (quaternion)
    renderings_logits: torch.Tensor  # [n_iter, B, n_views]


class PosePredictor(nn.Module):
    def __init__(self, cfg: PosePredictorConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = _BACKBONES[cfg.backbone](
            n_inputs=3 + (1 if cfg.input_depth else 0) + cfg.n_views * cfg.n_render_channels
        )
        set_bn_axis_name(self.backbone, cfg.bn_axis_name)
        n_features = self.backbone.n_features
        if cfg.predict_pose_update:
            self.pose_fc = nn.Linear(n_features, len(_IDENTITY_POSE[cfg.pose_head]))
        if cfg.predict_rendered_views_logits:
            self.views_logits_head = nn.Linear(n_features, cfg.n_views)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "PosePredictor":
        """Fresh seeded weights: LeCun-normal convolutions and linear layers
        (the Flax default), unit BatchNorm, and a pose head that predicts the
        identity update (kernel ~ N(0, 1e-3), identity bias)."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                m.weight.copy_(
                    torch.randn(m.weight.shape, generator=generator) / math.sqrt(fan_in)
                )
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
        if self.cfg.predict_pose_update:
            self.pose_fc.weight.copy_(
                torch.randn(self.pose_fc.weight.shape, generator=generator) * 1e-3
            )
            self.pose_fc.bias.copy_(torch.tensor(_IDENTITY_POSE[self.cfg.pose_head]))
        return self

    # ---------- geometry ----------

    def _crop_inputs(self, images, K, TCO, tCR, points, points_mask):
        """Crop around the reprojected model points, anchored at tCR.
        Returns (images_crop [B, C, h, w], K_crop, boxes_rend, boxes_crop)."""
        H, W = images.shape[-2:]
        uv = project_points_robust(points, K, TCO)
        boxes_rend = masked_boxes_from_uv(uv, points_mask)
        TCR = make_T(TCO[:, :3, :3], tCR)
        center = project_points_robust(torch.zeros_like(points[:, :1]), K, TCR)
        boxes_crop = deepim_boxes(
            center, boxes_rend, boxes_rend, lamb=self.cfg.crop_lamb, im_size=(H, W)
        )
        images_crop = crop_images_matmul(
            images, boxes_crop, output_size=self.cfg.render_size, sampling_ratio=4,
            matmul_dtype=self._lowp_dtype,
        )
        K_crop = get_K_crop_resize(K, boxes_crop, (H, W), self.cfg.render_size)
        return images_crop, K_crop, boxes_rend, boxes_crop

    def _compute_KV_crop(self, im_hw, K, TCV_O, points, points_mask):
        """Crop intrinsics of every rendered view [B, V, 3, 3]."""
        B, V = TCV_O.shape[:2]
        K_rep = K.repeat_interleave(V, dim=0)
        T_flat = TCV_O.reshape(B * V, 4, 4)
        pts_rep = points.repeat_interleave(V, dim=0)
        uv = project_points_robust(pts_rep, K_rep, T_flat)
        boxes_rend = masked_boxes_from_uv(uv, points_mask.repeat_interleave(V, dim=0))
        center = project_points_robust(torch.zeros_like(pts_rep[:, :1]), K_rep, T_flat)
        boxes = deepim_boxes(
            center, boxes_rend, boxes_rend, lamb=self.cfg.crop_lamb, im_size=im_hw
        )
        return get_K_crop_resize(K_rep, boxes, im_hw, self.cfg.render_size).reshape(B, V, 3, 3)

    def _render_views(self, assets, obj_ids, TCV_O, KV_crop):
        """Render every view -> [B, V*C, h, w] channels-first."""
        B, V = TCV_O.shape[:2]
        out = render_batch_fused(
            assets,
            obj_ids.repeat_interleave(V, dim=0),
            TCV_O.reshape(B * V, 4, 4),
            KV_crop.reshape(B * V, 3, 3),
            resolution=self.cfg.render_size,
        )
        chans = [out.rgb]
        if self.cfg.render_normals:
            chans.append(out.normals)
        if self.cfg.render_depth:
            chans.append(out.depth[..., None])
        r = torch.cat(chans, dim=-1).permute(0, 3, 1, 2)  # [BV, C, h, w]
        return r.reshape(B, -1, *r.shape[-2:])

    def _normalize_depth(self, depth, tCR):
        """depth [B, n, h, w] relative to the reference point's depth tCR_z."""
        z = tCR[:, 2, None, None, None]
        t = self.cfg.depth_normalization_type
        if t == "tCR_scale":
            return depth / z
        if t == "tCR_scale_clamp_center":
            return torch.clamp(depth / z, 0.0, 2.0) - 1.0
        if t == "tCR_center_clamp":
            return torch.clamp(depth - z, -2.0, 2.0)
        if t == "none":
            return depth
        raise ValueError(f"unknown depth_normalization_type: {t}")

    def _normalize_images(self, images_crop, renders, tCR):
        """Normalize the crop's depth channel and every view's depth render."""
        cfg = self.cfg
        if cfg.input_depth:
            images_crop = torch.cat(
                [images_crop[:, :3], self._normalize_depth(images_crop[:, 3:4], tCR)], dim=1
            )
        if cfg.render_depth:
            B, _, h, w = renders.shape
            r = renders.reshape(B, cfg.n_views, cfg.n_render_channels, h, w)
            renders = torch.cat(
                [r[:, :, :-1], self._normalize_depth(r[:, :, -1], tCR)[:, :, None]], dim=2
            ).reshape(B, -1, h, w)
        return images_crop, renders

    @property
    def _lowp_dtype(self):
        return torch.bfloat16 if self.cfg.compute_dtype == "bfloat16" else None

    def _features(self, x: torch.Tensor) -> torch.Tensor:
        """Backbone features [B, n_features] in float32."""
        if self._lowp_dtype is None:
            return self.backbone(x)
        with torch.autocast(device_type=x.device.type, dtype=self._lowp_dtype):
            feats = self.backbone(x)
        return feats.float()

    # ---------- one iteration ----------

    def _iteration(self, images, K, obj_ids, TCO_input, assets, meshes):
        cfg = self.cfg
        B = TCO_input.shape[0]
        with annotate("predictor.crop"):
            TCO_input = normalize_T(TCO_input).detach()
            tCR = TCO_input[:, :3, 3]
            images_crop, K_crop, boxes_rend, boxes_crop = self._crop_inputs(
                images, K, TCO_input, tCR, meshes.points, meshes.points_mask
            )
        with annotate("predictor.render"):
            TCV_O = make_TCO_multiview(
                TCO_input, tCR,
                multiview_type=cfg.multiview_type,
                remove_TCO_rendering=cfg.remove_TCO_rendering,
                views_inplane_rotations=cfg.views_inplane_rotations,
            )
            KV_crop = self._compute_KV_crop(
                images.shape[-2:], K, TCV_O, meshes.points, meshes.points_mask
            )
            if not cfg.remove_TCO_rendering:
                KV_crop = torch.cat([K_crop[:, None], KV_crop[:, 1:]], dim=1)
            with torch.no_grad():
                renders = self._render_views(assets, obj_ids, TCV_O, KV_crop)
            images_crop, renders = self._normalize_images(images_crop, renders, tCR)

        with annotate("predictor.net"):
            feats = self._features(torch.cat([images_crop, renders], dim=1))
            pose_raw = self.pose_fc(feats) if cfg.predict_pose_update else None
            if cfg.predict_rendered_views_logits:
                logits = self.views_logits_head(feats)
            else:
                logits = TCO_input.new_zeros(B, cfg.n_views)
        with annotate("predictor.update"):
            if cfg.predict_pose_update:
                if cfg.pose_head == "quaternion":
                    dR = quat_to_rotmat(pose_raw[:, 0:4])
                    vxvyvz = pose_raw[:, 4:7]
                else:
                    dR = rotmat_from_ortho6d(pose_raw[:, 0:6])
                    vxvyvz = pose_raw[:, 6:9]
                TCO_output = pose_update_with_reference_point(
                    TCO_input, K_crop, vxvyvz, dR, tCR
                )
            else:
                pose_raw = TCO_input.new_zeros(B, 9)
                TCO_output = TCO_input
        return PoseOutputs(
            TCO_input=TCO_input, TCO_output=TCO_output, K_crop=K_crop,
            boxes_rend=boxes_rend, boxes_crop=boxes_crop, tCR=tCR,
            pose_raw=pose_raw, renderings_logits=logits,
        )

    def forward(
        self,
        images: torch.Tensor,  # [B, 3(+1), H, W], float in [0, 1]
        K: torch.Tensor,  # [B, 3, 3]
        obj_ids: torch.Tensor,  # [B]
        TCO_input: torch.Tensor,  # [B, 4, 4]
        assets: RenderAssets,
        meshes: BatchedMeshes,  # per instance (select(obj_ids))
        n_iterations: int = 1,
    ) -> PoseOutputs:
        if not self.cfg.input_depth:
            images = images[:, :3]
        outs = []
        TCO = TCO_input
        for _ in range(n_iterations):
            o = self._iteration(images, K, obj_ids, TCO, assets, meshes)
            outs.append(o)
            TCO = o.TCO_output
        return PoseOutputs(
            **{f.name: torch.stack([getattr(o, f.name) for o in outs])
               for f in fields(PoseOutputs)}
        )
