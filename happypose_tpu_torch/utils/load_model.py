"""Named-model registry + one-call loading (PyTorch port of
`happypose_tpu/utils/load_model.py`). Weights are seeded or given as state
dicts (e.g. carried over from Flax by `utils.weights_from_jax`); reading
the JAX package's checkpoint files needs Flax and is not ported.

Every render goes where its tensors live: a model loaded on a CUDA device
renders with the hand-written CUDA rasterizer, a model on the CPU with its
plain PyTorch version. The entry points of the port (`load_named_model`,
`load_detector`, `ObservationBatch.from_numpy`, `DetectionBatch.from_numpy`,
`MeshDataBase.batched` and `.render_assets`) default to `device="cuda"`: on
a machine without a card they fail with PyTorch's own error unless the
caller asks for `device="cpu"`, as the tests do.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import torch

from happypose_tpu_torch.inference.detector import Detector
from happypose_tpu_torch.inference.pose_estimator import PoseEstimator
from happypose_tpu_torch.inference.types import InferenceConfig
from happypose_tpu_torch.meshes.database import MeshDataBase
from happypose_tpu_torch.models.detector import DetectorConfig, FCOSDetector
from happypose_tpu_torch.models.pose_predictor import (
    PosePredictor,
    PosePredictorConfig,
)


@dataclass
class NamedModelSpec:
    """A named pipeline configuration (the 'megapose-1.0-RGB' analog)."""

    refiner_cfg: PosePredictorConfig
    coarse_cfg: Optional[PosePredictorConfig]
    inference_cfg: InferenceConfig
    requires_depth: bool = False


NAMED_MODELS: Dict[str, NamedModelSpec] = {
    # MegaPose-style novel-object pipeline (coarse classifier + refiner):
    # ResNet34, 240x320 RGB + normals renders, 576-rotation grid, top-5,
    # 5 refiner iterations
    "megapose-RGB": NamedModelSpec(
        refiner_cfg=PosePredictorConfig(render_size=(240, 320), render_normals=True),
        coarse_cfg=PosePredictorConfig(
            render_size=(240, 320), render_normals=True,
            predict_pose_update=False, predict_rendered_views_logits=True,
        ),
        inference_cfg=InferenceConfig(
            n_refiner_iterations=5, SO3_grid_size=576, n_pose_hypotheses=5,
        ),
    ),
    # the JAX package's second MegaPose name; its configs equal megapose-RGB's
    "megapose-RGB-multi-hypothesis": NamedModelSpec(
        refiner_cfg=PosePredictorConfig(render_size=(240, 320)),
        coarse_cfg=PosePredictorConfig(
            render_size=(240, 320), predict_pose_update=False,
            predict_rendered_views_logits=True,
        ),
        inference_cfg=InferenceConfig(
            n_refiner_iterations=5, SO3_grid_size=576, n_pose_hypotheses=5,
        ),
    ),
    # CosyPose-style known-object pipeline (coarse pose model + refiner):
    # WideResNet34, 240x320 RGB renders, 1 coarse + 4 refiner iterations
    "cosypose-RGB": NamedModelSpec(
        refiner_cfg=PosePredictorConfig(
            backbone="wide_resnet34", render_size=(240, 320), render_normals=False,
        ),
        coarse_cfg=PosePredictorConfig(
            backbone="wide_resnet34", render_size=(240, 320), render_normals=False,
        ),
        inference_cfg=InferenceConfig(n_coarse_iterations=1, n_refiner_iterations=4),
    ),
}


def load_named_model(
    name: str,
    mesh_db: MeshDataBase,
    n_points: int = 1000,
    seed: int = 0,
    device="cuda",
    state_dicts: Optional[Mapping[str, Mapping[str, torch.Tensor]]] = None,
) -> PoseEstimator:
    """Build a PoseEstimator for `name` on `device`.

    Weights are fresh and seeded (refiner from `seed`, coarse model, when
    the spec has one, from `seed + 1`, drawn from a `torch.Generator`)
    unless `state_dicts`
    {"refiner": ..., "coarse": ...} gives them, e.g. from
    `utils.weights_from_jax.pose_predictor_state_dict`.
    """
    spec = NAMED_MODELS[name]
    state_dicts = state_dicts or {}

    def build(cfg: PosePredictorConfig, role: str, model_seed: int) -> PosePredictor:
        model = PosePredictor(cfg).init_weights(torch.Generator().manual_seed(model_seed))
        if role in state_dicts:
            model.load_state_dict(state_dicts[role])
        return model.to(device).eval()

    return PoseEstimator(
        refiner=build(spec.refiner_cfg, "refiner", seed),
        coarse=(
            build(spec.coarse_cfg, "coarse", seed + 1) if spec.coarse_cfg else None
        ),
        assets=mesh_db.render_assets(device=device),
        meshes=mesh_db.batched(n_points=n_points, device=device),
        cfg=spec.inference_cfg,
    )


def load_detector(
    cfg: DetectorConfig,
    state_dict: Optional[Mapping[str, torch.Tensor]] = None,
    seed: int = 0,
    device="cuda",
    image_size: Tuple[int, int] = (240, 320),
) -> Detector:
    """Build a `Detector` on `device` that runs at `image_size` (H, W).

    Weights are fresh and seeded from `seed` unless `state_dict` gives
    them, e.g. from `utils.weights_from_jax.detector_state_dict`. Its class
    indices must be the mesh database's object ids."""
    model = FCOSDetector(cfg).init_weights(torch.Generator().manual_seed(seed))
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return Detector(model.to(device), image_size=image_size)
