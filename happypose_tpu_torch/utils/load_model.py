"""Named-model registry + one-call loading (PyTorch port of
`happypose_tpu/utils/load_model.py`). Weights are seeded, given as state
dicts (e.g. carried over from Flax by `utils.weights_from_jax`), or read
from a run directory: `config.json` (the JAX package's keys: `backbone`,
`render_size`, `bf16` for a pose model; `fpn_channels`, `image_size` for a
detector; `"kind": "mask_rcnn"` and `models.mask_rcnn.config_to_dict`'s
settings for a Mask R-CNN) beside the weights, in whichever of two formats the directory
holds (`read_state_dict`):
- the port's: `state_dict.pt` (`torch.save` of a state dict, read with
  `weights_only=True`; `save_run_dir` writes it; a training run,
  `utils/checkpoint.py`, adds `state_dict_last.pt`);
- the JAX package's: `checkpoint.msgpack` (Flax's msgpack of a TrainState
  or of `{"params", "batch_stats"}`, decoded by `utils.flax_msgpack`
  without Flax and carried over by `utils.weights_from_jax`; its training
  runs add `checkpoint_last.msgpack`; `save_flax_run_dir` writes one).
A corrupt first file falls back to its `_last` copy.

Every render goes where its tensors live: a model loaded on a CUDA device
renders with the hand-written CUDA rasterizer, a model on the CPU with its
plain PyTorch version. The entry points of the port (`load_named_model`,
`load_detector`, `ObservationBatch.from_numpy`, `DetectionBatch.from_numpy`,
`MeshDataBase.batched` and `.render_assets`) default to `device="cuda"`: on
a machine without a card they fail with PyTorch's own error unless the
caller asks for `device="cpu"`, as the tests do.
"""

from __future__ import annotations

import json
import pickle
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Mapping, Optional, Tuple, Union

import torch

from happypose_tpu_torch.inference.detector import Detector
from happypose_tpu_torch.inference.pose_estimator import PoseEstimator
from happypose_tpu_torch.inference.types import InferenceConfig
from happypose_tpu_torch.meshes.database import MeshDataBase
from happypose_tpu_torch.models import mask_rcnn
from happypose_tpu_torch.models.detector import DetectorConfig, FCOSDetector
from happypose_tpu_torch.models.mask_rcnn import MaskRCNN, MaskRCNNConfig
from happypose_tpu_torch.models.pose_predictor import (
    PosePredictor,
    PosePredictorConfig,
)
from happypose_tpu_torch.utils import flax_msgpack
from happypose_tpu_torch.utils.logging import get_logger
from happypose_tpu_torch.utils.weights_from_jax import (
    detector_state_dict,
    pose_predictor_state_dict,
)

logger = get_logger(__name__)


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


STATE_DICT_FILE = "state_dict.pt"
FLAX_FILE = "checkpoint.msgpack"  # the JAX package's `utils/checkpoint.py`
# what `torch.load` and `flax_msgpack.read_file` raise for a truncated or corrupt file
UNREADABLE = (RuntimeError, EOFError, OSError, pickle.UnpicklingError,
              flax_msgpack.FlaxMsgpackError)


def save_run_dir(
    run_dir: Union[str, Path],
    state_dict: Mapping[str, torch.Tensor],
    config: Mapping[str, object],
) -> Path:
    """Write a run directory of the port: `config.json` + `state_dict.pt`."""
    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    (run_dir / "config.json").write_text(json.dumps(dict(config)))
    torch.save(
        {k: v.detach().cpu() for k, v in state_dict.items()},
        run_dir / STATE_DICT_FILE,
    )
    return run_dir


def last_copy(path: Path) -> Path:
    """`state_dict.pt` -> `state_dict_last.pt`: the copy a training run
    writes after the first file, read when the first is corrupt."""
    return path.with_name(f"{path.stem}_last{path.suffix}")


def weights_format(run_dir: Union[str, Path]) -> str:
    """"pt" when the run directory holds `state_dict.pt` (or its `_last`
    copy), else "flax" when it holds `checkpoint.msgpack` (or its `_last`
    copy); raises `FileNotFoundError` naming both otherwise."""
    run_dir = Path(run_dir)
    for fmt, name in (("pt", STATE_DICT_FILE), ("flax", FLAX_FILE)):
        if (run_dir / name).exists() or last_copy(run_dir / name).exists():
            return fmt
    raise FileNotFoundError(
        f"no {STATE_DICT_FILE} and no {FLAX_FILE} in {run_dir}: a run directory is "
        "config.json beside the port's state_dict.pt or the JAX package's checkpoint.msgpack"
    )


def read_first(run_dir: Union[str, Path], name: str, read):
    """`read(path)` of `run_dir/name`, or of its `_last` copy when the first
    is missing or unreadable; the last error when neither can be read."""
    path = Path(run_dir) / name
    err = None
    for p in (path, last_copy(path)):
        if not p.exists():
            continue
        try:
            return read(p)
        except UNREADABLE as e:
            logger.warning(f"{p} unreadable ({e}); trying its _last copy")
            err = e
    raise err if err is not None else FileNotFoundError(f"no {name} in {run_dir}")


def flax_tree_state_dict(tree: Mapping) -> Dict[str, torch.Tensor]:
    """The state dict of a decoded Flax checkpoint (a TrainState's other
    keys, `step` and `opt_state`, are not read): a detector's when its
    params hold the `ResNet50FPN_0` backbone, else a pose predictor's."""
    if "ResNet50FPN_0" in tree["params"]:
        return detector_state_dict(tree)
    return pose_predictor_state_dict(tree)


def read_state_dict(run_dir: Union[str, Path]) -> Dict[str, torch.Tensor]:
    """The weights of a run directory as a state dict of the port: from
    `state_dict.pt`, else from the JAX package's `checkpoint.msgpack`
    through the weight bridge (`weights_format`)."""
    if weights_format(run_dir) == "pt":
        return read_first(run_dir, STATE_DICT_FILE,
                          lambda p: torch.load(p, map_location="cpu", weights_only=True))
    return flax_tree_state_dict(read_first(run_dir, FLAX_FILE, flax_msgpack.read_file))


def save_flax_run_dir(
    run_dir: Union[str, Path],
    variables: Mapping[str, object],
    config: Mapping[str, object],
) -> Path:
    """Write a run directory in the JAX package's format: `config.json` +
    `checkpoint.msgpack` of Flax `variables` (e.g.
    `utils.weights_from_jax.model_variables(model)`), which the JAX
    package's `load_named_model` and `load_detector` read."""
    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    (run_dir / "config.json").write_text(json.dumps(dict(config), default=str))
    flax_msgpack.write_file(run_dir / FLAX_FILE, dict(variables))
    return run_dir


def config_from_run_dir(run_dir: Union[str, Path], coarse: bool) -> PosePredictorConfig:
    """The pose model of a run directory's `config.json`: a refiner, or
    with `coarse` a hypothesis classifier (`backbone`, `render_size`;
    `bf16` -> `compute_dtype="bfloat16"`)."""
    c = json.loads((Path(run_dir) / "config.json").read_text())
    return PosePredictorConfig(
        backbone=c.get("backbone", "wide_resnet18"),
        render_size=tuple(c.get("render_size", (120, 160))),
        compute_dtype="bfloat16" if c.get("bf16") else "float32",
        predict_pose_update=not coarse,
        predict_rendered_views_logits=coarse,
    )


def spec_from_checkpoints(
    checkpoint_dirs: Mapping[str, Union[str, Path]],
    inference_cfg: Optional[InferenceConfig] = None,
) -> NamedModelSpec:
    """Build a spec from run directories' own saved configs, so any run can
    be evaluated without a matching named spec."""
    return NamedModelSpec(
        refiner_cfg=config_from_run_dir(checkpoint_dirs["refiner"], coarse=False),
        coarse_cfg=(
            config_from_run_dir(checkpoint_dirs["coarse"], coarse=True)
            if "coarse" in checkpoint_dirs else None
        ),
        inference_cfg=inference_cfg or InferenceConfig(),
    )


def load_named_model(
    name: Union[str, NamedModelSpec],
    mesh_db: MeshDataBase,
    checkpoint_dirs: Optional[Mapping[str, Union[str, Path]]] = None,
    n_points: int = 1000,
    seed: int = 0,
    device="cuda",
    state_dicts: Optional[Mapping[str, Mapping[str, torch.Tensor]]] = None,
) -> PoseEstimator:
    """Build a PoseEstimator for `name` (a key of `NAMED_MODELS`, or a spec
    of the caller's own: overrides are handed on, never written into the
    registry) on `device`.

    Weights are fresh and seeded (refiner from `seed`, coarse model, when
    the spec has one, from `seed + 1`, drawn from a `torch.Generator`)
    unless `state_dicts` {"refiner": ..., "coarse": ...} gives them, e.g.
    from `utils.weights_from_jax.pose_predictor_state_dict`, or
    `checkpoint_dirs` {"refiner": dir, "coarse": dir} names run directories
    to read them from.
    """
    spec = name if isinstance(name, NamedModelSpec) else NAMED_MODELS[name]
    state_dicts = dict(state_dicts or {})
    for role, run_dir in (checkpoint_dirs or {}).items():
        state_dicts.setdefault(role, read_state_dict(run_dir))

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
    cfg: Union[DetectorConfig, MaskRCNNConfig, str, Path],
    n_classes: Optional[int] = None,
    state_dict: Optional[Mapping[str, torch.Tensor]] = None,
    seed: int = 0,
    device="cuda",
    image_size: Tuple[int, int] = (240, 320),
) -> Detector:
    """Build a `Detector` on `device` that runs at `image_size` (H, W).

    `cfg` is a `DetectorConfig` (the port's FCOS), a `MaskRCNNConfig`, or a
    run directory with `n_classes` (as the JAX package's
    `load_detector(run_dir, n_classes)`): its `config.json` gives FCOS's
    `fpn_channels` (default 64) and `image_size`, or with
    `"kind": "mask_rcnn"` a Mask R-CNN's settings (`n_classes + 1` classes
    where it gives none); its `state_dict.pt` or the JAX package's
    `checkpoint.msgpack` the weights. Otherwise weights are fresh and
    seeded from `seed` unless `state_dict` gives them, e.g. from
    `utils.weights_from_jax.detector_state_dict`. The detector's class
    indices (Mask R-CNN's minus the background) must be the mesh
    database's object ids."""
    if not isinstance(cfg, (DetectorConfig, MaskRCNNConfig)):
        run_dir = Path(cfg)
        if n_classes is None:
            raise ValueError("a detector run directory needs n_classes")
        c: Dict[str, object] = {}
        cfg_file = run_dir / "config.json"
        if cfg_file.exists():
            c = json.loads(cfg_file.read_text())
        if c.get("image_size"):
            image_size = tuple(int(v) for v in c["image_size"])
        if c.get("kind") == mask_rcnn.KIND:
            cfg = mask_rcnn.config_from_dict({"n_classes": n_classes + 1, **c})
        else:
            cfg = DetectorConfig(n_classes=n_classes, fpn_channels=int(c.get("fpn_channels", 64)))
        state_dict = read_state_dict(run_dir)
    kind = MaskRCNN if isinstance(cfg, MaskRCNNConfig) else FCOSDetector
    model = kind(cfg).init_weights(torch.Generator().manual_seed(seed))
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return Detector(model.to(device), image_size=image_size)
