"""Flax -> PyTorch weight bridge for the pose predictor.

Turns the variables of a Flax `happypose_tpu` `PosePredictor` with a
ResNet34 backbone — `{"params": ..., "batch_stats": ...}` as nested dicts
of numpy arrays — into a `state_dict` of this package's `PosePredictor`.
Modules are matched by Flax's auto-names (`Conv_k`, `BatchNorm_k`,
`BasicBlockV1_k`) and the predictor's own (`backbone`, `pose_fc`,
`views_logits_head`). Conv kernels go from HWIO to OIHW, dense kernels are
transposed, and BatchNorm `scale`/`bias`/`mean`/`var` become
`weight`/`bias`/`running_mean`/`running_var`; both frameworks use
eps = 1e-5 (`models.backbones.BN_EPS`). This module imports no JAX.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

Tree = Mapping[str, object]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32)))


def _conv(sd: Dict[str, torch.Tensor], name: str, p: Tree) -> None:
    sd[f"{name}.weight"] = _t(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))


def _bn(sd: Dict[str, torch.Tensor], name: str, p: Tree, s: Tree) -> None:
    sd[f"{name}.weight"] = _t(p["scale"])
    sd[f"{name}.bias"] = _t(p["bias"])
    sd[f"{name}.running_mean"] = _t(s["mean"])
    sd[f"{name}.running_var"] = _t(s["var"])
    sd[f"{name}.num_batches_tracked"] = torch.tensor(0)


def _dense(sd: Dict[str, torch.Tensor], name: str, p: Tree) -> None:
    sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).T)
    sd[f"{name}.bias"] = _t(p["bias"])


def resnet_state_dict(params: Tree, stats: Tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """State dict of `models.backbones.ResNet` from a Flax `ResNet`'s
    params and batch stats."""
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, f"{prefix}conv1", params["Conv_0"])
    _bn(sd, f"{prefix}bn1", params["BatchNorm_0"], stats["BatchNorm_0"])
    i = 0
    while f"BasicBlockV1_{i}" in params:
        p, s = params[f"BasicBlockV1_{i}"], stats[f"BasicBlockV1_{i}"]
        name = f"{prefix}blocks.{i}"
        _conv(sd, f"{name}.conv1", p["Conv_0"])
        _bn(sd, f"{name}.bn1", p["BatchNorm_0"], s["BatchNorm_0"])
        _conv(sd, f"{name}.conv2", p["Conv_1"])
        _bn(sd, f"{name}.bn2", p["BatchNorm_1"], s["BatchNorm_1"])
        if "Conv_2" in p:  # projection shortcut
            _conv(sd, f"{name}.downsample.0", p["Conv_2"])
            _bn(sd, f"{name}.downsample.1", p["BatchNorm_2"], s["BatchNorm_2"])
        i += 1
    return sd


def pose_predictor_state_dict(variables: Tree) -> Dict[str, torch.Tensor]:
    """State dict of `models.pose_predictor.PosePredictor` from the Flax
    predictor's variables."""
    params, stats = variables["params"], variables["batch_stats"]
    sd = resnet_state_dict(params["backbone"], stats["backbone"], prefix="backbone.")
    for head in ("pose_fc", "views_logits_head"):
        if head in params:
            _dense(sd, head, params[head])
    return sd
