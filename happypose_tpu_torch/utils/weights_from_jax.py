"""Flax -> PyTorch weight bridge for the pose predictor and the detector.

Turns the variables of a Flax `happypose_tpu` `PosePredictor` (ResNet34,
WideResNet, EfficientNet or FlowNetS backbone) or `FCOSDetector` —
`{"params": ..., "batch_stats": ...}` as nested dicts of numpy arrays —
into a `state_dict` of this package's module of the same name. Modules are
matched by Flax's auto-names (`Conv_k`, `BatchNorm_k`, `BasicBlockV1_k`,
`BasicBlockV2_k`, `MBConv_k`, `Bottleneck_k`, numbered in creation order
within their parent) and the modules' own names (`backbone`, `pose_fc`,
`views_logits_head`, `cls_tower_i`, ...). Conv kernels go from HWIO to
OIHW (a depthwise kernel `(k, k, 1, C)` becomes `(C, 1, k, k)` the same
way), dense kernels are transposed, and BatchNorm `scale` / `bias` /
`mean` / `var` become `weight` / `bias` / `running_mean` / `running_var`;
both frameworks use eps = 1e-5 (`models.backbones.BN_EPS`). This module
imports no JAX.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from happypose_tpu_torch.models.detector import RESNET50_LAYERS

Tree = Mapping[str, object]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32)))


def _conv(sd: Dict[str, torch.Tensor], name: str, p: Tree) -> None:
    sd[f"{name}.weight"] = _t(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))
    if "bias" in p:
        sd[f"{name}.bias"] = _t(p["bias"])


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


def wide_resnet_state_dict(params: Tree, stats: Tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """State dict of `models.backbones.WideResNet` from a Flax `WideResNet`'s
    params and batch stats. A v2 block creates its first BatchNorm before
    any conv, so when it downsamples `Conv_0` is the 1x1 shortcut and the
    3x3 convs are `Conv_1`, `Conv_2`; otherwise they are `Conv_0`, `Conv_1`."""
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, f"{prefix}conv1", params["Conv_0"])
    _bn(sd, f"{prefix}bn1", params["BatchNorm_0"], stats["BatchNorm_0"])
    i = 0
    while f"BasicBlockV2_{i}" in params:
        p, s = params[f"BasicBlockV2_{i}"], stats[f"BasicBlockV2_{i}"]
        name = f"{prefix}blocks.{i}"
        _bn(sd, f"{name}.bn1", p["BatchNorm_0"], s["BatchNorm_0"])
        _bn(sd, f"{name}.bn2", p["BatchNorm_1"], s["BatchNorm_1"])
        convs = ["conv1", "conv2"]
        if "Conv_2" in p:  # projection shortcut, created first
            convs.insert(0, "downsample")
        for k, conv in enumerate(convs):
            _conv(sd, f"{name}.{conv}", p[f"Conv_{k}"])
        i += 1
    return sd


def efficientnet_state_dict(params: Tree, stats: Tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """State dict of `models.backbones.EfficientNet` from a Flax
    `EfficientNet`'s params and batch stats: the stem is `Conv_0` /
    `BatchNorm_0`, the head `Conv_1` / `BatchNorm_1`. An `MBConv` with an
    expansion creates five convs (expand, depthwise, the two of the
    squeeze-excite, project) and three BatchNorms; without one (the blocks
    of the first stage: one in B0, two in B3) every index shifts down by
    one."""
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, f"{prefix}conv_stem", params["Conv_0"])
    _bn(sd, f"{prefix}bn_stem", params["BatchNorm_0"], stats["BatchNorm_0"])
    i = 0
    while f"MBConv_{i}" in params:
        p, s = params[f"MBConv_{i}"], stats[f"MBConv_{i}"]
        name = f"{prefix}blocks.{i}"
        convs = ["depthwise", "se_reduce", "se_expand", "project"]
        bns = ["bn1", "bn2"]
        if "Conv_4" in p:  # the 1x1 expansion, created first
            convs.insert(0, "expand_conv")
            bns.insert(0, "bn0")
        for k, conv in enumerate(convs):
            _conv(sd, f"{name}.{conv}", p[f"Conv_{k}"])
        for k, bn in enumerate(bns):
            _bn(sd, f"{name}.{bn}", p[f"BatchNorm_{k}"], s[f"BatchNorm_{k}"])
        i += 1
    _conv(sd, f"{prefix}conv_head", params["Conv_1"])
    _bn(sd, f"{prefix}bn_head", params["BatchNorm_1"], stats["BatchNorm_1"])
    return sd


_FLOWNET_LAYERS = 10
_FLOWNET_CONVS = frozenset(f"Conv_{k}" for k in range(_FLOWNET_LAYERS))
_FLOWNET_BNS = frozenset(f"BatchNorm_{k}" for k in range(_FLOWNET_LAYERS))


def flownet_state_dict(params: Tree, stats: Tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """State dict of `models.backbones.FlowNetS` from a Flax `FlowNetS`'s
    params (`Conv_0..9`) and, with `use_batchnorm`, `BatchNorm_0..9`."""
    sd: Dict[str, torch.Tensor] = {}
    for k in range(_FLOWNET_LAYERS):
        _conv(sd, f"{prefix}convs.{k}", params[f"Conv_{k}"])
        if f"BatchNorm_{k}" in params:
            _bn(sd, f"{prefix}bns.{k}", params[f"BatchNorm_{k}"], stats[f"BatchNorm_{k}"])
    return sd


def backbone_state_dict(params: Tree, stats: Tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """State dict of any of the port's pose backbones, the kind read from
    the Flax tree's names: `BasicBlockV2_*` (WideResNet), `BasicBlockV1_*`
    (ResNet), `MBConv_*` (EfficientNet), or the bare `Conv_0..9` of
    FlowNetS (with `BatchNorm_0..9` or without). Any other tree raises,
    naming what it holds."""
    names = set(params)
    for block, to_sd in (("BasicBlockV2_0", wide_resnet_state_dict),
                         ("BasicBlockV1_0", resnet_state_dict),
                         ("MBConv_0", efficientnet_state_dict)):
        if block in names:
            return to_sd(params, stats, prefix)
    if names in (_FLOWNET_CONVS, _FLOWNET_CONVS | _FLOWNET_BNS):
        return flownet_state_dict(params, stats, prefix)
    raise ValueError(f"unknown backbone tree: its modules are {sorted(names)}")


def pose_predictor_state_dict(variables: Tree) -> Dict[str, torch.Tensor]:
    """State dict of `models.pose_predictor.PosePredictor` from the Flax
    predictor's variables; the backbone kind is read from its names
    (`backbone_state_dict`). A predictor without BatchNorm (FlowNetS's
    default) has no `batch_stats`."""
    params = variables["params"]
    stats = variables.get("batch_stats", {}).get("backbone", {})
    sd = backbone_state_dict(params["backbone"], stats, prefix="backbone.")
    for head in ("pose_fc", "views_logits_head"):
        if head in params:
            _dense(sd, head, params[head])
    return sd


def _bottleneck(sd: Dict[str, torch.Tensor], name: str, p: Tree, s: Tree) -> None:
    for k in range(3):
        _conv(sd, f"{name}.conv{k + 1}", p[f"Conv_{k}"])
        _bn(sd, f"{name}.bn{k + 1}", p[f"BatchNorm_{k}"], s[f"BatchNorm_{k}"])
    if "Conv_3" in p:  # projection shortcut
        _conv(sd, f"{name}.downsample.0", p["Conv_3"])
        _bn(sd, f"{name}.downsample.1", p["BatchNorm_3"], s["BatchNorm_3"])


# ResNet50FPN's unnamed convs after the stem, in creation order: the
# laterals p5, p4, p3, the 3x3 smoothing convs p3, p4, p5, then p6 and p7
_FPN_CONVS = ("lat5", "lat4", "lat3", "smooth3", "smooth4", "smooth5", "p6", "p7")


def detector_state_dict(variables: Tree) -> Dict[str, torch.Tensor]:
    """State dict of `models.detector.FCOSDetector` from the Flax detector's
    variables."""
    params, stats = variables["params"], variables["batch_stats"]
    bp, bs = params["ResNet50FPN_0"], stats["ResNet50FPN_0"]
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, "backbone.conv1", bp["Conv_0"])
    _bn(sd, "backbone.bn1", bp["BatchNorm_0"], bs["BatchNorm_0"])
    k = 0
    for stage, n_blocks in enumerate(RESNET50_LAYERS):
        for b in range(n_blocks):
            _bottleneck(sd, f"backbone.stages.{stage}.{b}", bp[f"Bottleneck_{k}"],
                        bs[f"Bottleneck_{k}"])
            k += 1
    for k, conv in enumerate(_FPN_CONVS):
        _conv(sd, f"backbone.{conv}", bp[f"Conv_{k + 1}"])
    i = 0
    while f"cls_tower_{i}" in params:
        _conv(sd, f"cls_tower.{i}", params[f"cls_tower_{i}"])
        _conv(sd, f"box_tower.{i}", params[f"box_tower_{i}"])
        i += 1
    for head in ("cls_head", "box_head", "ctr_head", "coef_head"):
        _conv(sd, head, params[head])
    # the prototype branch's unnamed convs: two 3x3, then the 1x1 output
    _conv(sd, "proto.0", params["Conv_0"])
    _conv(sd, "proto.1", params["Conv_1"])
    _conv(sd, "proto_out", params["Conv_2"])
    return sd
