"""The weight bridge between Flax and PyTorch, both ways, for the pose
predictor and the detector.

One table says where each tensor of a Flax `happypose_tpu` `PosePredictor`
(ResNet34, WideResNet, EfficientNet or FlowNetS backbone) or
`FCOSDetector` lives in this package's module of the same name, and it is
read both ways: a Flax tree `{"params": ..., "batch_stats": ...}` of numpy
arrays to a `state_dict` (`*_state_dict`), and a state dict to the tree
JAX's jitted `model.init` builds, with its keys (sorted, as every jitted
JAX tree), shapes and float32 dtype (`*_variables`). Optax's Adam / AdamW
moments (`mu`, `nu`, trees shaped like `params`) go through the same
table to `torch.optim`'s `exp_avg` / `exp_avg_sq` (`adam_state_from_flax`,
`adam_state_to_flax`).

The table is made by one walker per architecture, which yields its
modules in Flax's creation order: (kind, module name in the state dict,
module path in the Flax tree). Modules are matched by Flax's auto-names
(`Conv_k`, `BatchNorm_k`, `BasicBlockV1_k`, `BasicBlockV2_k`, `MBConv_k`,
`Bottleneck_k`, numbered in creation order within their parent) and the
modules' own names (`backbone`, `pose_fc`, `views_logits_head`,
`cls_tower_i`, ...). Where a module is optional (a projection shortcut,
an expansion, a block), the walker asks the side being read whether it is
there, naming it on both sides; a shortcut created first renumbers the
convs after it. Conv kernels go from HWIO to OIHW (a depthwise kernel
`(k, k, 1, C)` becomes `(C, 1, k, k)` the same way), dense kernels are
transposed, and BatchNorm `scale` / `bias` / `mean` / `var` become
`weight` / `bias` / `running_mean` / `running_var`; both frameworks use
eps = 1e-5 (`models.backbones.BN_EPS`). `num_batches_tracked` has no Flax
counterpart: it is written as 0 and dropped going back. This module
imports no JAX.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Mapping, NamedTuple, Tuple

import numpy as np
import torch

from happypose_tpu_torch.models.detector import RESNET50_LAYERS, FCOSDetector

Tree = Mapping[str, object]
FlaxPath = Tuple[str, ...]
# is the module there, on the side being read? (state dict name, Flax path)
Probe = Callable[[str, FlaxPath], bool]

CONV, BN, DENSE = "conv", "bn", "dense"


class Module(NamedTuple):
    kind: str  # CONV | BN | DENSE
    torch: str  # module name in the state dict
    flax: FlaxPath  # module path under `params` (and `batch_stats`)


class Leaf(NamedTuple):
    collection: str  # "params" | "batch_stats"
    flax: FlaxPath  # path of the array under the collection
    torch: str  # key in the state dict
    layout: str  # "conv" | "dense" | "vector"
    optional: bool  # a conv's bias


# (collection, Flax leaf, torch suffix, layout, optional) of each kind
_LEAVES = {
    CONV: (("params", "kernel", "weight", "conv", False), ("params", "bias", "bias", "vector", True)),
    DENSE: (("params", "kernel", "weight", "dense", False), ("params", "bias", "bias", "vector", False)),
    BN: (("params", "scale", "weight", "vector", False), ("params", "bias", "bias", "vector", False),
         ("batch_stats", "mean", "running_mean", "vector", False),
         ("batch_stats", "var", "running_var", "vector", False)),
}


def _leaves(modules: Iterator[Module]) -> List[Leaf]:
    return [Leaf(c, m.flax + (leaf,), f"{m.torch}.{suffix}", layout, opt)
            for m in modules for c, leaf, suffix, layout, opt in _LEAVES[m.kind]]


# ------------------------------------------------------------------ walkers


def _resnet(has: Probe, t: str, f: FlaxPath) -> Iterator[Module]:
    yield Module(CONV, f"{t}conv1", f + ("Conv_0",))
    yield Module(BN, f"{t}bn1", f + ("BatchNorm_0",))
    i = 0
    while has(f"{t}blocks.{i}", f + (f"BasicBlockV1_{i}",)):
        name, p = f"{t}blocks.{i}", f + (f"BasicBlockV1_{i}",)
        yield Module(CONV, f"{name}.conv1", p + ("Conv_0",))
        yield Module(BN, f"{name}.bn1", p + ("BatchNorm_0",))
        yield Module(CONV, f"{name}.conv2", p + ("Conv_1",))
        yield Module(BN, f"{name}.bn2", p + ("BatchNorm_1",))
        if has(f"{name}.downsample", p + ("Conv_2",)):  # projection shortcut
            yield Module(CONV, f"{name}.downsample.0", p + ("Conv_2",))
            yield Module(BN, f"{name}.downsample.1", p + ("BatchNorm_2",))
        i += 1


def _wide_resnet(has: Probe, t: str, f: FlaxPath) -> Iterator[Module]:
    """A v2 block creates its first BatchNorm before any conv, so when it
    downsamples `Conv_0` is the 1x1 shortcut and the 3x3 convs are
    `Conv_1`, `Conv_2`; otherwise they are `Conv_0`, `Conv_1`."""
    yield Module(CONV, f"{t}conv1", f + ("Conv_0",))
    yield Module(BN, f"{t}bn1", f + ("BatchNorm_0",))
    i = 0
    while has(f"{t}blocks.{i}", f + (f"BasicBlockV2_{i}",)):
        name, p = f"{t}blocks.{i}", f + (f"BasicBlockV2_{i}",)
        yield Module(BN, f"{name}.bn1", p + ("BatchNorm_0",))
        yield Module(BN, f"{name}.bn2", p + ("BatchNorm_1",))
        convs = ["conv1", "conv2"]
        if has(f"{name}.downsample", p + ("Conv_2",)):  # projection shortcut, created first
            convs.insert(0, "downsample")
        for k, conv in enumerate(convs):
            yield Module(CONV, f"{name}.{conv}", p + (f"Conv_{k}",))
        i += 1


def _efficientnet(has: Probe, t: str, f: FlaxPath) -> Iterator[Module]:
    """The stem is `Conv_0` / `BatchNorm_0`, the head `Conv_1` /
    `BatchNorm_1`. An `MBConv` with an expansion creates five convs
    (expand, depthwise, the two of the squeeze-excite, project) and three
    BatchNorms; without one (the blocks of the first stage: one in B0, two
    in B3) every index shifts down by one."""
    yield Module(CONV, f"{t}conv_stem", f + ("Conv_0",))
    yield Module(BN, f"{t}bn_stem", f + ("BatchNorm_0",))
    i = 0
    while has(f"{t}blocks.{i}", f + (f"MBConv_{i}",)):
        name, p = f"{t}blocks.{i}", f + (f"MBConv_{i}",)
        convs = ["depthwise", "se_reduce", "se_expand", "project"]
        bns = ["bn1", "bn2"]
        if has(f"{name}.expand_conv", p + ("Conv_4",)):  # the 1x1 expansion, created first
            convs.insert(0, "expand_conv")
            bns.insert(0, "bn0")
        for k, conv in enumerate(convs):
            yield Module(CONV, f"{name}.{conv}", p + (f"Conv_{k}",))
        for k, bn in enumerate(bns):
            yield Module(BN, f"{name}.{bn}", p + (f"BatchNorm_{k}",))
        i += 1
    yield Module(CONV, f"{t}conv_head", f + ("Conv_1",))
    yield Module(BN, f"{t}bn_head", f + ("BatchNorm_1",))


_FLOWNET_LAYERS = 10
_FLOWNET_CONVS = frozenset(f"Conv_{k}" for k in range(_FLOWNET_LAYERS))
_FLOWNET_BNS = frozenset(f"BatchNorm_{k}" for k in range(_FLOWNET_LAYERS))


def _flownet(has: Probe, t: str, f: FlaxPath) -> Iterator[Module]:
    """`Conv_0..9` and, with `use_batchnorm`, `BatchNorm_0..9`."""
    for k in range(_FLOWNET_LAYERS):
        yield Module(CONV, f"{t}convs.{k}", f + (f"Conv_{k}",))
        if has(f"{t}bns.{k}", f + (f"BatchNorm_{k}",)):
            yield Module(BN, f"{t}bns.{k}", f + (f"BatchNorm_{k}",))


# the port's backbone names (`PosePredictorConfig.backbone`)
_BACKBONE_WALKERS = {
    "resnet34": _resnet,
    "wide_resnet18": _wide_resnet,
    "wide_resnet34": _wide_resnet,
    "efficientnet_b0": _efficientnet,
    "efficientnet_b3": _efficientnet,
    "flownet": _flownet,
}


def _backbone_walker(params: Tree):
    """The walker of a Flax backbone tree, read from its names:
    `BasicBlockV2_*` (WideResNet), `BasicBlockV1_*` (ResNet), `MBConv_*`
    (EfficientNet), or the bare `Conv_0..9` of FlowNetS (with
    `BatchNorm_0..9` or without). Any other tree raises, naming what it
    holds."""
    names = set(params)
    for block, walker in (("BasicBlockV2_0", _wide_resnet), ("BasicBlockV1_0", _resnet),
                          ("MBConv_0", _efficientnet)):
        if block in names:
            return walker
    if names in (_FLOWNET_CONVS, _FLOWNET_CONVS | _FLOWNET_BNS):
        return _flownet
    raise ValueError(f"unknown backbone tree: its modules are {sorted(names)}")


def _pose_predictor(has: Probe, backbone) -> Iterator[Module]:
    yield from backbone(has, "backbone.", ("backbone",))
    for head in ("pose_fc", "views_logits_head"):
        if has(head, (head,)):
            yield Module(DENSE, head, (head,))


def _bottleneck(name: str, p: FlaxPath, shortcut: bool) -> Iterator[Module]:
    for k in range(3):
        yield Module(CONV, f"{name}.conv{k + 1}", p + (f"Conv_{k}",))
        yield Module(BN, f"{name}.bn{k + 1}", p + (f"BatchNorm_{k}",))
    if shortcut:
        yield Module(CONV, f"{name}.downsample.0", p + ("Conv_3",))
        yield Module(BN, f"{name}.downsample.1", p + ("BatchNorm_3",))


# ResNet50FPN's unnamed convs after the stem, in creation order: the
# laterals p5, p4, p3, the 3x3 smoothing convs p3, p4, p5, then p6 and p7
_FPN_CONVS = ("lat5", "lat4", "lat3", "smooth3", "smooth4", "smooth5", "p6", "p7")


def _detector(has: Probe) -> Iterator[Module]:
    bp = ("ResNet50FPN_0",)
    yield Module(CONV, "backbone.conv1", bp + ("Conv_0",))
    yield Module(BN, "backbone.bn1", bp + ("BatchNorm_0",))
    k = 0
    for stage, n_blocks in enumerate(RESNET50_LAYERS):
        for b in range(n_blocks):
            name, p = f"backbone.stages.{stage}.{b}", bp + (f"Bottleneck_{k}",)
            yield from _bottleneck(name, p, has(f"{name}.downsample", p + ("Conv_3",)))
            k += 1
    for k, conv in enumerate(_FPN_CONVS):
        yield Module(CONV, f"backbone.{conv}", bp + (f"Conv_{k + 1}",))
    i = 0
    while has(f"cls_tower.{i}", (f"cls_tower_{i}",)):
        yield Module(CONV, f"cls_tower.{i}", (f"cls_tower_{i}",))
        yield Module(CONV, f"box_tower.{i}", (f"box_tower_{i}",))
        i += 1
    for head in ("cls_head", "box_head", "ctr_head", "coef_head"):
        yield Module(CONV, head, (head,))
    # the prototype branch's unnamed convs: two 3x3, then the 1x1 output
    yield Module(CONV, "proto.0", ("Conv_0",))
    yield Module(CONV, "proto.1", ("Conv_1",))
    yield Module(CONV, "proto_out", ("Conv_2",))


# ------------------------------------------------------------ the two probes


def _get(tree: Tree, path: FlaxPath):
    for k in path:
        if not isinstance(tree, Mapping) or k not in tree:
            return None
        tree = tree[k]
    return tree


def _flax_probe(params: Tree) -> Probe:
    return lambda t, f: _get(params, f) is not None


def _torch_probe(state_dict: Mapping[str, torch.Tensor]) -> Probe:
    prefixes = {k.rsplit(".", i)[0] for k in state_dict for i in range(1, k.count(".") + 1)}
    return lambda t, f: t in prefixes


# ------------------------------------------------------------ reading a table

_TO_TORCH = {"conv": (3, 2, 0, 1), "dense": (1, 0), "vector": None}
_TO_FLAX = {"conv": (2, 3, 1, 0), "dense": (1, 0), "vector": None}


def _t(x, axes) -> torch.Tensor:
    """A float32 copy in torch's layout (never a view of a decoded file)."""
    a = np.asarray(x, np.float32)
    return torch.from_numpy(np.array(a if axes is None else a.transpose(axes), order="C"))


def _to_state_dict(leaves: List[Leaf], variables: Tree) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    for leaf in leaves:
        x = _get(variables.get(leaf.collection, {}), leaf.flax)
        if x is None:
            if leaf.optional:
                continue
            raise KeyError(f"{leaf.collection}/{'/'.join(leaf.flax)} is not in the Flax tree")
        sd[leaf.torch] = _t(x, _TO_TORCH[leaf.layout])
        if leaf.torch.endswith(".running_var"):
            sd[leaf.torch[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    return sd


def _put(tree: Dict, path: FlaxPath, x) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = x


def _sorted(tree):
    return {k: _sorted(tree[k]) for k in sorted(tree)} if isinstance(tree, dict) else tree


def _to_flax(leaves: List[Leaf], state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Dict]:
    """The Flax tree of `leaves` from `state_dict`; every key of the state
    dict but `num_batches_tracked` must be read."""
    out: Dict[str, Dict] = {}
    used = set()
    for leaf in leaves:
        x = state_dict.get(leaf.torch)
        if x is None:
            if leaf.optional:
                continue
            raise KeyError(f"{leaf.torch} is not in the state dict")
        axes = _TO_FLAX[leaf.layout]
        a = x.detach().cpu().float().numpy()  # copied below: never a view of the model
        _put(out.setdefault(leaf.collection, {}), leaf.flax,
             np.array(a if axes is None else a.transpose(axes), order="C"))
        used.add(leaf.torch)
    left = sorted(k for k in state_dict if k not in used and not k.endswith("num_batches_tracked"))
    if left:
        raise KeyError(f"state dict keys with no Flax counterpart: {left}")
    return _sorted(out)


# -------------------------------------------------- Flax -> state dict (names kept)


def _backbone_sd(walker, params: Tree, stats: Tree, prefix: str) -> Dict[str, torch.Tensor]:
    leaves = _leaves(walker(_flax_probe(params), prefix, ()))
    return _to_state_dict(leaves, {"params": params, "batch_stats": stats})


def resnet_state_dict(params: Tree, stats: Tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """State dict of `models.backbones.ResNet` from a Flax `ResNet`'s
    params and batch stats."""
    return _backbone_sd(_resnet, params, stats, prefix)


def wide_resnet_state_dict(params: Tree, stats: Tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """State dict of `models.backbones.WideResNet` from a Flax
    `WideResNet`'s params and batch stats."""
    return _backbone_sd(_wide_resnet, params, stats, prefix)


def efficientnet_state_dict(params: Tree, stats: Tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """State dict of `models.backbones.EfficientNet` from a Flax
    `EfficientNet`'s params and batch stats."""
    return _backbone_sd(_efficientnet, params, stats, prefix)


def flownet_state_dict(params: Tree, stats: Tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """State dict of `models.backbones.FlowNetS` from a Flax `FlowNetS`'s
    params (`Conv_0..9`) and, with `use_batchnorm`, `BatchNorm_0..9`."""
    return _backbone_sd(_flownet, params, stats, prefix)


def backbone_state_dict(params: Tree, stats: Tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """State dict of any of the port's pose backbones, the kind read from
    the Flax tree's names (`BasicBlockV2_*`, `BasicBlockV1_*`, `MBConv_*`,
    or FlowNetS's bare `Conv_0..9`). Any other tree raises, naming what it
    holds."""
    return _backbone_sd(_backbone_walker(params), params, stats, prefix)


def pose_predictor_state_dict(variables: Tree) -> Dict[str, torch.Tensor]:
    """State dict of `models.pose_predictor.PosePredictor` from the Flax
    predictor's variables; the backbone kind is read from its names. A
    predictor without BatchNorm (FlowNetS's default) has no
    `batch_stats`."""
    params = variables["params"]
    walker = _backbone_walker(params["backbone"])
    return _to_state_dict(_leaves(_pose_predictor(_flax_probe(params), walker)), variables)


def detector_state_dict(variables: Tree) -> Dict[str, torch.Tensor]:
    """State dict of `models.detector.FCOSDetector` from the Flax detector's
    variables."""
    return _to_state_dict(_leaves(_detector(_flax_probe(variables["params"]))), variables)


# -------------------------------------------------------- state dict -> Flax


def pose_predictor_variables(state_dict: Mapping[str, torch.Tensor],
                             backbone: str) -> Dict[str, Dict]:
    """The Flax `PosePredictor`'s variables (`params`, and `batch_stats`
    where the model has BatchNorm) of a state dict of the port's
    `PosePredictor` with `backbone`."""
    walker = _BACKBONE_WALKERS[backbone]
    return _to_flax(_leaves(_pose_predictor(_torch_probe(state_dict), walker)), state_dict)


def detector_variables(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Dict]:
    """The Flax `FCOSDetector`'s variables of a state dict of the port's
    `FCOSDetector`."""
    return _to_flax(_leaves(_detector(_torch_probe(state_dict))), state_dict)


def model_leaves(model: torch.nn.Module) -> List[Leaf]:
    """The table of the port's `PosePredictor` or `FCOSDetector`."""
    has = _torch_probe(model.state_dict())
    if isinstance(model, FCOSDetector):
        return _leaves(_detector(has))
    return _leaves(_pose_predictor(has, _BACKBONE_WALKERS[model.cfg.backbone]))


def model_variables(model: torch.nn.Module) -> Dict[str, Dict]:
    """`pose_predictor_variables` or `detector_variables` of a model."""
    return _to_flax(model_leaves(model), model.state_dict())


# ------------------------------------------------------------ Adam's moments


def _params_only(leaves: List[Leaf]) -> List[Leaf]:
    return [leaf for leaf in leaves if leaf.collection == "params"]


def adam_state_from_flax(leaves: List[Leaf], adam: Tree,
                         names: List[str]) -> Dict[int, Dict[str, torch.Tensor]]:
    """`torch.optim.Adam`'s per-parameter state from optax's
    `ScaleByAdamState` tree `{"count", "mu", "nu"}`: `mu` / `nu` (shaped like
    `params`) through the table to `exp_avg` / `exp_avg_sq`, `count` (the
    updates applied) to every parameter's `step`. `names` are the
    optimizer's parameters' state dict keys, in its order."""
    mu = _to_state_dict(_params_only(leaves), {"params": adam["mu"]})
    nu = _to_state_dict(_params_only(leaves), {"params": adam["nu"]})
    count = float(np.asarray(adam["count"]))
    return {i: {"step": torch.tensor(count), "exp_avg": mu[n], "exp_avg_sq": nu[n]}
            for i, n in enumerate(names)}


def adam_state_to_flax(leaves: List[Leaf], state: Mapping[int, Mapping[str, torch.Tensor]],
                       params: Mapping[str, torch.Tensor], names: List[str],
                       count: int) -> Dict[str, object]:
    """optax's `ScaleByAdamState` tree of `torch.optim.Adam`'s per-parameter
    state (a parameter with no state yet has zero moments)."""
    moments = {}
    for key in ("exp_avg", "exp_avg_sq"):
        sd = {n: (state[i][key] if i in state else torch.zeros_like(params[n]))
              for i, n in enumerate(names)}
        moments[key] = _to_flax(_params_only(leaves), sd)["params"]
    return {"count": np.asarray(count, np.int32), "mu": moments["exp_avg"],
            "nu": moments["exp_avg_sq"]}
