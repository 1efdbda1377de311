"""EfficientNet-B0/B3 and FlowNetS, the PyTorch port against Flax: each
backbone alone (eval and train mode, the BatchNorm statistics), the weight
bridge's dispatch over all five backbones, and one iteration of the pose
predictor with `efficientnet_b3` and `flownet` (refiner and coarse heads).
`test_torch_backbones_pipeline.py` holds a refiner loss and the cut
pipeline with EfficientNet-B3.

The Flax variables are seeded values on the tree Flax's own `init` makes
(read with `jax.eval_shape`, which traces without compiling: a jitted
`init` of EfficientNet-B3 takes ~13 s on the CPU): LeCun-scaled kernels,
BatchNorm affine terms and running statistics away from (1, 0, 0, 1), a
pose head that moves the pose by a few percent. They are carried over by
`weights_from_jax`. JAX's renders go through the Pallas kernel in
interpret mode (the predictor, the pipeline) or its two-pass reference
(the loss), as the JAX package's own tests run them; the port's through
the CUDA kernel's plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from happypose_tpu.models import backbones as jb
from happypose_tpu.models.pose_predictor import PosePredictor as JaxPosePredictor
from happypose_tpu.models.pose_predictor import PosePredictorConfig as JaxConfig
from happypose_tpu_torch.models import backbones as tb
from happypose_tpu_torch.models.pose_predictor import PosePredictor, PosePredictorConfig
from happypose_tpu_torch.utils.weights_from_jax import (
    backbone_state_dict,
    pose_predictor_state_dict,
)
from test_torch_models import _scene

torch.set_num_threads(2)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

RENDER = (32, 48)
GAIN = {"flownet": np.sqrt(2.0), "flownet_bn": np.sqrt(2.0)}
IDENTITY_9 = np.asarray([1, 0, 0, 0, 1, 0, 0, 0, 1], np.float32)


def seeded_variables(shapes, seed, gain=1.0):
    """Seeded values on a Flax variable tree of `jax.ShapeDtypeStruct`s:
    kernels N(0, gain^2 / fan_in) (LeCun; a depthwise kernel's fan-in is
    k x k; FlowNetS takes He's gain sqrt(2), so that its ten LeakyReLU
    layers keep the input's part of the signal), biases and running means
    N(0, 0.05), BatchNorm scales U(0.8, 1.2), running variances U(0.5,
    1.5); the pose head's kernel N(0, 3e-3) and its bias the identity
    update + N(0, 0.05)."""
    rs = np.random.RandomState(seed)

    def walk(tree, path):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = walk(v, path + (k,))
                continue
            shape = v.shape
            if k == "kernel" and "pose_fc" in path:
                x = rs.normal(0, 3e-3, shape)
            elif k == "kernel":
                x = rs.normal(0, gain / np.sqrt(np.prod(shape[:-1])), shape)
            elif k == "scale":
                x = rs.uniform(0.8, 1.2, shape)
            elif k == "var":
                x = rs.uniform(0.5, 1.5, shape)
            else:  # bias, mean
                x = rs.normal(0, 0.05, shape)
                if k == "bias" and "pose_fc" in path:
                    x = x + IDENTITY_9
            out[k] = np.asarray(x, np.float32)
        return out

    return walk(shapes, ())


# ------------------------------------------------------------- the backbones

BACKBONES = {
    "efficientnet_b0": (jb.EfficientNetB0, tb.EfficientNetB0, {}),
    "efficientnet_b3": (jb.EfficientNetB3, tb.EfficientNetB3, {}),
    "flownet": (jb.FlowNetS, tb.FlowNetS, {}),
    "flownet_bn": (jb.FlowNetS, tb.FlowNetS, {"use_batchnorm": True}),
}
WITH_BATCHNORM = ["efficientnet_b0", "efficientnet_b3", "flownet_bn"]
N_IN = 6


@pytest.fixture(scope="module")
def backbone_runs():
    """For each backbone: its seeded Flax variables and Flax's train-mode
    features and updated batch stats on them, and Flax's eval-mode features
    with the statistics calibrated on the input, a seeded [2, 6, 128, 128]
    (the last BatchNorm sees a 2x2 map in FlowNetS, 4x4 in EfficientNet:
    n = 8 and 32 values a channel)."""
    rs = np.random.RandomState(0)
    x = rs.rand(2, N_IN, 128, 128).astype(np.float32)
    x_nhwc = jnp.asarray(np.moveaxis(x, 1, -1))
    runs = {}
    for seed, (name, (jax_cls, _, kw)) in enumerate(sorted(BACKBONES.items())):
        model = jax_cls(**kw)
        variables = seeded_variables(jax.eval_shape(model.init, jax.random.PRNGKey(0), x_nhwc),
                                     seed=seed + 1, gain=GAIN.get(name, 1.0))
        train_out, eval_variables = None, variables
        if "batch_stats" in variables:
            train_out = jax.jit(lambda v, x: model.apply(
                v, x, train=True, mutable=["batch_stats"]))(variables, x_nhwc)
            eval_variables = calibrated(variables, _backbone_state_dict,
                                        BACKBONES[name][1](N_IN, **kw), torch.from_numpy(x))
        eval_out = jax.jit(lambda v, x: model.apply(v, x, train=False))(eval_variables, x_nhwc)
        runs[name] = dict(model=model, variables=variables, eval_variables=eval_variables,
                          eval=np.asarray(eval_out), train=jax.tree.map(np.asarray, train_out))
    return x, runs


def _backbone_state_dict(variables):
    return backbone_state_dict(variables["params"], variables.get("batch_stats", {}))


def _port_backbone(name, variables):
    _, port_cls, kw = BACKBONES[name]
    model = port_cls(N_IN, **kw)
    model.load_state_dict(_backbone_state_dict(variables))
    return model


def test_efficientnet_widths_and_depths_match_flax(backbone_runs):
    """B3: a 40-channel stem, 26 MBConv blocks (`ceil(repeats x 1.4)` a
    stage), 1536 features; B0: 32, 16, 1280. The blocks of the first stage
    have no expansion (four convs in Flax, not five): B0's one, B3's two.
    The port's parameters have Flax's shapes (the strict load of
    `_port_backbone`)."""
    _, runs = backbone_runs
    for name, (stem, n_blocks, n_features, n_plain) in (
            ("efficientnet_b0", (32, 16, 1280, 1)), ("efficientnet_b3", (40, 26, 1536, 2))):
        params = runs[name]["variables"]["params"]
        assert sum(k.startswith("MBConv_") for k in params) == n_blocks
        expanded = ["Conv_4" in params[f"MBConv_{i}"] for i in range(n_blocks)]
        assert expanded == [False] * n_plain + [True] * (n_blocks - n_plain)
        model = _port_backbone(name, runs[name]["variables"])
        assert model.conv_stem.out_channels == stem and len(model.blocks) == n_blocks
        assert model.n_features == runs[name]["model"].n_features == n_features
        assert [b.expand_conv is not None for b in model.blocks] == expanded


@pytest.mark.parametrize("name", sorted(BACKBONES))
def test_backbone_features_match_flax(backbone_runs, name):
    """Eval-mode features [2, n_features] within 1e-4 of their largest
    value: float32 sums in another order over up to 26 blocks (measured
    ~1e-7 of it on this CPU). The two inputs' features differ."""
    x, runs = backbone_runs
    ref = runs[name]["eval"]
    model = _port_backbone(name, runs[name]["eval_variables"]).eval()
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert np.abs(ref[0] - ref[1]).max() > 1e-2 * np.abs(ref).max() > 0
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max())


# Train mode, port against JAX: the features within TRAIN_REL of their
# largest value. Flax's BatchNorm computes the batch variance as
# E[x^2] - E[x]^2 in float32 (`use_fast_variance`), the port as the mean of
# squared deviations: against a float64 run of the port, JAX's float32
# features are 0.8-1.8e-5 of their largest value off at these sizes (1e-2
# for FlowNetS at 64 px, where its last maps are 1x1 and a channel's batch
# is 2 values), the port's 0.4-1.0e-5. So the features are held to 5e-5 of
# JAX's (measured <= 1.9e-5), and the port's own error to be no larger than
# JAX's. The running statistics to 1e-5 relative.
TRAIN_REL = 5e-5


@pytest.mark.parametrize("name", WITH_BATCHNORM)
def test_backbone_train_mode_matches_flax(backbone_runs, name):
    """Train mode: the features (normalized with the batch's statistics)
    within TRAIN_REL of their largest value, and no further from a float64
    run of the port than JAX's are; every BatchNorm's running mean and
    variance after the step to 1e-5 relative (Flax moves the variance
    towards the biased batch variance; so does the port's `BatchNorm2d`)."""
    x, runs = backbone_runs
    variables = runs[name]["variables"]
    ref_out, ref_state = runs[name]["train"]
    model = _port_backbone(name, variables).train()
    exact = _port_backbone(name, variables).double().train()
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
        out64 = exact(torch.from_numpy(x).double()).numpy()
    scale = np.abs(out64).max()
    np.testing.assert_allclose(out, ref_out, rtol=0, atol=TRAIN_REL * scale)
    assert np.abs(out - out64).max() <= np.abs(ref_out - out64).max()
    ref = backbone_state_dict(variables["params"], ref_state["batch_stats"])
    before = backbone_state_dict(variables["params"], variables["batch_stats"])
    n_stats = 0
    for key, buf in model.state_dict().items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), ref[key].numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=key)
            assert not torch.allclose(buf, before[key]), key
            n_stats += 1
    assert n_stats == 2 * sum(isinstance(m, tb.BatchNorm2d) for m in model.modules()) > 0


# ------------------------------------------------------- the weight bridge

def test_weight_bridge_dispatches_on_the_tree_names(backbone_runs):
    """Every backbone's Flax tree goes to its own map by its names
    (`BasicBlockV2_*` WideResNet, `BasicBlockV1_*` ResNet, `MBConv_*`
    EfficientNet, bare `Conv_0..9` FlowNetS with and without BatchNorm),
    and the state dict loads strictly (every key, every shape) into the
    port's module; a tree of none of these raises, naming what it holds."""
    _, runs = backbone_runs
    cases = [(r["variables"], _port_backbone(name, r["variables"]))
             for name, r in sorted(runs.items())]
    x = jnp.zeros((1, 32, 32, N_IN))
    for jax_model, port_model in ((jb.ResNet34(), tb.ResNet34(N_IN)),
                                  (jb.WideResNet18(), tb.WideResNet18(N_IN))):
        shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), x)
        cases.append((seeded_variables(shapes, 0), port_model))
    kinds = set()
    for variables, module in cases:
        sd = backbone_state_dict(variables["params"], variables.get("batch_stats", {}))
        module.load_state_dict(sd)
        assert set(sd) == set(module.state_dict())
        kinds.add(type(module).__name__)
    assert kinds == {"EfficientNet", "FlowNetS", "ResNet", "WideResNet"}
    with pytest.raises(ValueError, match="Conv_0.*Dense_0.*LayerNorm_0"):
        backbone_state_dict({"Conv_0": {}, "Dense_0": {}, "LayerNorm_0": {}}, {})
    with pytest.raises(ValueError, match="unknown backbone"):
        # FlowNetS's convs without their last one are no FlowNetS
        backbone_state_dict({f"Conv_{k}": {} for k in range(9)}, {})


# ------------------------------------------------------------ the predictor

def calibrated(variables, to_state_dict, model, *inputs):
    """`variables` with running statistics that match the network's
    activations: one eval-mode forward of the port's `model` (loaded from
    `variables`) on `inputs` in which each BatchNorm, just before it
    normalizes, takes its input's per-channel mean as running mean and the
    mean of its channels' variances as running variance; the statistics go
    back into the Flax tree by the leaf each came from (`to_state_dict`,
    the bridge, on a tree whose leaves carry their own index).

    Running statistics drawn at random do not match the activations: through
    EfficientNet-B3's 26 blocks the input's part of the features then falls
    ~10x a stage (1e-8 of them at the head) and every hypothesis gets the
    same logit. Per-channel variances, as a train-mode pass gives them, make
    channels of near-constant activations divide float32 rounding by ~3e-3
    a layer, and a forward in eval mode no longer agrees with itself."""
    def take_statistics(bn, args):
        var, mean = torch.var_mean(args[0], dim=(0, 2, 3), correction=0)
        bn.running_mean.copy_(mean)
        bn.running_var.fill_(var.mean().item())

    model.load_state_dict(to_state_dict(variables))
    hooks = [m.register_forward_pre_hook(take_statistics) for m in model.modules()
             if isinstance(m, torch.nn.BatchNorm2d)]
    with torch.no_grad():
        model.eval()(*inputs)
    for h in hooks:
        h.remove()
    leaves, tree = jax.tree.flatten(variables["batch_stats"])
    labelled = to_state_dict({**variables, "batch_stats": tree.unflatten(
        [np.full(np.shape(x), i, np.float32) for i, x in enumerate(leaves)])})
    state = model.state_dict()
    for key, labels in labelled.items():
        if key.endswith(("running_mean", "running_var")):
            leaves[int(labels.flatten()[0])] = state[key].numpy().copy()
    return {**variables, "batch_stats": tree.unflatten(leaves)}


PREDICTOR_CASES = [(bb, role) for bb in ("efficientnet_b3", "flownet")
                   for role in ("refiner", "coarse")]


def _jax_predictor(backbone, role, renderer="pallas_interpret", render=RENDER):
    kw = dict(backbone=backbone, render_size=render, renderer=renderer)
    if role == "coarse":
        kw.update(predict_pose_update=False, predict_rendered_views_logits=True)
    return JaxPosePredictor(JaxConfig(**kw))


def _port_config(jax_model):
    c = jax_model.cfg
    return PosePredictorConfig(
        backbone=c.backbone, render_size=c.render_size,
        predict_pose_update=c.predict_pose_update,
        predict_rendered_views_logits=c.predict_rendered_views_logits,
    )


def _predictor_variables(jax_model, seed, jax_args, port_args):
    """Seeded Flax variables of `jax_model`, their BatchNorm statistics (if
    any) calibrated on the port's inputs `port_args`."""
    variables = seeded_variables(
        jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), *jax_args), seed,
        gain=GAIN.get(jax_model.cfg.backbone, 1.0))
    if "batch_stats" not in variables:  # FlowNetS without BatchNorm
        return variables
    return calibrated(variables, pose_predictor_state_dict,
                      PosePredictor(_port_config(jax_model)), *port_args)


def _scene_args():
    """`test_torch_models.py`'s two-object scene as both packages' inputs."""
    jdb, tdb, images, K, TCO, obj_ids = _scene()
    ids = torch.from_numpy(obj_ids)
    jax_args = (jnp.asarray(images), jnp.asarray(K), jnp.asarray(obj_ids), jnp.asarray(TCO),
                jdb.render_assets(), jdb.batched(n_points=200).select(jnp.asarray(obj_ids)))
    port_args = (torch.from_numpy(images), torch.from_numpy(K), ids, torch.from_numpy(TCO),
                 tdb.render_assets(device="cpu"),
                 tdb.batched(n_points=200, device="cpu").select(ids))
    return jax_args, port_args


@pytest.mark.parametrize("backbone,role", PREDICTOR_CASES)
def test_pose_predictor_iteration_matches_flax(backbone, role):
    """One iteration (crop, render, backbone, head) of `PosePredictor` with
    the new backbones, as refiner and as coarse classifier: crop boxes and
    K_crop to 1e-4 px, the head's raw output and the logits to 1e-4,
    TCO_output to 1e-5 (m and rotation entries). The two objects' outputs
    differ by more than those tolerances: the features carry the input."""
    jax_args, port_args = _scene_args()
    jax_model = _jax_predictor(backbone, role)
    variables = _predictor_variables(jax_model, 5, jax_args, port_args)
    ref = jax.jit(jax_model.apply)(variables, *jax_args)

    model = PosePredictor(_port_config(jax_model)).eval()
    model.load_state_dict(pose_predictor_state_dict(variables))
    with torch.no_grad():
        out = model(*port_args)
    np.testing.assert_allclose(out.boxes_crop.numpy(), np.asarray(ref.boxes_crop), atol=1e-4, rtol=0)
    np.testing.assert_allclose(out.K_crop.numpy(), np.asarray(ref.K_crop), atol=1e-4, rtol=1e-6)
    if role == "refiner":
        raw = np.asarray(ref.pose_raw)
        assert np.abs(raw[0, 0] - raw[0, 1]).max() > 1e-4
        assert not np.allclose(np.asarray(ref.TCO_output), np.asarray(ref.TCO_input), atol=1e-4)
        np.testing.assert_allclose(out.pose_raw.numpy(), raw, atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(out.TCO_output.numpy(), np.asarray(ref.TCO_output), atol=1e-5, rtol=0)
    else:
        logits = np.asarray(ref.renderings_logits)
        assert abs(logits[0, 0, 0] - logits[0, 1, 0]) > 1e-3
        np.testing.assert_allclose(out.renderings_logits.numpy(), logits, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("backbone", ["efficientnet_b3", "flownet"])
def test_fresh_weights_follow_flax_defaults(backbone):
    """`init_weights` on the new layers: every convolution (depthwise ones
    with fan-in k x k) with weights of standard deviation 1 / sqrt(fan-in)
    (LeCun, Flax's default) within 10%, every bias 0 (the squeeze-excite's,
    FlowNetS's), BatchNorm scale 1 and bias 0."""
    model = PosePredictor(PosePredictorConfig(backbone=backbone, render_size=RENDER))
    model.init_weights(torch.Generator().manual_seed(0))
    n_convs = 0
    for m in model.backbone.modules():
        if isinstance(m, torch.nn.Conv2d):
            fan_in = m.weight[0].numel()
            if m.weight.numel() >= 2000:
                std = m.weight.std().item() * np.sqrt(fan_in)
                assert abs(std - 1) < 0.1, (m, std)
            if m.bias is not None:
                assert not m.bias.any()
            n_convs += 1
        elif isinstance(m, torch.nn.BatchNorm2d):
            assert (m.weight == 1).all() and not m.bias.any()
    # B3: stem and head, 2 blocks without expansion (4 convs), 24 with (5)
    assert n_convs == (2 + 2 * 4 + 24 * 5 if backbone == "efficientnet_b3" else 10)
