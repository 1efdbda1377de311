"""The train step captured and replayed on the card (marked `cuda`; it
skips without one). It imports neither JAX nor the JAX package, so that
it runs where only the port is installed:

    python -m pytest --noconftest tests/test_torch_graphed_training_card.py -m cuda

A cut refiner (WideResNet18, 48x64 renders, 96x128 images, B = 4, 2
iterations, the "debug" synthetic set) trains 3 steps through its graph
and 3 through the eager body from copies of one state, with TF32 off and
cuDNN deterministic, at a rate that changes every step (a warm-up of 2
updates, a decay at update 2): graph and eager equal bit for bit after
every step, the first call runs the step once (its warm-up) and records
it (its capture), and the replays run the step's rasterizing kernels on
the device.
"""

import copy

import pytest
import torch

from happypose_tpu_torch.bench import busy_share
from happypose_tpu_torch.models.pose_predictor import PosePredictor, PosePredictorConfig
from happypose_tpu_torch.ops import rasterizer_fused as rf
from happypose_tpu_torch.training.forward_loss import make_refiner_loss_fn
from happypose_tpu_torch.training.synth_data import make_synth_mesh_db, sample_synth_scenes
from happypose_tpu_torch.training.synth_data import make_synth_batch_eager
from happypose_tpu_torch.training.trainer import TrainState, make_optimizer, make_train_step

N_ITER = 2
STEPS = 3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cudnn.deterministic) = flags


def _world(dev, mesh=None):
    db = make_synth_mesh_db("debug")
    assets, meshes = db.render_assets(device=dev), db.batched(n_points=128, device=dev)
    K1 = torch.tensor([[120.0, 0, 64], [0, 120.0, 48], [0, 0, 1]], device=dev)
    model = PosePredictor(PosePredictorConfig(
        backbone="wide_resnet18", render_size=(48, 64), bn_axis_name="dp" if mesh else None))
    model.init_weights(torch.Generator().manual_seed(0)).to(dev)
    batches = [make_synth_batch_eager(assets, K1, sample_synth_scenes(
        torch.Generator(device=dev).manual_seed(i), 2, 4, (96, 128), z_range=(0.3, 0.4)))
        for i in range(STEPS)]
    out = {}
    for name in ("graph", "eager"):
        m = copy.deepcopy(model)
        loss_fn = make_refiner_loss_fn(m, assets, meshes, n_iterations=N_ITER)
        state = TrainState(m, make_optimizer(m.parameters(), lr=1e-3, n_warmup_steps=2,
                                             decay_steps=(2,)))
        out[name] = (state, make_train_step(loss_fn, mesh=mesh))
    draws = [out["graph"][1].loss_fn.sample(torch.Generator(device=dev).manual_seed(10 + i), b)
             for i, b in enumerate(batches)]
    return out, batches, draws


def _state(state):
    opt = state.optimizer
    return ({k: v.clone() for k, v in state.model.state_dict().items()},
            [v.clone() for v in opt.state_tensors()], opt.count, state.step)


def _assert_equal(a, b, i):
    (sd_a, opt_a, count_a, step_a), (sd_b, opt_b, count_b, step_b) = a, b
    assert (count_a, step_a) == (count_b, step_b) == (i + 1, i + 1)
    for k in sd_a:
        assert torch.equal(sd_a[k], sd_b[k]), (i, k)
    for x, y in zip(opt_a, opt_b):
        assert torch.equal(x, y), i


def _train_both(worlds, batches, draws):
    (g_state, g_step), (e_state, e_step) = worlds["graph"], worlds["eager"]
    for i, (b, d) in enumerate(zip(batches, draws)):
        n0 = rf.launches
        if i == 1:  # one replay under the profiler: its kernels run on the device
            m_g = []
            prof = busy_share(lambda: m_g.append(g_step(g_state, b, d)))
            assert prof["raster_kernels"] == N_ITER, prof
            m_g = m_g[0]
        else:
            m_g = g_step(g_state, b, d)
        # the first call: the warm-up (the call's step) and the capture
        assert rf.launches - n0 == (2 * N_ITER if i == 0 else 0), (i, rf.launches - n0)
        m_e = e_step.eager(e_state, b, d)
        assert m_g == m_e and m_g["skipped_nonfinite"] == 0.0, (i, m_g, m_e)
        _assert_equal(_state(g_state), _state(e_state), i)
    assert len(g_step.graphs) == 1


@pytest.mark.cuda
def test_train_step_captures_on_the_card(card):
    """3 steps across a rate change: graph = eager bit for bit after every
    step, one update a call, 2 x N_ITER wrapper launches on the first call
    and none on a replay, N_ITER rasterizing kernels in a replay's trace."""
    _train_both(*_world(card))


@pytest.mark.cuda
def test_data_parallel_step_captures_nccl_on_the_card(card):
    """The `--dp` step on a one-rank NCCL group (`make_mesh`): its
    all-reduces and the synced BatchNorm's all-gathers are captured with
    the step, which equals the eager data-parallel step bit for bit."""
    import torch.distributed as dist

    from happypose_tpu_torch.parallel import make_mesh

    own = not dist.is_initialized()
    mesh = make_mesh(device_type="cuda")
    try:
        _train_both(*_world(card, mesh))
    finally:
        if own:
            dist.destroy_process_group()
