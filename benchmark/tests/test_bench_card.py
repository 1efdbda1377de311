"""On the card: the reference's renders against the hand-written kernel at
the configuration's size, the comparison's control (the reference in TF32
in the program's place) and faults planted in the reference at each cell's
own size, and the training cell's faults planted in the program, where the
graphs capture them and the checked steps replay them. Run there with

    python3 -m pytest -p no:cacheprovider benchmark/tests/test_bench_card.py -q -m cuda
"""

import numpy as np
import pytest
import torch

from benchmark import harness, world
from benchmark.reference import geometry as G
from benchmark.reference import raster
from benchmark.tests.faults import FAULTS, plant


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_render_is_the_kernels_bit_for_bit(card):
    from happypose_tpu_torch.ops.rasterizer_fused import render_batch_fused

    spec = harness.read_json(harness.HERE / "configs" / "megapose-rgb.json")["objects"]
    objects = world.make_objects(np.random.default_rng(11), spec)
    assets = world.program_database(objects).render_assets(device=card)
    B = 16
    T = G.make_T(G.so3_grid(576, card)[::36][:B],
                 torch.tensor([[0.01, -0.02, 0.6]] * B, device=card))
    K = torch.tensor([[[600.0, 0, 159.5], [0, 600.0, 119.5], [0, 0, 1]]] * B, device=card)
    ids = torch.arange(B, device=card) % spec["count"]
    out = render_batch_fused(assets, ids, T, K, resolution=(240, 320))
    rgb, n, mask = raster.render(world.reference_meshes(objects, card), ids, T, K, (240, 320))
    assert mask.float().mean() > 0.05
    assert torch.equal(out.mask, mask)
    assert (out.rgb - rgb).abs().max().item() == 0.0
    assert (out.normals - n).abs().max().item() == 0.0


# the cells at their own size, with a few frames or steps of traffic, and a
# window long enough to finish some (a megapose frame at D = 2 takes ~0.6 s)
OWN_SIZE = {
    "megapose-bop": ({"mix": {"detections": [2], "frames": 3}, "cell": {"sample": 1}}, 2.0),
    "cosypose-bop": ({"mix": {"detections": [4], "frames": 3}, "cell": {"sample": 2}}, 0.5),
    "megapose-track": ({"mix": {"objects": [4], "sessions": 2, "frames_per_session": 4},
                        "cell": {"sample": 4}}, 0.5),
    "megapose-train": ({}, 0.5),
}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(OWN_SIZE))
def test_controls_fail_and_program_passes(card, cell):
    """At the cell's own size: the program within every limit, the control
    (TF32) and each planted fault outside one."""
    import time

    overrides, seconds = OWN_SIZE[cell]
    r = harness.run_cell(cell, 2**31 + 3, seconds, False, time.perf_counter(), device="cuda",
                         overrides=overrides, control=True)
    assert r["attempted"] > 0 and r["failed"] == 0
    prog = r["checks"].pop("program")
    assert all(c["value"] <= c["limit"] for c in prog.values()), prog
    for name, ctrl in r["checks"].items():
        assert any(c["value"] > c["limit"] for c in ctrl.values()), (name, ctrl)


@pytest.mark.cuda
@pytest.mark.parametrize("fault", sorted(f for c, f in FAULTS if c == "megapose-train"))
def test_training_faults_in_the_replays_are_not_correct(card, fault, monkeypatch):
    """The training cell at its own size with a fault in the program: the
    capture records it, the checked steps replay it, and the run is not
    correct."""
    import time

    plant("megapose-train", fault, monkeypatch)
    r = harness.run_cell("megapose-train", 2**31 + 7, 0.5, False, time.perf_counter(),
                         device="cuda")
    assert r["correct"] is False or r["failed"] > 0, r["checks"]
