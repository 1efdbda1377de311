"""The plain reference against the port at a cut size on the CPU (where
the port renders with its plain rasterizer): the renders bit for bit, each
cell's compared numbers; the control (the reference one precision below,
TF32 emulated by rounding every product's inputs) and faults planted under
the timed path come out not correct."""

import numpy as np
import pytest
import torch

from benchmark import harness, world
from benchmark.reference import geometry as G
from benchmark.reference import raster
from benchmark.tests import cut
from benchmark.tests.faults import FAULTS, plant


def test_render_is_the_programs_bit_for_bit():
    from happypose_tpu_torch.ops.rasterizer_fused import render_batch_fused

    objects = world.make_objects(np.random.default_rng(3), cut.OBJECTS)
    assets = world.program_database(objects).render_assets(device="cpu")
    B = 8
    T = G.make_T(G.so3_grid(72, "cpu")[::9][:B], torch.tensor([[0.01, -0.02, 0.45]] * B))
    K = torch.tensor([[[90.0, 0, 40.5], [0, 90.0, 29.5], [0, 0, 1]]] * B)
    ids = torch.arange(B) % cut.OBJECTS["count"]
    out = render_batch_fused(assets, ids, T, K, resolution=(60, 80))
    rgb, n, mask = raster.render(world.reference_meshes(objects, "cpu"), ids, T, K, (60, 80))
    assert mask.float().mean() > 0.05
    assert torch.equal(out.rgb, rgb) and torch.equal(out.normals, n) and torch.equal(out.mask, mask)


@pytest.mark.parametrize("cell", ["megapose-bop", "cosypose-bop", "megapose-track"])
def test_serving_cells_agree(cell):
    r = cut.run(cell)
    assert r["correct"] is True
    for name, c in r["checks"].items():
        assert c["value"] <= 1e-6, (name, c)


def test_training_cell_agrees():
    r = cut.run("megapose-train")
    checks = {k: c["value"] for k, c in r["checks"].items()}
    assert checks["grad_gap"] <= 1e-5, checks


@pytest.mark.parametrize("cell", ["megapose-bop", "cosypose-bop", "megapose-track",
                                  "megapose-train"])
def test_controls_read_far_above_the_program(cell):
    """The control (TF32, emulated here), and each fault planted in the
    reference put in the program's place, reads a number of the cell ten
    times the program's and above 1e-4. (Whether it fails the limit is a
    question of the cell's own size: `test_bench_card.py` asks it there.)"""
    r = cut.run(cell, control=True)
    controls = set(r["checks"]) - {"program"}
    assert controls == set(harness.load_runner(harness.load_cell(cell)["runner"]).Runner.CONTROLS)
    prog = r["checks"]["program"]
    for name in controls:
        assert any(c["value"] > max(10 * prog[k]["value"], 1e-4)
                   for k, c in r["checks"][name].items()), (name, r["checks"])


@pytest.mark.parametrize("cell,fault", sorted(FAULTS))
def test_planted_fault_is_not_correct(cell, fault, monkeypatch):
    plant(cell, fault, monkeypatch)
    r = cut.run(cell)
    assert r["correct"] is False or r["failed"] > 0, r["checks"]
