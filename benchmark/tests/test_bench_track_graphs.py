"""megapose-track's refiner through its stage graphs, at the CPU's cut
size: set-up (`warm`, one frame of each object count) makes one stage key
an object count, and the window's frames replay them, one replay a frame
(every count fits one chunk), and capture nothing. `capture_s.track` reads
the capture counters and names its file's constants in BENCHMARK.json."""

import torch

from benchmark import harness
from benchmark.tests import cut

SPEC = harness.benchmark_spec()


def test_a_tracked_frame_is_one_stage_replay():
    from happypose_tpu_torch.utils import profiling

    c = harness.load_cell("megapose-track", cut.OVERRIDES["megapose-track"])
    drv = harness.load_runner(c["runner"]).Runner(c, 3000000019, torch.device("cpu"))
    before = profiling.counters()
    drv.warm()
    warmed = profiling.counters()
    items = drv.traffic["items"][:4]
    for item in items:
        drv.run(item)
    after = profiling.counters()
    drv.release()

    def grown(a, b, what):
        return b.get(f"graphs.stage.{what}", 0) - a.get(f"graphs.stage.{what}", 0)

    counts = {len(it["obj_ids"]) for it in drv.traffic["items"] if it["init"] is not None}
    assert grown(before, warmed, "captures") == len(counts)
    assert grown(warmed, after, "captures") == 0
    assert grown(warmed, after, "replays") == len(items)


def test_capture_s_track_names_its_file():
    mod = harness.load_metric("capture_s.track")
    m = {m["name"]: m for m in SPEC["per_layer"]}["capture_s.track"]
    assert (mod.SOURCE, mod.LAYER, mod.MOVES, mod.WORKLOADS) == (
        m["source"], m["layer"], m["moves"], m["workloads"])
