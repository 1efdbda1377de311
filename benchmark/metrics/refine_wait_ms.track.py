"""refine_wait_ms.track (ms/frame): the traced stretch's device-idle time
whose midpoint falls inside the program's `estimator.refine` span (the
eager refiner iteration: its `predictor.*` spans and the dispatch between
its operations), over the stretch's frames. A graph of the refiner path
should take it down."""

from benchmark import program_readers

SOURCE = "device_trace"
LAYER = "models: pose_predictor + backbones (the whole frame)"
MOVES = "poses_per_s.track"
WORKLOADS = ["megapose-track"]


def read(run):
    return program_readers.idle_ms_per_item(run, ["estimator.refine"])
