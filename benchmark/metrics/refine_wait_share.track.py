"""refine_wait_share.track (%): the traced stretch's device-idle time whose
midpoint falls inside the program's `estimator.refine` span, as a share of
the stretch. `refine_wait_ms.track` reads the same gaps in ms a frame; the
profiler's own host time falls in both, and a traced frame takes about
twice an untraced one, so the ms swing with the host's speed from run to
run where the share holds. A graph of the refiner path should take it
down."""

from benchmark import program_readers

SOURCE = "device_trace"
LAYER = "models: pose_predictor + backbones (the whole frame)"
MOVES = "poses_per_s.track"
WORKLOADS = ["megapose-track"]


def read(run):
    return program_readers.idle_share(run, ["estimator.refine"])
