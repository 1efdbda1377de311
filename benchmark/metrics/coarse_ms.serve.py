"""coarse_ms.serve (ms/pose): the device time of the program's coarse stage
(`stage.estimator.coarse.device_ms`: the grid's autodepth inits, renders
and 576 D ResNet34 forwards, timed by CUDA events that the frame's graph
holds and read for each replay in the traced stretch) over the stretch's
poses."""

from benchmark import program_readers

SOURCE = "device_trace"
LAYER = "inference: pose_estimator + utils/cuda_graphs (stages, graph keys, dispatch)"
MOVES = "poses_per_s"
WORKLOADS = ["megapose-bop"]


def read(run):
    return program_readers.stage_ms_per_unit(run, "estimator.coarse")
