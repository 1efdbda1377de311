"""score_ms.serve (ms/pose): the device time of the program's scoring stage
(`stage.estimator.score.device_ms`: the renders of the refined top-K poses
and the 5 D ResNet34 coarse-classifier forwards that pick one, timed by
CUDA events that the frame's graph holds and read for each replay in the
traced stretch) over the stretch's poses."""

from benchmark import program_readers

SOURCE = "device_trace"
LAYER = "inference: pose_estimator + utils/cuda_graphs (stages, graph keys, dispatch)"
MOVES = "poses_per_s"
WORKLOADS = ["megapose-bop"]


def read(run):
    return program_readers.stage_ms_per_unit(run, "estimator.score")
