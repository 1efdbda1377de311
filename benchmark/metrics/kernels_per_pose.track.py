"""kernels_per_pose.track (kernels/pose): the device's kernels and copies in
the traced stretch over the poses its frames returned."""

from benchmark import readers

SOURCE = "device_trace"
LAYER = "inference: pose_estimator + utils/cuda_graphs (stages, graph keys, dispatch)"
MOVES = "poses_per_s.track"
WORKLOADS = ["megapose-track"]


def read(run):
    return readers.kernels_per_unit(run)
