"""mfu.detect (%): the model FLOPs of the frames completed in the traced
stretch over the stretch's seconds x the card's float32 peak (67 TFLOP/s
outside the tensor cores, the configurations' precision). The FLOPs come from
the configuration's layer tables (`benchmark/flops.py`) times the forwards a
frame implies (MegaPose: 576 D coarse + 25 D refiner + 5 D scoring; tracking:
K a frame), never from the kernels launched."""

from benchmark import readers

SOURCE = "device_trace"
LAYER = "models: pose_predictor + backbones (the whole frame)"
MOVES = "poses_per_s.detect"
WORKLOADS = ["cosypose-bop"]


def read(run):
    return readers.mfu(run)
