"""mfu.maskrcnn (%): the model FLOPs of the frames completed in the traced
stretch over the stretch's seconds x the card's float32 peak (67 TFLOP/s
outside the tensor cores, the configuration's precision). A frame's FLOPs
are 2 x its multiply-accumulates at its shapes (`benchmark/maskrcnn_counts.py`:
the ResNet50 trunk, the FPN, the RPN head on P2-P6, the box head on 1,000
proposal slots, the mask branch on 100 detection slots), never counted
from the kernels launched."""

from benchmark import readers

SOURCE = "device_trace"
LAYER = "models: mask_rcnn (the whole frame)"
MOVES = "frame_ms_p95.detect"
WORKLOADS = ["maskrcnn-bop"]


def read(run):
    return readers.mfu(run)
