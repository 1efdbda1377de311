"""rpn_ms.maskrcnn (ms/frame): the device time of the detector's RPN stage
(`stage.detector.rpn.device_ms`: the RPN head on P2-P6, the per-level top
anchors, their decoding and the level-aware NMS kernel, timed by CUDA
events that the detector's graph holds and read for each replay in the
traced stretch) over the stretch's frames."""

from benchmark import program_readers

SOURCE = "device_trace"
LAYER = "models: mask_rcnn (RPN, box and mask stages)"
MOVES = "frame_ms_p95.detect"
WORKLOADS = ["maskrcnn-bop"]


def read(run):
    return program_readers.stage_ms_per_unit(run, "detector.rpn")
