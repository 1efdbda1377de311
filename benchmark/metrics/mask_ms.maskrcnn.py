"""mask_ms.maskrcnn (ms/frame): the device time of the detector's mask
stage (`stage.detector.mask.device_ms`: RoIAlign 14x14 of the 100
detection slots, four 3x3 convs, the transposed conv, the class logits
and each mask's paste into the 480x640 frame) over the traced stretch's
frames."""

from benchmark import program_readers

SOURCE = "device_trace"
LAYER = "models: mask_rcnn (RPN, box and mask stages)"
MOVES = "frame_ms_p95.detect"
WORKLOADS = ["maskrcnn-bop"]


def read(run):
    return program_readers.stage_ms_per_unit(run, "detector.mask")
