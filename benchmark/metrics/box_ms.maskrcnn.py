"""box_ms.maskrcnn (ms/frame): the device time of the detector's box stage
(`stage.detector.box.device_ms`: RoIAlign 7x7 of the 1,000 proposal slots,
the TwoMLPHead and box predictor, decoding, the pair budget's sort and the
class-aware NMS kernel) over the traced stretch's frames."""

from benchmark import program_readers

SOURCE = "device_trace"
LAYER = "models: mask_rcnn (RPN, box and mask stages)"
MOVES = "frame_ms_p95.detect"
WORKLOADS = ["maskrcnn-bop"]


def read(run):
    return program_readers.stage_ms_per_unit(run, "detector.box")
