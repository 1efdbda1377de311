"""detect_wait_ms.maskrcnn (ms/frame): the traced stretch's device-idle time
whose midpoint falls inside one of the program's `detector.*` spans (the
forward graph's call and replay, and the post-processing: the read-back of
the detections, the rows and the kept masks' read-back), over the
stretch's frames."""

from benchmark import program_readers

SOURCE = "device_trace"
LAYER = "inference: detector (forward graph, host post-processing)"
MOVES = "frame_ms_p95.detect"
WORKLOADS = ["maskrcnn-bop"]


def read(run):
    return program_readers.idle_ms_per_item(run, ["detector."])
