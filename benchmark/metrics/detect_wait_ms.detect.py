"""detect_wait_ms.detect (ms/frame): the traced stretch's device-idle time
whose midpoint falls inside one of the program's `detector.*` spans (the
forward graph's call, and the post-processing: NMS, its read-back and the
detection rows), over the stretch's frames."""

from benchmark import program_readers

SOURCE = "device_trace"
LAYER = "inference: detector (forward graph, host post-processing)"
MOVES = "poses_per_s.detect"
WORKLOADS = ["cosypose-bop"]


def read(run):
    return program_readers.idle_ms_per_item(run, ["detector."])
