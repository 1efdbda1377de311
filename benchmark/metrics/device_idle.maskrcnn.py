"""device_idle.maskrcnn (%): the share of the traced stretch in which no
kernel or copy ran on the card (the union of the device's intervals, not a
sum of kernel times)."""

from benchmark import readers

SOURCE = "device_trace"
LAYER = "device: one H100"
MOVES = "frame_ms_p95.detect"
WORKLOADS = ["maskrcnn-bop"]


def read(run):
    return readers.device_idle(run)
