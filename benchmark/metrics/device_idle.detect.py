"""device_idle.detect (%): the share of the traced stretch in which no kernel
or copy ran on the card (the union of the device's intervals, not a sum of
kernel times)."""

from benchmark import readers

SOURCE = "device_trace"
LAYER = "device: one H100"
MOVES = "poses_per_s.detect"
WORKLOADS = ["cosypose-bop"]


def read(run):
    return readers.device_idle(run)
