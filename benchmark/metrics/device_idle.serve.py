"""device_idle.serve (%): the share of the traced stretch in which no kernel
or copy ran on the card (the union of the device's intervals, not a sum of
kernel times)."""

from benchmark import readers

SOURCE = "device_trace"
LAYER = "device: one H100"
MOVES = "poses_per_s"
WORKLOADS = ["megapose-bop"]


def read(run):
    return readers.device_idle(run)
