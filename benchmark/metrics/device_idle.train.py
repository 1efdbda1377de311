"""device_idle.train (%): the share of the traced stretch of training steps
in which no kernel or copy ran on the card (the union of the device's
intervals)."""

from benchmark import readers

SOURCE = "device_trace"
LAYER = "device: one H100"
MOVES = "train_samples_per_s"
WORKLOADS = ["megapose-train"]


def read(run):
    return readers.device_idle(run)
