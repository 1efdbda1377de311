"""step_wait_ms.train (ms/step): the traced stretch's device-idle time
whose midpoint falls inside one of the program's `train.*` spans (the
synthetic batch's call, the step's replay, the metrics' read-back), over
the stretch's steps."""

from benchmark import program_readers

SOURCE = "device_trace"
LAYER = "training: trainer + synth_data + losses (the whole step)"
MOVES = "train_samples_per_s"
WORKLOADS = ["megapose-train"]


def read(run):
    return program_readers.idle_ms_per_item(run, ["train."])
