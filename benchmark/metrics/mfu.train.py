"""mfu.train (%): the model FLOPs of the training steps completed in the
traced stretch over the stretch's seconds x the card's float32 peak (67
TFLOP/s outside the tensor cores). A step's FLOPs are 3 x the forward's
(forward and backward) of each refiner iteration of each sample, from the
configuration's layer tables (`benchmark/flops.py`); the synthetic batch's
render counts nothing."""

from benchmark import readers

SOURCE = "device_trace"
LAYER = "training: trainer + synth_data + losses (the whole step)"
MOVES = "train_samples_per_s"
WORKLOADS = ["megapose-train"]


def read(run):
    return readers.mfu(run)
