"""capture_s.track (s): the seconds of every CUDA graph capture of the
process (`graphs.*.capture_s`, the program's `GraphCache` counters: each
key's warm-up, capture and first replay, timed on the host's clock), the
set-up's and any made in the window. In tracking they are the refiner's
stage graphs, one an object count. A program that captures nothing there
reads None."""

from benchmark import program_readers

SOURCE = "host_clock"
LAYER = "utils: cuda_graphs (the captures of every GraphCache)"
MOVES = "setup_s"
WORKLOADS = ["megapose-track"]


def read(run):
    return program_readers.capture_s(run)
