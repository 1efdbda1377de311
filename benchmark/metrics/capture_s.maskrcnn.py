"""capture_s.maskrcnn (s): the seconds of every CUDA graph capture of the
process (`graphs.*.capture_s`, the program's `GraphCache` counters: here
the detector's one key, its warm-up, capture and first replay, on the
host's clock), the set-up's and any made in the window."""

from benchmark import program_readers

SOURCE = "host_clock"
LAYER = "utils: cuda_graphs (the captures of every GraphCache)"
MOVES = "setup_s"
WORKLOADS = ["maskrcnn-bop"]


def read(run):
    return program_readers.capture_s(run)
