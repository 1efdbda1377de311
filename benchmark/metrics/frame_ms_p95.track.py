"""frame_ms_p95.track (ms, host clock): the 95th percentile (numpy's linear
interpolation) of the frames completed in the window, each from its host
arrays handed to the program to its poses on the host."""

SOURCE = "host_clock"


def read(run):
    return run.latency_ms(95)
