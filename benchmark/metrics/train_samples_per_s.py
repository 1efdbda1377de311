"""train_samples_per_s (samples/s, host clock): training samples of all steps
completed in the window (each step's synthetic batch included), over the
time from the window's start to the end of the last one."""

SOURCE = "host_clock"


def read(run):
    return run.rate()
