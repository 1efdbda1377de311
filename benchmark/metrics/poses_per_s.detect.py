"""poses_per_s.detect (poses/s, host clock): final poses returned in the window (one
a detection or tracked object), over the time from the window's start to the
end of the last frame completed in it."""

SOURCE = "host_clock"


def read(run):
    return run.rate()
