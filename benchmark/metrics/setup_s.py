"""setup_s (s, host clock): process start to the first timed item: imports,
the rasterizer's build or load from the checkout's cache, the seeded world,
the program's construction, its graph captures and warm-up."""

SOURCE = "host_clock"


def read(run):
    return run.setup_s
