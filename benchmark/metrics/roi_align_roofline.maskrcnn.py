"""roi_align_roofline.maskrcnn (%): the RoIAlign kernel's least time over
its device time in the traced stretch (`roi_align_kernel`, two calls a
frame: 7x7 of the proposal slots, 14x14 of the detection slots). The least
time is the larger of the bytes over the card's 3.35 TB/s (the outputs
written once, and each feature value that the call's RoIs' bilinear taps
touch, counted once over the call, read once) and 8 flops a sample over
67 TFLOP/s (`maskrcnn_counts.roi_align_work`, from the program's own boxes
of the stretch's frames)."""

SOURCE = "device_trace"
LAYER = "ops: nms + multiscale_roi_align + csrc/mask_rcnn_ops.cu (the hand-written kernels)"
MOVES = "frame_ms_p95.detect"
WORKLOADS = ["maskrcnn-bop"]
KERNELS = ("roi_align_kernel",)


def read(run):
    s = run.stretch
    seconds = s.device_seconds(KERNELS)
    if seconds <= 0 or not hasattr(run.runner, "roi_work"):
        return None
    n_bytes, n_flops = run.runner.roi_work(s.records)
    least = max(n_bytes / run.peaks["hbm_bytes_per_s"],
                n_flops / run.peaks["float32_flops_per_s"])
    return 100.0 * least / seconds
