"""nms_roofline.maskrcnn (%): the NMS kernels' least time over their device
time in the traced stretch (`nms_mask_kernel` and `nms_scan_kernel`, both
calls a frame: the RPN's and the box stage's). The least time is their
bytes over the card's 3.35 TB/s: each call's candidates (boxes, groups,
flags) read once and its IoU bitmask written once
(`maskrcnn_counts.nms_bytes`); the scan's sequential work counts nothing,
so the share says how far the scan's latency is from the bytes."""

SOURCE = "device_trace"
LAYER = "ops: nms + multiscale_roi_align + csrc/mask_rcnn_ops.cu (the hand-written kernels)"
MOVES = "frame_ms_p95.detect"
WORKLOADS = ["maskrcnn-bop"]
KERNELS = ("nms_mask_kernel", "nms_scan_kernel")


def read(run):
    s = run.stretch
    seconds = s.device_seconds(KERNELS)
    if seconds <= 0 or not hasattr(run.runner, "nms_bytes"):
        return None
    return 100.0 * run.runner.nms_bytes(s.records) / run.peaks["hbm_bytes_per_s"] / seconds
