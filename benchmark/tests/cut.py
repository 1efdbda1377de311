"""Cells cut to a size the CPU runs in seconds: every width of the
configuration as it is, the renders, images, grid, objects and batches
small."""

OBJECTS = {"count": 4, "n_lat": 7, "n_lon": 10, "texture_size": 256, "diameter_m": [0.06, 0.2]}
CONFIG = {"render_size": [24, 32], "so3_grid_size": 72, "n_points": 64, "objects": OBJECTS}
# train-mode batch norms need more than a few values a channel
TRAIN_CONFIG = {**CONFIG, "render_size": [48, 64]}

OVERRIDES = {
    "megapose-bop": {
        "config": CONFIG,
        "mix": {"image_size": [48, 64], "detections": [1, 2], "box_side_px": [8, 30],
                "focal_px": [60, 70], "principal_offset_px": 2, "images": 2, "frames": 6},
        "cell": {"sample": 2, "trace_items": 2}},
    "megapose-track": {
        "config": CONFIG,
        "mix": {"image_size": [48, 64], "objects": [1, 2, 3], "focal_px": [60, 70],
                "principal_offset_px": 2, "images": 2, "sessions": 3, "frames_per_session": 3,
                "margin_px": 10},
        "cell": {"sample": 4, "trace_items": 4}},
    "cosypose-bop": {
        "config": {**CONFIG, "detector": {"fpn_channels": 32, "n_prototypes": 16,
                                          "image_size": [48, 64], "detection_th": 0.0,
                                          "max_detections": 8, "iou_threshold": 0.5}},
        "mix": {"image_size": [96, 128], "detections": [1, 2], "box_side_px": [16, 60],
                "focal_px": [120, 140], "principal_offset_px": 2, "images": 2, "frames": 6},
        "cell": {"sample": 2, "trace_items": 2}},
    "megapose-train": {
        "config": TRAIN_CONFIG,
        "mix": {"image_size": [96, 128], "batch_size": 4, "focal_px": 80.0},
        "cell": {"trace_items": 2}},
}


def run(cell: str, seed: int = 12345678901, seconds: float = 2.0, trace: bool = False,
        control: bool = False):
    import time

    from benchmark import harness

    return harness.run_cell(cell, seed, seconds, trace, time.perf_counter(), device="cpu",
                            overrides=OVERRIDES[cell], control=control)
