"""The port's measured entry points on one CUDA card (PyTorch port of the
JAX package's root `bench.py` and of `__graft_entry__.entry()`).

    python3 -m happypose_tpu_torch.bench [--mesh debug|bop3k|bop_full] [--batch B]
    python3 -m happypose_tpu_torch.bench --pipeline [--so3 N]
    python3 -m happypose_tpu_torch.bench --breakdown

The last line of the output is the JAX bench's JSON line: refiner
pose-iterations/s (`{"metric", "value", "unit", "vs_baseline"}`), detector
-> megapose-RGB s/image (`--pipeline`), or the per-stage ms of a refiner
iteration (`--breakdown`). Earlier lines name the card (its name, count and
power limit), the precision (the compute dtype; PyTorch's two TF32 flags,
off in every mode: `TF32`), the kernel's launches and, for the refiner,
the device's busy share.

One pose-iteration = crop -> render (240x320, the hand-written CUDA
rasterizer) -> CNN (ResNet34) -> SE(3) update for one object hypothesis.
The refiner runs one warm call, then `N_SCAN` single-iteration calls, each
fed the previous call's pose (the JAX bench's `lax.scan` body), timed on
the host clock around work that ends in `torch.cuda.synchronize()`. As the
JAX bench runs compiled programs, the refiner's iteration is the stage
graph `_refine_fn` (captured by the warm call, replayed after) and the
pipeline's frame is `run_inference_pipeline_jit` (captured by the warm
image); `--breakdown` times the eager stages.

vs_baseline is measured against the JAX bench's anchors: 50
pose-iterations/s/GPU for the reference's V100-era refiner at
bsz_objects = 16 with 240x320 renders, and 39.7 s/image for its evaluation
envelope (16 GPU-hours / 1450 keyframes, range 28.8-64.0). Weights are
seeded (the pose head an identity update): wall-clock is architecture- and
shape-bound, not value-bound.

The CLI runs on the card only: without one it fails with PyTorch's own
error. The functions take `device="cpu"` for the tests, which run them at
cut sizes against the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from happypose_tpu_torch.inference.detector import Detector
from happypose_tpu_torch.inference.pose_estimator import _refine_fn
from happypose_tpu_torch.inference.types import DetectionBatch, InferenceConfig, ObservationBatch
from happypose_tpu_torch.lib3d.so3_grid import load_SO3_grid
from happypose_tpu_torch.meshes import io
from happypose_tpu_torch.meshes.database import MeshDataBase
from happypose_tpu_torch.models.detector import DetectorConfig, FCOSDetector
from happypose_tpu_torch.models.pose_predictor import PosePredictor, PosePredictorConfig
from happypose_tpu_torch.ops import rasterizer_fused as rf
from happypose_tpu_torch.ops.crop_resize import crop_images_matmul
from happypose_tpu_torch.utils.load_model import load_named_model

REFERENCE_POSE_ITERS_PER_SEC = 50.0  # V100-era anchor, see the docstring
B = 16  # bsz_objects (the reference's default)
N_SCAN = 20
RES = (240, 320)
K_BENCH = ((600.0, 0.0, 160.0), (0.0, 600.0, 120.0), (0.0, 0.0, 1.0))
# the reference's evaluation envelope: 16 GPU-h / keyframes of one BOP dataset
BASELINE_S_PER_IMAGE = 39.7
BASELINE_S_PER_IMAGE_RANGE = [28.8, 64.0]
BASELINE_KEYFRAMES = 1450
# the reference's typical load: 4 instances an image, fixed boxes
PIPELINE_BOXES = ((60, 40, 140, 120), (160, 50, 240, 130), (80, 120, 160, 200),
                  (180, 130, 260, 210))
PIPELINE_OBJ_IDS = (0, 1, 0, 1)
# the reference's BOP test mesh: not in the repository yet, so `--mesh bop3k`
# and `--mesh bop_full` raise until it is committed here
BOP_PLY = Path(__file__).resolve().parent / "data" / "obj_000001.ply"
# TF32 off in every mode, whatever PyTorch's defaults: "float32" is float32
TF32 = False


def _mesh_db(mesh_set: str) -> MeshDataBase:
    """Bench mesh sets.

    "debug": 24x32 sphere + box (1536 faces padded).
    "bop3k": the reference's BOP test mesh decimated to 3000 faces (the
      size real BOP objects arrive at after decimation).
    "bop_full": the same mesh undecimated (15.7k faces).
    """
    if mesh_set == "debug":
        return MeshDataBase(meshes={
            "sphere": io.make_uv_sphere(radius=0.05, n_lat=24, n_lon=32),
            "box": io.make_box_mesh((0.04, 0.03, 0.05)),
        })
    if mesh_set not in ("bop3k", "bop_full"):
        raise SystemExit(f"unknown --mesh set {mesh_set}")
    if not BOP_PLY.exists():
        raise FileNotFoundError(
            f"--mesh {mesh_set} waits for the reference's BOP test mesh obj_000001.ply, "
            f"which is not in the repository: commit it at {BOP_PLY}")
    m = io.load_mesh(BOP_PLY)
    scales = {"bop": 1e-3, "bop2": 1e-3} if m.diameter > 1.0 else {}
    if mesh_set == "bop3k":
        m = io.decimate_mesh(m, 3000)
    return MeshDataBase(meshes={"bop": m, "bop2": m}, scales=scales)


def bench_inputs(batch: int, device) -> Tuple[torch.Tensor, ...]:
    """The JAX bench's inputs: `RandomState(0)` images [B, 3, 240, 320], its
    K, object ids alternating 0 / 1 and poses at z = 0.5."""
    images = np.random.RandomState(0).rand(batch, 3, *RES).astype(np.float32)
    K = torch.tensor(K_BENCH).expand(batch, 3, 3)
    obj_ids = torch.tensor([0, 1] * (batch // 2))
    TCO = torch.eye(4).repeat(batch, 1, 1)
    TCO[:, 2, 3] = 0.5
    return tuple(t.to(device) for t in (torch.from_numpy(images), K, obj_ids, TCO))


def seeded_predictor(cfg: PosePredictorConfig, device) -> PosePredictor:
    """The bench's pose model: weights seeded from 0, eval mode, on `device`."""
    return PosePredictor(cfg).init_weights(torch.Generator().manual_seed(0)).to(device).eval()


def _compute_dtype(device) -> str:
    """bfloat16 on the card, as the JAX bench runs on its accelerator;
    float32 on the CPU."""
    return "bfloat16" if torch.device(device).type == "cuda" else "float32"


def precision(dtype: str) -> str:
    """A mode's precision as its lines print it: the compute dtype and TF32."""
    return f"{dtype}, tf32 {'on' if TF32 else 'off'}"


@contextlib.contextmanager
def _tf32():
    """PyTorch's two TF32 flags set to `TF32` for a mode's run, and restored
    after it, so that a measurement does not depend on the caller's."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = TF32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _ms(fn: Callable[[], object], device, n_runs: int) -> float:
    """Mean ms of `fn()` over `n_runs` launches after one warm call: CUDA
    events on the card, the host clock on the CPU (the tests' runs)."""
    fn()
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(n_runs):
            fn()
        return (time.perf_counter() - t0) / n_runs * 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n_runs):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n_runs


def busy_share(fn: Callable[[], object]) -> Dict[str, float]:
    """One call of `fn` under `torch.profiler` (device activity only): the
    device's kernels and copies, the seconds in which at least one of them
    ran (the union of their intervals, so that kernels that overlap count
    once and the share stays at most 1), the call's wall time and the
    rasterizing kernels among them (`raster_kernels`: one a launch, counted
    on the device, so a CUDA graph's replays count too)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = _union_s([(e.time_range.start, e.time_range.end) for e in device]) * 1e-6
    return {"device_kernels": len(device),
            "raster_kernels": sum(rf.KERNEL_NAME in e.name for e in device),
            "busy_s": busy, "wall_s": wall, "busy_share": busy / wall}


def _union_s(spans) -> float:
    """The length of the union of (start, end) intervals."""
    total, end = 0.0, -math.inf
    for s, e in sorted(spans):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


# ---------------------------------------------------------------- entry()


def _world(device):
    """`__graft_entry__._world`: a textured UV sphere (10 x 12, procedural
    texture of 64 from seed 3) and a vertex-coloured box; 96 points an
    object."""
    sphere = io.make_uv_sphere(radius=0.05, n_lat=10, n_lon=12, with_uv=True)
    sphere.texture = io.make_procedural_texture(64, seed=3)
    db = MeshDataBase(meshes={"sphere": sphere, "box": io.make_box_mesh((0.04, 0.03, 0.05))})
    return (db, db.render_assets(texture_size=64, device=device),
            db.batched(n_points=96, device=device))


def entry(device="cuda"):
    """The flagship forward step: one MegaPose refiner iteration (crop ->
    render through the CUDA rasterizer -> ResNet34 on 240x320 -> SE(3)
    update), float32, B = 4, on the textured world of `_world`.

    Returns `(forward, example_args)`; `forward(images, K, obj_ids, TCO)`
    returns the iteration's output poses [B, 4, 4]. The module (seeded
    weights) and the render assets are closed over: unlike JAX's, the
    function takes no Flax `variables`."""
    _, assets, bm = _world(device)
    model = seeded_predictor(PosePredictorConfig(backbone="resnet34", render_size=RES), device)
    images, K, obj_ids, TCO = bench_inputs(4, device)  # obj_ids [0, 1, 0, 1]

    @_tf32()
    @torch.inference_mode()
    def forward(images, K, obj_ids, TCO):
        out = model(images, K, obj_ids, TCO, assets, bm.select(obj_ids), n_iterations=1)
        return out.TCO_output[-1]

    return forward, (images, K, obj_ids, TCO)


# ---------------------------------------------------------------- refiner


def refiner_line(mesh_set: str, batch: int, pose_iters_per_sec: float) -> dict:
    """The JAX bench's JSON line of the refiner."""
    metric = "refiner_pose_iterations_per_sec_per_chip"
    if mesh_set != "debug":
        metric += f"_{mesh_set}"
    if batch != 16:
        metric += f"_b{batch}"
    return {
        "metric": metric,
        "value": round(pose_iters_per_sec, 2),
        "unit": "pose-iters/s (crop+render240x320+resnet34+update)",
        "vs_baseline": round(pose_iters_per_sec / REFERENCE_POSE_ITERS_PER_SEC, 2),
    }


@_tf32()
def refiner_bench(mesh_set: str = "debug", batch: int = B, device="cuda") -> Tuple[dict, dict]:
    """Refiner pose-iterations/s at `batch` on `mesh_set`: one warm call
    (it captures the stage graph), then `N_SCAN` chained single-iteration
    replays. Returns (the JSON line, notes: compute dtype, the wrapper's
    kernel launches of the run (the capture's warm-up and recording), the
    final poses and, on the card, the busy share and the device's launches
    of a second, profiled window)."""
    dev = torch.device(device)
    db = _mesh_db(mesh_set)
    assets = db.render_assets(device=dev)
    meshes_db = db.batched(n_points=512, device=dev)
    dtype = _compute_dtype(dev)
    model = seeded_predictor(
        PosePredictorConfig(backbone="resnet34", render_size=RES, compute_dtype=dtype), dev)
    images, K, obj_ids, TCO0 = bench_inputs(batch, dev)
    meshes = meshes_db.select(obj_ids)

    def step(TCO):
        return _refine_fn(model, images, K, obj_ids, TCO, assets, meshes, 1)[-1]

    def many(TCO):
        for _ in range(N_SCAN):
            TCO = step(TCO)
        return TCO

    launches0 = rf.launches
    step(TCO0)  # warm: the capture (cuDNN's algorithms, the allocator)
    _sync(dev)
    t0 = time.perf_counter()
    TCO = many(TCO0)
    _sync(dev)
    dt = time.perf_counter() - t0
    notes = {"compute_dtype": precision(dtype), "launches": rf.launches - launches0, "seconds": dt,
             "TCO": TCO}
    if dev.type == "cuda":
        notes["profile"] = busy_share(lambda: many(TCO0))
        notes["launches_with_profile"] = rf.launches - launches0
    return refiner_line(mesh_set, batch, batch * N_SCAN / dt), notes


# ---------------------------------------------------------------- pipeline


def frame_launches(cfg: InferenceConfig, n_detections: int, grid_size: int) -> int:
    """Kernel launches of one MegaPose frame: coarse chunks of `bsz_images`
    hypotheses, refiner chunks of `bsz_objects` rows x iterations, scoring
    chunks of `bsz_images` rows."""
    n_refine = n_detections * cfg.n_pose_hypotheses
    return (math.ceil(grid_size * n_detections / cfg.bsz_images)
            + math.ceil(n_refine / cfg.bsz_objects) * cfg.n_refiner_iterations
            + math.ceil(n_refine / cfg.bsz_images))


def pipeline_line(seconds_per_image: float) -> dict:
    """The JAX bench's JSON line of the pipeline."""
    return {
        "metric": "pipeline_seconds_per_image",
        "value": round(seconds_per_image, 3),
        "unit": "s/image (detector + 4x576 coarse + top5 x 5-iter refine + re-score, 240x320)",
        "vs_baseline": round(BASELINE_S_PER_IMAGE / seconds_per_image, 2),
        "baseline_s_per_image": BASELINE_S_PER_IMAGE,
        "baseline_s_per_image_range": BASELINE_S_PER_IMAGE_RANGE,
        "baseline_assumed_keyframes": BASELINE_KEYFRAMES,
    }


@_tf32()
def pipeline_bench(n_images: int = 8, so3_grid: int = 0, device="cuda") -> Tuple[dict, dict]:
    """Detector -> megapose-RGB (576-grid coarse -> top-5 -> 5-iteration
    refine -> re-score -> top-1) s/image at the reference's load of 4
    detections, float32 (TF32 off), both through their graphs: one warm
    image (the captures), then the mean over `n_images`.
    `so3_grid` > 0 replaces the grid (and caps the coarse chunk at it), for
    runs at a small grid. Returns (the JSON line, notes: the wrapper's
    launches of the run (the frame graph's warm-up and capture), the
    launches of a frame, the last image's results)."""
    dev = torch.device(device)
    db = _mesh_db("debug")
    estimator = load_named_model("megapose-RGB", db, device=dev)
    if so3_grid:
        estimator.cfg = dataclasses.replace(
            estimator.cfg, SO3_grid_size=so3_grid,
            bsz_images=min(estimator.cfg.bsz_images, so3_grid))
        estimator.SO3_grid = torch.from_numpy(load_SO3_grid(so3_grid)).to(dev)

    rgb = torch.from_numpy(np.random.RandomState(0).rand(1, 3, *RES).astype(np.float32)).to(dev)
    obs = ObservationBatch(rgb=rgb, K=torch.tensor([K_BENCH], device=dev))
    detector = Detector(FCOSDetector(DetectorConfig(n_classes=len(db.labels)))
                        .init_weights(torch.Generator().manual_seed(0)).to(dev), image_size=RES)
    # fixed detections: a seeded detector on noise returns nothing stable;
    # the pipeline gets the reference's load of 4 instances regardless
    det = DetectionBatch.from_numpy(np.asarray(PIPELINE_BOXES, np.float32),
                                    np.asarray(PIPELINE_OBJ_IDS), device=dev)

    def one_image():
        detector.get_detections(obs, detection_th=0.3)
        out = estimator.run_inference_pipeline_jit(obs, det, n_refiner_iterations=5,
                                                   n_pose_hypotheses=5)
        _sync(dev)
        return out

    launches0 = rf.launches
    one_image()  # warm
    t0 = time.perf_counter()
    for _ in range(n_images):
        results = one_image()
    dt = (time.perf_counter() - t0) / n_images
    cfg = dataclasses.replace(estimator.cfg, n_refiner_iterations=5, n_pose_hypotheses=5)
    notes = {"compute_dtype": precision("float32"), "launches": rf.launches - launches0,
             "launches_per_frame": frame_launches(cfg, det.n_rows, estimator.SO3_grid.shape[0]),
             "frames": n_images + 1, "results": results}
    return pipeline_line(dt), notes


# ---------------------------------------------------------------- breakdown


@_tf32()
def breakdown(device="cuda") -> dict:
    """Per-stage ms of the refiner iteration at B = 16 on the debug set:
    the render, the crop (its matrix products in the compute dtype), the
    CNN alone on a 9-channel input, the full iteration; bfloat16 on the
    card. Each the mean of `N_SCAN` launches after a warm one."""
    dev = torch.device(device)
    db = _mesh_db("debug")
    assets = db.render_assets(device=dev)
    rs = np.random.RandomState(0)
    images = torch.from_numpy(rs.rand(B, 3, *RES).astype(np.float32)).to(dev)
    _, K, obj_ids, TCO0 = bench_inputs(B, dev)
    boxes = torch.tensor([80.0, 40.0, 240.0, 200.0], device=dev).expand(B, 4)
    dtype = _compute_dtype(dev)
    model = seeded_predictor(
        PosePredictorConfig(backbone="resnet34", render_size=RES, compute_dtype=dtype), dev)
    meshes = db.batched(n_points=512, device=dev).select(obj_ids)
    x3 = torch.from_numpy(rs.rand(B, 9, *RES).astype(np.float32)[:, :3]).to(dev)
    x9 = torch.cat([x3, x3.repeat(1, 2, 1, 1)], dim=1)

    with torch.inference_mode():
        t_render = _ms(lambda: rf.render_batch_fused(assets, obj_ids, TCO0, K, RES).rgb, dev, N_SCAN)
        t_crop = _ms(lambda: crop_images_matmul(
            images, boxes, output_size=RES, sampling_ratio=4,
            matmul_dtype=torch.bfloat16 if dtype == "bfloat16" else None), dev, N_SCAN)
        t_cnn = _ms(lambda: model.pose_fc(model._features(x9)), dev, N_SCAN)
        t_full = _ms(lambda: model(images, K, obj_ids, TCO0, assets, meshes,
                                   n_iterations=1).TCO_output, dev, N_SCAN)
    return {
        "render_ms": round(t_render, 3),
        "crop_ms": round(t_crop, 3),
        "cnn9ch_ms": round(t_cnn, 3),
        "full_iter_ms": round(t_full, 3),
        "batch": B,
    }


# ---------------------------------------------------------------- the CLI


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def _arg(argv: Sequence[str], flag: str, default):
    return type(default)(argv[argv.index(flag) + 1]) if flag in argv else default


def main(argv: Optional[Sequence[str]] = None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    # the card first: without one this raises PyTorch's own error
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(f"device {kind} count {count}; {card_line()}", flush=True)
    print(f"tf32 (every mode): torch.backends.cuda.matmul.allow_tf32={TF32} "
          f"torch.backends.cudnn.allow_tf32={TF32}", flush=True)
    if "--breakdown" in argv:
        launches0 = rf.launches
        line = breakdown()
        print(f"breakdown: compute_dtype {precision(_compute_dtype('cuda'))}, raster_fused launches "
              f"{rf.launches - launches0}", flush=True)
    elif "--pipeline" in argv:
        line, notes = pipeline_bench(so3_grid=_arg(argv, "--so3", 0))
        print(f"pipeline: compute_dtype {notes['compute_dtype']}, raster_fused launches {notes['launches']} "
              f"(expected 2 x {notes['launches_per_frame']}: the frame graph's warm-up and "
              f"capture; its {notes['frames']} replays launch on the device)",
              flush=True)
    else:
        line, notes = refiner_bench(_arg(argv, "--mesh", "debug"), _arg(argv, "--batch", B))
        print(f"refiner: compute_dtype {notes['compute_dtype']}, raster_fused launches "
              f"{notes['launches']} (the stage graph's warm-up and capture; its replays launch "
              f"on the device: raster_kernels of the profiled window; "
              f"{notes['launches_with_profile']} with the profiled window), "
              f"{notes['seconds']:.4f} s for {N_SCAN} iterations; "
              f"profiled window: {json.dumps(notes['profile'])}", flush=True)
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
