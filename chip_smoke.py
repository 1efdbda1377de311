#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is nonzero):

1. Device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions. Needs `torch.cuda.is_available()`.
2. Build: `happypose_tpu_torch/csrc/raster_fused.cu` with nvcc for sm_90a;
   what `-Xptxas -v` says of each kernel (registers, shared memory, spills);
   `csrc/fastply.cpp` (the host-side PLY decoder) with g++.
3. Kernels against their plain versions on the same CUDA tensors, with
   seeded poses, on the ~1.5k-face debug mesh (UV sphere 24x32 + box) and a
   ~16k-face sphere: at 240x320 at the refiner's batch (B = 16) and the
   coarse batch (B = 288), at 120x160 (the depth refiner's render, B = 2
   and 16, debug mesh) and at 480x640 (a VSD render at the frame's size,
   B = 8), and the two renders of training (the "textured" synthetic set:
   a batch of 16 scenes at 480x640 and the coarse grid loss's 8 x 8
   hypotheses at 240x320 in their crop cameras), and the recorder's two
   (phase 25): the per-tile face lists against
   `bin_faces_reference` (integers, exactly), the output against
   `raster_fused_reference` (of the 16k mesh at B = 288 the first 16
   images and at 480x640 the first: the plain version of the whole batch
   would take minutes), and
   the output with a pool too small for the lists against the normal one.
   For each shape: the kernel's time (CUDA events, median of 10 after
   warm-up), its bound computed from the tensors' sizes and the faces'
   screen boxes, and the share of the bound reached.
4. The slice at full width: `load_named_model("megapose-RGB")` (ResNet34,
   240x320 RGB + normals renders, 576-rotation grid, top-5, 5 refiner
   iterations) with seeded weights and a perturbed pose head, on a
   synthetic 480x640 frame with 2 detections. The launch counter of a
   second frame must show the coarse and scoring renders the config
   implies (the refiner's chunks replay the stage graphs that the first
   frame captured; `_eager_launches`); warm s/image is timed.
5. The same pipeline cut to 64x128 renders, a 72-rotation grid, top-2 and
   2 iterations, on the card and on the CPU (the plain path): logits and
   final poses must agree.
6. The detector at full width: `load_detector(DetectorConfig(n_classes=2))`
   (ResNet50-FPN, 256 channels, 16 prototypes, head depth 2, 5 levels),
   seeded, on the synthetic frame cropped and resized to 240x320 by
   `crop_resize_to_aspect`. Raw outputs against the same model on the
   CPU, `detector_postprocess` on the card against the CPU's on the same
   raw outputs; forward and post-processing timed warm.
7. `load_named_model("cosypose-RGB")` at full width (WideResNet34, 240x320
   RGB renders, 1 coarse + 4 refiner iterations) with seeded weights and
   perturbed pose heads, on the frame's 2 boxes: the launch counter of a
   second frame must show none (every render is a pose update's, whose
   stage graphs the first frame captured); warm s/image, the stage
   split, peak memory and the number of device kernels of one frame
   (`torch.profiler`) are reported.
8. Detector -> box mapping (as the evaluation runner maps them back to the
   frame) -> cosypose-RGB, on the card: every detection gets a finite pose.
   Seeded detector weights score ~0.01, under the default threshold of
   0.3, so this runs at threshold 0 with one instance per class.
9. cosypose-RGB cut to WideResNet18, 64x128 renders and 2 refiner
   iterations, on the card and on the CPU: final poses must agree.
10. RGB-D: the frame with its depth image (the z-merge of the two
   instances' depth renders). `megapose-RGB` at full width with
   `run_depth_refiner=True`, once with ICP and once with "teaserpp":
   `results["depth_refined"]` present, finite, one valid pose per
   detection, the coarse and scoring renders + 1 launches (the depth render
   at 120x160; the refiner's stage graphs replay); s/image beside
   the RGB-only figure and the depth refiner's own seconds.
11. The depth refiners do their job: `min`, `argmin` and `argmax` return
   the first extremum among equals on the card and the descending sort is
   stable (the refiners' tie rules); both refiners start from the
   ground-truth poses moved by a seeded offset (about 1 cm, 3 degrees) and
   must cut the translation error of every object; their seconds at 2 and
   at 10 rows (the pipeline's batch), and of a 10-row call under
   `torch.profiler` the share of `torch.linalg.svd` / `solve`, the device
   kernels and the operators with most host time.
12. BOP19 scoring on the card: `Bop19Evaluator` and `PoseErrorMeter` on the
   ground-truth poses (AR = 1, VSD error 0) and on the moved poses before
   and after ICP (MSSD falls); 2 launches per scored image; seconds per
   image and of `vsd_batch` alone; the same scene scored with VSD at
   120x160 on the card and on the CPU: recalls equal, errors within
   `VSD_ATOL`.
13. The RGB-D pipeline cut to 64x128 renders, a 72-rotation grid, top-2, 2
   iterations and ICP on a 48x64 frame (every depth pixel is sampled, so
   the card's and the CPU's random subsamples are the same set), on the
   card and on the CPU: depth-refined translations within `RGBD_ATOL`.

14. A textured model through the kernel: a UV sphere with texture
   coordinates and a seeded 256x256 procedural texture, written by
   `save_ply` (a `TextureFile` PLY and its PNG), read back by
   `BOPObjectDataset`. The kernel carries uv in the colour slots: lists and
   output against the plain versions at 240x320, B = 16 (expected equal),
   time beside the bound; then the resolved rgb of `render_batch_fused` on
   the card against its CPU run (`TEXTURE_ATOL`).
15. A BOP dataset written and read here, in a temporary directory:
   `write_bop_models` (the textured sphere, a box, a capsule decimated from
   ~25k to under 3000 faces; the kernel is held to its plain version at
   the decimated model's shape too) and `write_bop_scene` of 8 frames at
   480x640 with 2-3 instances each from one `render_scenes` call (one
   launch), with boxes and `visib_fract` from the merged masks. Read back:
   rgb equal, depth within 1 mm, poses within 1e-6 m, the PLYs' vertices
   equal, both PLY parsers (the native one built here with g++) agree; the
   reader's frames a second.
16. `scripts.run_eval` on that directory at full width (`--model
   megapose-RGB --detections gt --bop19`, on the card by default): the
   launch counter shows every frame's renders plus 2 a scored image; finite
   poses; the summary and the BOP csv are written and the csv returns the
   runner's poses to 1e-6; the per-frame seconds after the first lie within
   2x of phase 4's s/image (read after a synchronization, so not near 0).
   Then the ground-truth poses through the same runner and metrics: AR = 1.
17. The detector in front: `run_eval --model cosypose-RGB --detections
   detector` with all three models read from run directories of the port
   (`config.json` + `state_dict.pt`, seeded weights, threshold 0), and
   `run_detection_eval` on the same split (COCO json read back, `n_gt` =
   the instances written).
18. `run_eval` cut to 64x128 renders, a 72-rotation grid, top-2, 2
   iterations and 1 frame, `--device cuda` against `--device cpu`.
19. `run_inference_on_example --make-example` on the card: the three
   output files exist and the overlay PNG decodes.
20. Training at full width from seeded weights on the "textured" synthetic
   set (a UV-textured sphere and a box, 768 faces padded; f = 300 px):
   the refiner (ResNet34, 240x320 rgb + normals renders, 480x640 images,
   B = 16, 3 iterations, Adam lr 3e-4, 2 warmup steps) and the coarse grid
   loss (ResNet34 classifier, 8 hypotheses, B = 8), 6 steps each through
   the graphed step and the synthetic batch's graph: the wrapper's launches
   are the first step's warm-up and capture (2 x 3 and 2 x 1, + 2 for a new
   synthetic batch key) and none for a replay; one profiled step (batch and
   step, both replays) holds 1 + 3 and 2 rasterizing kernels in its device
   trace; finite losses, no skipped step, every parameter and BatchNorm
   statistic moved; s/step of steps 2-6 (the synthetic batch included, and
   alone), samples/s, peak memory.
21. The skip on the card: a NaN pixel in a refiner batch; the step (a
   replay: no wrapper launch, 3 rasterizing kernels in its trace) reports
   `skipped_nonfinite` 1 and the parameters, BatchNorm buffers, Adam's
   state and the schedule's count are bit-equal to before.
22. bfloat16: both losses at full width with `compute_dtype="bfloat16"`, 3
   steps each: finite losses, s/step beside fp32's.
23. Cut refiner training (WideResNet18, 60x80 renders, 120x160 images,
   B = 4, 2 iterations), the same weights, batch and draws on the card and
   on the CPU: loss, gradients and running statistics (`CUT_*`).
24. From training to serving: `run_pose_training` on the card writes a
   refiner and a coarse run directory (2 epochs of 32, batch 8, 240x320),
   `eval_refiner_checkpoint` measures the refiner, and `run_eval --model
   from-checkpoints` reads both runs on 2 frames of phase 15's split: every
   pose finite, launches as the configs imply (the training and refine
   graphs: each key's warm-up and capture).
25. The recorder (`datasets/scene_record.py`) at full width: the "textured"
   set of phase 20 under BOP labels plus the floor (512 faces), 2-4
   objects a scene, 480x640, 16 scenes a batch (M = 80 instances), shadows
   at 256, 2 batches: 2 launches a batch, scenes/s on the device, the
   accepted frames written as a BOP scene (frames/s written). Phase 3 holds
   the kernel at both of its shapes (the instances at 480x640, B = 80, and
   the shadow pass at 256x256, B = 80). Then one cut batch (2 scenes,
   120x160, shadows at 64) on the card and on the CPU with the same draws
   and noise (`REC_*` limits).
26. `record_synthetic_dataset --wds` on the card: 32 frames at 480x640,
   BOP layout, models and tar shards; `BOPSceneDataset` and
   `WebSceneDataset` read back the same frames (frames/s of each reader).
27. Pose training from that split at full width: the refiner (ResNet34,
   240x320 rgb + normals, 480x640 images, B = 16, 3 iterations), 6 steps
   through `PoseDataset` with `device_cache` and 6 through
   `StreamingPoseDataset` (one graph: its capture's launches, then
   replays, 3 rasterizing kernels in a replay's trace): finite losses,
   s/step of steps 2-6 beside phase 20's synthetic s/step, peak memory;
   `device_cache` batches equal the host path's bit for bit; then
   `eval_refiner_checkpoint --split-dir` on the run (3 launches a batch).
28. Detector training at full width (ResNet50-FPN, 256 channels, 16
   prototypes) on the split at 240x320, B = 8, 6 steps: finite losses,
   every parameter and BatchNorm statistic moved, s/step, peak memory, the
   mAP hook; then a cut step (FPN 32, 120x160, B = 2) on the card and on
   the CPU with the same weights, batch and jitter (`DET_CUT_*` limits).
29. The CLIs end to end: `run_pose_training --data --stream`,
   `run_detector_training` writes a run directory and `run_eval --model
   cosypose-RGB --detections detector` reads it on 2 frames of the split:
   every pose finite, launches as the config implies.
30. Multi-view reconstruction: `run_multiview_eval --synthesize --n-views
   4` (3 objects at 240x320; 4 x (1 + 3) launches) with the dense solver,
   then `--ba-solver schur` on the written scene (no launch), then
   `--device cpu`: component ids equal, summary within `MV_SUMMARY_RTOL`;
   warm s/scene split into matching and BA for each solver, and one scene
   under `torch.profiler` (device kernels, idle share). Every shape a
   multiview path launches at that phase 3 does not hold is held to the
   plain version here (phases 30-32).
31. Candidates from the single-view pipeline: `run_multiview_eval
   --checkpoints` on phase 24's run directories, and `_pipeline_candidates`
   with a seeded `cosypose-RGB` at full width on the 4 views: launches as
   the configs imply, finite poses; whether a scene is reconstructed from
   seeded weights is logged.
32. `run_multiview_eval --record-dr 2 --n-views 4`: 2 launches a recorder
   batch.
33. `run_custom_scenario` at its defaults (200 RANSAC iterations, 256
   points, 64 symmetry slots, 10 BA iterations) on a scenario from phase
   30's scene (the sphere declared symmetric) and on a T-LESS-sized one (8
   views x 15 objects, 5 of each model): seconds and peak memory.
34. Bundle adjustment of the 8 x 15 scene, dense and Schur, 50 iterations:
   s/solve, s/LM step, accepted steps, the solvers' losses (Schur below
   max(2 x dense, 1)); one LM step on the card against the CPU (poses
   within `BA_STEP_ATOL` at lambda `BA_STEP_LAMBDA`) and the Schur blocks
   (within `BA_BLOCKS_REL` of their largest entry).
35. Training at full width with the other backbones (phase 20's world with
   the backbone swapped): EfficientNet-B3 as refiner and as coarse grid
   classifier in float32, the refiner in bfloat16, the FlowNetS refiner;
   launches a step asserted, s/step, samples/s, peak memory, one profiled
   step (device busy share); the cut EfficientNet-B3 refiner on the card
   against the CPU (one iteration, `CUT_LIMITS`).
36. Serving them: `run_pose_training --backbone efficientnet_b3` (refiner,
   coarse) and `--backbone flownet` (refiner) at 240x320 / 480x640, 2
   steps each, then `run_accuracy_demo` at megapose-RGB's width on 1
   batch of 16 scenes: EfficientNet-B3 refiner + coarse (576-rotation
   grid, top-5, 5 iterations) and the FlowNetS refiner alone; launches as
   the configs imply, s a batch, the coarse / refiner / scoring split, peak
   memory. Every shape the demo launches at (the 768-face "textured" set
   at 240x320, B = 288, 80, 16) is held to the plain version with its own
   inputs.
37. Host tools: a DeepIM-ModelNet tree written with the port's PNG writer
   and read back through `make_scene_dataset`; `preprocess_object_dataset`
   on the training set's meshes; `download` from a local mirror; the
   device's memory through `utils/resources.py`.
38. The sharded paths on an NCCL process group of one rank (`make_mesh`),
   each beside its unsharded call (median of 3 after a warm-up): megapose-RGB
   with `PoseEstimator(device_mesh=...)` (coarse logits equal to the serial
   path's, the same top-5 sets, 4 launches at B = 288 in the coarse stage
   and the frame's count); `run_pose_training --dp` at phase 20's width (3
   steps, one an epoch) against the run without (the first step's losses
   and gradient norm; only rank 0 writes), then under `torchrun
   --standalone --nproc-per-node 1` (the `--dp` step captured with its
   NCCL collectives); `schur_sharded` bundle adjustment at
   8 views x 15 objects against `schur` (one step's poses at lambda 1e4, the
   solve's outcome); a render through the object-sharded `select` against
   the whole database's (bit-equal).
39. The port's measured entry points (`happypose_tpu_torch/bench.py`):
   refiner pose-iterations/s at B = 16 and 64 (bfloat16, one launch an
   iteration, through the stage graph `_refine_fn`: the warm-up's and the
   capture's launches counted by the wrapper, the replays' on the device),
   detector -> megapose-RGB s/image at D = 4 (8 images, 19 launches a
   frame, through `run_inference_pipeline_jit`: the wrapper counts its
   warm-up and capture, 2 x 19), the breakdown and `entry()`'s forward;
   their JSON lines; the kernel held to its plain version at the shapes
   they add (B = 4 textured, B = 4 and 20 of the pipeline, B = 64).
40. The JAX package's run directories (`checkpoint.msgpack`, written here
   by `utils/flax_msgpack.py` through the weight bridge, with the JAX
   trainers' `config.json` keys): `run_eval --model from-checkpoints
   --detections detector` serves megapose-RGB and the ResNet50-FPN detector
   from them on 4 frames of phase 15's split (launches as the config implies, poses
   equal bit for bit to the same models handed their state dicts); a
   refiner's TrainState after 2 steps of `run_pose_training`, written in
   JAX's layout, decoded (s, MB/s beside the card's name and power limit)
   loaded into the same state as the port's own checkpoint (bit for bit)
   and resumed for 2 steps beside that checkpoint's resume (the first
   step's loss equal, the second's within `RESUME_SECOND_RTOL`).
41. The compiled entry points as CUDA graphs (`utils/cuda_graphs.py`),
   each beside its eager path in one call (TF32 off): the bench's
   `--pipeline` frame (the detector's graph, then megapose-RGB's frame
   graph at D = 4), cosypose-RGB behind the graphed detector on the
   480x640 frame, megapose-RGB + ICP and + "teaserpp" (the depth refiner
   inside the frame's graph), D = 2, 4, 2 on one estimator (one pool; the
   first call's results untouched by the later replays), and the refiner
   bench's iteration through the stage graph at B = 16, and
   `forward_coarse_jit` at D = 2. Each graph is captured on one seeded
   frame and replayed on another (other image, depth and boxes): every
   result equal to eager on the same frame (`GRAPH_ATOL`); the wrapper's
   launches of the first call (the warm-up's and the capture's, 2 x
   `bench.frame_launches`); a replay's launches counted on the device (the
   `raster_kernel`s of its `torch.profiler` trace, as many as
   `bench.frame_launches`; "replay_launches_traced" in the kernels line);
   s/image (or s/iteration) of both in turns, the first call's seconds
   (warm-up, capture, first replay), the graph pool's bytes and the busy
   share. Every `PredictionRunner` path of the phases above (run_eval,
   the multiview candidates, the JAX run directories) serves one frame
   graph a detection count, so the wrapper counts the first frame of each
   count twice and the replays not at all (`_runner_launches`).
42. Graphed training (`training/trainer.py`: the train step as one CUDA
   graph replay) at phase 20's width, the ResNet34 refiner (B = 16, 3
   iterations) and the coarse grid (B = 8 x 8): from copies of one seeded
   state, the graphed step and the eager body twice, 5 steps each at a rate
   that changes every applied step (3 warm-up updates, a decay at the
   fourth), the third step skipped by phase 21's NaN pixel; with cuDNN
   deterministic, after every step the parameters, buffers, Adam's state
   and the counts of the graph equal the eager body's within the eager
   bodies' own gap (bit for bit where that is 0); one update a call (the
   first call's warm-up is its step; the capture runs nothing); a replay of
   the synthetic batch and the step traces 4 and 2 rasterizing kernels;
   s/step of graph and eager (deterministic, and in turns with cuDNN's
   default algorithms, the graph's other key), busy share of a replay,
   capture seconds and pool bytes beside the card's name and power limit.
   Phases 20-22, 24, 27-29, 35, 36, 38 and 40 train through the graphed
   step too: the wrapper counts each key's warm-up and capture
   (`_graph_launches`), device traces the replays.
43. Mask R-CNN's kernels (`ops/nms.py`, `ops/multiscale_roi_align.py`,
   `csrc/mask_rcnn_ops.cu`) on the detector's own frame:
   `load_detector(MaskRCNNConfig(...))` at every published setting on the
   480x640 synthetic frame of phase 4. The first frame's warm-up and
   capture count each wrapper's two calls twice, two replays none, and a
   replay's device trace holds each kernel twice. The warm-up's calls are
   held to `nms_reference` (index for index) and `roi_align_reference`
   (`ROI_ALIGN_RTOL` of the largest feature) on their own inputs. Each
   kernel's device time a frame is given beside its least time from
   `benchmark/maskrcnn_counts.py`, as rows "nms" and "roi_align" of the
   kernels line.

Everything written goes into a `tempfile.TemporaryDirectory()`. Prints the
nvidia-smi line (first, and again before the kernel results), a JSON line
of kernel results, and as its last line
`{"ok": true, "device": {...}}`. TF32 is off throughout.
"""

from __future__ import annotations

import dataclasses
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
RES = (240, 320)
BATCHES = (16, 288)  # refiner chunk (also compared with the plain version), coarse chunk
MATCH_FRACTION = 0.999  # pixels on which kernel and plain version must agree
IZ_RTOL = 1e-6  # where they agree: iz to 1e-6 relative,
ATTR_ATOL = 1e-5  # the six attr*iz values to 1e-5 (both are expected exact)
RAW_RTOL = 1e-3  # detector outputs, card against CPU, of the largest |value|: fp32, 50+ layers
VSD_ATOL = 1e-2  # VSD errors, card against CPU: a few edge pixels of a union of hundreds
RGBD_ATOL = 1e-3  # depth-refined translations, card against CPU [m]. ICP keeps the iterate
#   with the lowest residual and gates its pairs at max_corr_dist: both are steps, so a start
#   that differs in the last bits can end elsewhere. On the CPU a 1e-5 change of the start
#   moved the translation by up to 2.5e-5 m on this frame, and rotation entries by up to
#   1e-3 (depth does not observe a sphere's rotation at all), so rotations are only printed.
DEPTH_RES = (120, 160)  # the depth refiner's render of a 480x640 frame
FRAME_RES = (480, 640)
# (mesh, batch, resolution, focal length, images held to the plain version: all or the first n)
KERNEL_SHAPES = (
    ("debug_1.5k", 16, RES, 600.0, None),
    ("debug_1.5k", 288, RES, 600.0, None),
    ("sphere_16k", 16, RES, 600.0, None),
    ("sphere_16k", 288, RES, 600.0, 16),
    ("debug_1.5k", 2, DEPTH_RES, 150.0, None),
    ("debug_1.5k", 16, DEPTH_RES, 150.0, None),
    ("debug_1.5k", 8, FRAME_RES, 600.0, None),
    ("sphere_16k", 8, FRAME_RES, 600.0, 1),
)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_call_ms(fn) -> tuple:
    """(fn(), the device time of that one call in ms, CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def cuda_ms(fn, n_runs: int, n_warmup: int = 1) -> float:
    """Median over `n_runs` of the device time of `fn()` (CUDA events)."""
    for _ in range(n_warmup):
        fn()
    times = []
    for _ in range(n_runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


HBM_BYTES_PER_S = 3.35e12  # H100 SXM, data sheet
FP32_FLOP_PER_S = 67e12  # H100 SXM outside the tensor cores, data sheet
FLOP_PER_TEST = 30  # one pixel against one face: 4 affine rows, clamp, compares


def raster_bound(A, chunk_bbox, out) -> dict:
    """The least time the card could take for one `raster_fused` call: the
    larger of its bytes (each input read once, the output written once)
    over the memory rate and of the tests its inputs need over the float32
    rate. A face must be tested at the pixels that can accept it, those of
    its screen bbox (the constant rows of `A`) with the 1 px margin of the
    coverage test, inside the image: a count from the inputs alone, whatever
    tiles or lists a kernel works with."""
    from happypose_tpu_torch.ops import rasterizer_fused as rf

    n_bytes = sum(t.numel() * t.element_size() for t in (A, chunk_bbox, out))
    H, W = out.shape[2:]
    umin, vmin, umax, vmax = A[:, :, 2, rf.N_AFF + 2:].double().unbind(-1)
    n_u = (umax + 1).floor().clamp(max=W - 1) - (umin - 1).ceil().clamp(min=0) + 1
    n_v = (vmax + 1).floor().clamp(max=H - 1) - (vmin - 1).ceil().clamp(min=0) + 1
    n_tests = (n_u.clamp(min=0) * n_v.clamp(min=0)).sum().item()  # 0 for an invalid face
    flop = n_tests * FLOP_PER_TEST
    bytes_ms, ops_ms = n_bytes / HBM_BYTES_PER_S * 1e3, flop / FP32_FLOP_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms), "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


KERNEL_MESHES = ("debug_1.5k", "sphere_16k")  # also read by scripts/bench_raster.py


def shape_name(mesh: str, B: int, res) -> str:
    return f"{mesh}_B{B}" + ("" if res == RES else f"_{res[0]}x{res[1]}")


def kernel_inputs(mesh: str, B: int, dev, res=RES, f=600.0):
    """Packed faces (A, chunk_bbox) of B seeded poses of `mesh` at `res`
    under focal length `f`: at 240x320 the objects fill much of the image,
    as in a crop; at 480x640 (f = 600) and 120x160 (f = 150) they are as
    large as in a frame, and most tiles are background."""
    from happypose_tpu_torch.meshes import io
    from happypose_tpu_torch.meshes.database import MeshDataBase
    from happypose_tpu_torch.ops import rasterizer_fused as rf

    if mesh == "debug_1.5k":
        db = debug_mesh_db(MeshDataBase, io)
    else:
        db = MeshDataBase({"sphere": io.make_uv_sphere(radius=0.05, n_lat=90, n_lon=90)})
    K = torch.tensor([[f, 0, res[1] / 2], [0, f, res[0] / 2], [0, 0, 1]])
    ids = (torch.arange(B) % len(db.labels)).to(dev)
    inst = db.render_assets(device=dev).select(ids)
    fd, attrs = rf.face_inputs(inst, random_poses(B, seed=B).to(dev), K.expand(B, 3, 3).to(dev))
    return rf.pack_faces(fd.u, fd.v, fd.inv_z, fd.valid, attrs, res)


def debug_mesh_db(MeshDataBase, io):
    """The ~1.5k-face debug mesh set of `bench.py` (`_mesh_db("debug")`)."""
    return MeshDataBase({
        "sphere": io.make_uv_sphere(radius=0.05, n_lat=24, n_lon=32),
        "box": io.make_box_mesh((0.04, 0.03, 0.05)),
    })


def random_poses(B: int, seed: int, z=(0.3, 0.6)) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, 4, generator=g)
    x, y, zq, w = (q / q.norm(dim=1, keepdim=True)).unbind(1)
    R = torch.stack([
        1 - 2 * (y * y + zq * zq), 2 * (x * y - w * zq), 2 * (x * zq + w * y),
        2 * (x * y + w * zq), 1 - 2 * (x * x + zq * zq), 2 * (y * zq - w * x),
        2 * (x * zq - w * y), 2 * (y * zq + w * x), 1 - 2 * (x * x + y * y),
    ], dim=1).reshape(B, 3, 3)
    T = torch.eye(4).repeat(B, 1, 1)
    T[:, :3, :3] = R
    T[:, :2, 3] = (torch.rand(B, 2, generator=g) - 0.5) * 0.06
    T[:, 2, 3] = z[0] + torch.rand(B, generator=g) * (z[1] - z[0])
    return T


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA card: torch.cuda.is_available() is False")
    log(card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def phase_build() -> None:
    import happypose_tpu_torch
    from happypose_tpu_torch.csrc import build, build_log, library_path

    if Path(happypose_tpu_torch.__file__).resolve().parents[1] != ROOT:
        raise RuntimeError(f"happypose_tpu_torch not from this checkout: {happypose_tpu_torch.__file__}")
    t0 = time.perf_counter()
    cached = library_path("raster_fused").exists()
    path = build("raster_fused")
    log(f"build: {path.relative_to(ROOT)} in {time.perf_counter() - t0:.2f} s"
        f"{' (already built)' if cached else ''}")
    for line in build_log("raster_fused").splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            log("  " + line.replace("ptxas info    : ", "").strip())
    from happypose_tpu_torch.csrc import fastply

    t0 = time.perf_counter()
    path = fastply.build()
    assert path is not None, "no g++: csrc/fastply.cpp was not built"
    log(f"build: {path.relative_to(ROOT)} in {time.perf_counter() - t0:.2f} s")


# the kernels of csrc/raster_fused.cu, and the single kernel it had before
RASTER_KERNELS = ("bin_kernel", "order_kernel", "raster_kernel", "raster_fused_kernel")


def profile_device(fn):
    """One call of `fn` under `torch.profiler`: (the averaged events that ran
    on the card: kernels, copies and memsets, not the host's launch calls;
    those of them that are the rasterizer's kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    assert events, "torch.profiler recorded no device activity"
    return events, [e for e in events if any(k in e.key for k in RASTER_KERNELS)]


def _agreement(out, ref):
    """(share of pixels on which two kernel outputs agree, max abs diff)."""
    iz, iz_ref = out[:, 0], ref[:, 0]
    same = (
        ((iz > 0) == (iz_ref > 0))
        & ((iz - iz_ref).abs() <= IZ_RTOL * iz_ref.abs())
        & ((out[:, 1:] - ref[:, 1:]).abs().amax(1) <= ATTR_ATOL)
    )
    return same.float().mean().item(), (out - ref).abs().max().item()


def _check_shape(name: str, A, bbox, res, n_plain=None, min_hit=None) -> tuple:
    """One kernel shape: the face lists against `bin_faces_reference`, the
    output against `raster_fused_reference` (all images, or the first
    `n_plain`; the plain version's time is that of the compared call), a
    pool too small for the lists, then the time beside the bound. Returns
    (the shape's record, max abs err)."""
    from happypose_tpu_torch.ops import rasterizer_fused as rf

    out = rf.raster_fused(A, bbox, res)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()

    count, lists = rf.bin_faces(A, bbox, res)
    count_ref, lists_ref = rf.bin_faces_reference(A, bbox, res)
    assert torch.equal(count, count_ref) and torch.equal(lists, lists_ref), \
        f"{name}: the face lists differ from the plain version's"
    bound = raster_bound(A, bbox, out)
    line = (f"; lists = plain lists, mean {count.float().mean():.1f} max "
            f"{int(count.max())} faces a tile, {(count == 0).float().mean():.3f} of "
            f"{count.numel()} tiles empty")
    shape = dict(bound)

    # every tile unlisted, and a pool that holds some of the lists
    for cap in (0, int(count.sum()) // 2):
        frac, err = _agreement(rf.raster_fused(A, bbox, res, pool_capacity=cap), out)
        assert frac == 1.0 and err == 0.0, f"{name}: pool of {cap} changes the result"

    if n_plain is None:
        # one call: the plain version takes 0.01-4 s a shape, and the script
        # holds some 30 shapes
        ref, plain_ms = cuda_call_ms(lambda: rf.raster_fused_reference(A, bbox, res))
        shape["plain_ms"] = plain_ms
        hit = (ref[:, 0] > 0).float().mean().item()
        # a crop is filled by its object; in a frame the objects are small
        if min_hit is None:
            min_hit = 0.05 if res == RES else 0.005
        assert hit > min_hit, f"{name}: the scene covers only {hit:.3f} of the pixels"
        line += f"; plain {plain_ms:.3f} ms, covered {hit:.3f}"
    else:
        # the plain version of the whole batch would take minutes
        out = out[:n_plain]
        ref = rf.raster_fused_reference(
            A[:n_plain].contiguous(), bbox[:n_plain].contiguous(), res)
        line += f"; plain version on the first {n_plain} images"
    frac, err = _agreement(out, ref)
    line += f"; agree on {frac:.6f} of pixels, max abs err {err:.3g}"
    assert math.isfinite(err)
    assert frac >= MATCH_FRACTION, f"{name}: kernel agrees on {frac} of pixels"
    # timed last, when the comparisons have brought the card's clocks up
    ms = cuda_ms(lambda: rf.raster_fused(A, bbox, res), n_runs=10, n_warmup=2)
    shape.update(ms=ms, share_of_bound=bound["bound_ms"] / ms)
    log(f"kernel {name} {res[0]}x{res[1]} chunks={A.shape[1] // rf.CHUNK}: {ms:.3f} ms, "
        f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}: bytes "
        f"{bound['bytes_ms']:.4f}, operations {bound['ops_ms']:.4f}), share "
        f"{shape['share_of_bound']:.3f}" + line)
    return shape, err


def phase_kernel(dev) -> dict:
    result = {"max_abs_err": 0.0, "shapes": {}}
    for mesh, B, res, f, n_plain in KERNEL_SHAPES:
        name = shape_name(mesh, B, res)
        A, bbox = kernel_inputs(mesh, B, dev, res, f)
        result["shapes"][name], err = _check_shape(name, A, bbox, res, n_plain)
        result["max_abs_err"] = max(result["max_abs_err"], err)
    # the two renders of training (the synthetic batch, the coarse grid's
    # hypotheses) and the recorder's two (its instances, its shadow pass)
    for name, (A, bbox, res) in {**training_kernel_inputs(dev), **recorder_kernel_inputs(dev)}.items():
        result["shapes"][name], err = _check_shape(
            name, A, bbox, res, min_hit=0.001 if res == FRAME_RES else None)
        result["max_abs_err"] = max(result["max_abs_err"], err)
    main_shape = result["shapes"][shape_name("debug_1.5k", BATCHES[0], RES)]
    result.update({k: main_shape[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "share_of_bound")})
    return result


def _synthetic_rgbd_frame(db, dev, seed=0, res=FRAME_RES):
    """A frame of `res` (480x640 by default; the camera scales with it): the
    debug sphere and box rendered by the port at seeded poses over noise,
    with its depth image, the z-merge of the two instances' depth renders
    on the device (0 = no measurement); detections are the mask boxes.
    Returns (observation, detections, ground-truth poses, object ids)."""
    from happypose_tpu_torch.inference.types import DetectionBatch, ObservationBatch
    from happypose_tpu_torch.ops.rasterizer_fused import render_batch_fused
    from happypose_tpu_torch.ops.scene_renderer import render_scenes

    H, W = res
    f = 600.0 * W / 640
    K = torch.tensor([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], device=dev)
    TCO = random_poses(2, seed=seed, z=(0.5, 0.5)).to(dev)
    TCO[:, 0, 3] = torch.tensor([-0.08, 0.08])
    ids = torch.tensor([db.id_of("sphere"), db.id_of("box")], device=dev)
    assets = db.render_assets(device=dev)
    out = render_batch_fused(assets, ids, TCO, K.expand(2, 3, 3), resolution=(H, W))
    scene = render_scenes(
        assets, ids, torch.zeros(2, dtype=torch.int64, device=dev), TCO, K.expand(2, 3, 3),
        torch.ones(2, dtype=torch.bool, device=dev), n_scenes=1, resolution=(H, W))
    g = torch.Generator().manual_seed(seed)
    noise = (torch.rand(H, W, 3, generator=g) * 0.3).to(dev)
    rgb = torch.where(scene.mask[0, ..., None], scene.rgb[0], noise)
    depth = scene.depth[0]
    boxes = []
    for i in range(2):
        m = out.mask[i]
        ys, xs = torch.nonzero(m, as_tuple=True)
        pad = round(3 * W / 640)  # 3 px at 480x640
        boxes.append([xs.min().item() - pad, ys.min().item() - pad,
                      xs.max().item() + pad, ys.max().item() + pad])
    obs = ObservationBatch(rgb=rgb.permute(2, 0, 1)[None].contiguous(), K=K[None],
                           depth=depth[None, None].contiguous())
    det = DetectionBatch.from_numpy(np.asarray(boxes, np.float32), ids.cpu().numpy(), device=dev)
    return obs, det, TCO, ids


def _synthetic_frame(db, dev, seed=0):
    """The RGB part of `_synthetic_rgbd_frame` at 480x640, and its detections."""
    obs, det, _, _ = _synthetic_rgbd_frame(db, dev, seed)
    return dataclasses.replace(obs, depth=None), det


def _load(name, db, dev, seed=0, head_noise=3e-3):
    """Seeded estimator (`name`: a named model or a spec) whose pose heads
    are perturbed by N(0, head_noise) (a fresh head is an identity update)."""
    from happypose_tpu_torch.utils.load_model import load_named_model

    est = load_named_model(name, db, n_points=1000, seed=seed, device=dev)
    g = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for model in (est.refiner_model, est.coarse_model):
            if model is not None and model.cfg.predict_pose_update:
                w = model.pose_fc.weight
                w += (torch.randn(w.shape, generator=g) * head_noise).to(w.device)
    return est


def _timed(fn):
    """(fn(), seconds) on the host clock around a synchronized run."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _fmt(times) -> str:
    return f"{statistics.median(times):.4f} (runs {', '.join(f'{t:.4f}' for t in times)})"


def _frame_launches(cfg, D: int, grid_size=None) -> int:
    """Renders of one frame with D detections under the inference config
    `cfg`. MegaPose (`grid_size` rotations a detection): coarse chunks,
    refiner chunks x iterations, scoring chunks. CosyPose (no grid): one
    render a chunk and iteration of the coarse model and the refiner."""
    from happypose_tpu_torch.bench import frame_launches

    if grid_size is None:
        return math.ceil(D / cfg.bsz_objects) * (cfg.n_coarse_iterations + cfg.n_refiner_iterations)
    return frame_launches(cfg, D, grid_size)


def _runner_launches(per_frame) -> int:
    """The wrapper's launches over frames that `PredictionRunner` served,
    given as (D, launches of the frame): the runner serves one CUDA graph a
    detection count, whose first frame runs the frame twice through the
    wrapper (the capture's warm-up, then the capture); a replay runs no
    Python and adds nothing (phase 41 counts a replay's launches on the
    device)."""
    first = {}
    for D, n in per_frame:
        first.setdefault(D, n)
    return 2 * sum(first.values())


def _megapose_launches(est, D: int) -> int:
    return _frame_launches(est.cfg, D, est.SO3_grid.shape[0])


def _chunk_keys(rows: int, bsz: int) -> int:
    """Stage graph keys of `rows` pose updates in chunks of `bsz`: the full
    chunks' shape and a ragged last chunk's."""
    return int(rows >= bsz) + int(rows % bsz > 0)


def _stage_launches(cfg, updates) -> int:
    """The wrapper's launches of pose updates (`PoseEstimator._update_poses`),
    given as (rows, iterations) of each model, on their keys' first call:
    every chunk goes through the stage graph of its shape (`_refine_fn`),
    whose first call counts its warm-up and capture (`_graph_launches`);
    the other chunks, and every later call, replay and count none."""
    return sum(_graph_launches(it, _chunk_keys(rows, cfg.bsz_objects)) for rows, it in updates)


def _eager_launches(cfg, D: int, grid_size=None, first: bool = False) -> int:
    """The wrapper's launches of an eager frame (`run_inference_pipeline`)
    with D detections: MegaPose's coarse and scoring chunks, then the pose
    updates (`_stage_launches`): MegaPose's refiner on D x top-K rows,
    CosyPose's coarse model and refiner on D rows, counted when the frame
    is the `first` of its shapes."""
    if grid_size is None:
        eager, updates = 0, [(D, cfg.n_coarse_iterations), (D, cfg.n_refiner_iterations)]
    else:
        rows = D * cfg.n_pose_hypotheses
        updates = [(rows, cfg.n_refiner_iterations)]
        eager = (_frame_launches(cfg, D, grid_size)
                 - math.ceil(rows / cfg.bsz_objects) * cfg.n_refiner_iterations)
    return eager + (_stage_launches(cfg, updates) if first else 0)


def _small_megapose(**inference_kw):
    """The megapose-RGB spec cut to 64x128 renders, a 72-rotation grid,
    top-2 and 2 iterations."""
    from happypose_tpu_torch.utils import load_model as lm

    spec = lm.NAMED_MODELS["megapose-RGB"]
    return dataclasses.replace(
        spec,
        refiner_cfg=dataclasses.replace(spec.refiner_cfg, render_size=(64, 128)),
        coarse_cfg=dataclasses.replace(spec.coarse_cfg, render_size=(64, 128)),
        inference_cfg=dataclasses.replace(
            spec.inference_cfg, SO3_grid_size=72, n_pose_hypotheses=2, n_refiner_iterations=2,
            **inference_kw,
        ),
    )


def phase_pipeline(dev) -> tuple:
    from happypose_tpu_torch.meshes import io
    from happypose_tpu_torch.meshes.database import MeshDataBase
    from happypose_tpu_torch.ops import rasterizer_fused as rf

    db = debug_mesh_db(MeshDataBase, io)
    obs, det = _synthetic_frame(db, dev)
    t0 = time.perf_counter()
    est = _load("megapose-RGB", db, dev)
    cfg = est.cfg
    log(f"pipeline: megapose-RGB, grid {est.SO3_grid.shape[0]}, top-{cfg.n_pose_hypotheses}, "
        f"{cfg.n_refiner_iterations} iterations, render {est.refiner_model.cfg.render_size}, "
        f"D={det.n_rows}; load {time.perf_counter() - t0:.2f} s")

    D = det.n_rows
    n_refine = D * cfg.n_pose_hypotheses
    # the first run captured the refiner's stage graphs: this one replays them
    expected = _eager_launches(cfg, D, est.SO3_grid.shape[0])

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    est.run_inference_pipeline(obs, det)  # first run: cuDNN autotuning, allocator
    torch.cuda.synchronize()
    log(f"pipeline: first run {time.perf_counter() - t0:.3f} s")

    rf.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = est.run_inference_pipeline(obs, det)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches = rf.launches
    log(f"pipeline: raster_fused launches {launches}, expected {expected}")
    assert launches == expected, f"kernel launches {launches} != {expected}"

    final = res["final"]
    assert final.poses.shape == (n_refine, 4, 4)
    assert torch.isfinite(final.poses).all() and torch.isfinite(res["coarse"].coarse_logits).all()
    valid = final.valid
    assert int(valid.sum()) == D, f"{int(valid.sum())} final poses for {D} detections"
    assert sorted(final.obj_ids[valid].tolist()) == sorted(det.obj_ids.tolist())
    moved = (res[f"iteration={cfg.n_refiner_iterations}"].poses - res["iteration=1"].poses).abs().max()
    assert moved > 0, "the refiner did not move the poses"

    times = [t_run] + [_timed(lambda: est.run_inference_pipeline(obs, det))[1] for _ in range(2)]
    log(f"pipeline: warm s/image {_fmt(times)}; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches, statistics.median(times)


def _moved_poses(TCO, seed=3, t_sigma=0.006, rot_deg=3.0):
    """Poses moved by a seeded offset: about 1 cm (N(0, 6 mm) a coordinate)
    and `rot_deg` degrees about a random axis, applied in the camera frame
    about the object's centre."""
    from happypose_tpu_torch.lib3d.rotations import axis_angle_to_rotmat

    g = torch.Generator().manual_seed(seed)
    axis = torch.randn(len(TCO), 3, generator=g)
    aa = axis / axis.norm(dim=1, keepdim=True) * math.radians(rot_deg)
    out = TCO.clone()
    out[:, :3, :3] = axis_angle_to_rotmat(aa).to(TCO.device) @ TCO[:, :3, :3]
    out[:, :3, 3] += (torch.randn(len(TCO), 3, generator=g) * t_sigma).to(TCO.device)
    return out


def _estimates(est, obs, ids, poses):
    """A PoseEstimateBatch of one pose per object of image 0."""
    from happypose_tpu_torch.inference.types import PoseEstimateBatch

    n = len(ids)
    zi = torch.zeros(n, dtype=torch.long, device=ids.device)
    zf = torch.zeros(n, device=ids.device)
    return PoseEstimateBatch(
        poses=poses, K=obs.K[zi], obj_ids=ids, batch_im_ids=zi, instance_ids=zi,
        hypothesis_ids=zi, scores=zf + 1, coarse_logits=zf, pose_logits=zf,
        valid=torch.ones(n, dtype=torch.bool, device=ids.device),
    )


def phase_rgbd_pipeline(dev) -> dict:
    """megapose-RGB at full width with the depth refiner on (ICP, then
    "teaserpp"), on the RGB-D frame."""
    from happypose_tpu_torch.meshes import io
    from happypose_tpu_torch.meshes.database import MeshDataBase
    from happypose_tpu_torch.ops import rasterizer_fused as rf

    db = debug_mesh_db(MeshDataBase, io)
    obs, det, _, _ = _synthetic_rgbd_frame(db, dev)
    est = _load("megapose-RGB", db, dev)
    rgb_cfg = est.cfg
    D = det.n_rows
    n_refine = D * rgb_cfg.n_pose_hypotheses
    # the refiner's stage graphs replayed; the depth render of all D x top-K rows
    expected = _eager_launches(rgb_cfg, D, est.SO3_grid.shape[0]) + 1
    est.run_inference_pipeline(obs, det)  # warm-up: cuDNN autotuning, allocator
    t_rgb = [_timed(lambda: est.run_inference_pipeline(obs, det))[1] for _ in range(3)]
    launches = {}
    for name in ("icp", "teaserpp"):
        # the caller sets the estimator's config, as with the JAX package
        est.cfg = dataclasses.replace(rgb_cfg, run_depth_refiner=True, depth_refiner=name)
        est.run_inference_pipeline(obs, det)  # warm-up of the refiner's kernels
        rf.launches = 0
        res, t_run = _timed(lambda: est.run_inference_pipeline(obs, det))
        launches[f"megapose-RGB+{name}"] = rf.launches
        assert rf.launches == expected, f"{name}: kernel launches {rf.launches} != {expected}"
        t_run = [t_run] + [_timed(lambda: est.run_inference_pipeline(obs, det))[1] for _ in range(2)]
        refined, final = res["depth_refined"], res["final"]
        assert torch.equal(refined.poses, final.poses)
        assert final.poses.shape == (n_refine, 4, 4) and torch.isfinite(final.poses).all()
        assert int(final.valid.sum()) == D
        assert sorted(final.obj_ids[final.valid].tolist()) == sorted(det.obj_ids.tolist())
        before = est.filter_top_k(res["scored"], by="pose_logits", k=1)
        assert torch.equal(final.poses[~final.valid], before.poses[~final.valid]), \
            "the depth refiner moved a row that is not valid"
        t_ref = [_timed(lambda: est.run_depth_refiner(obs, before))[1] for _ in range(3)]
        assert {k[1] for k in est._depth_refiners} == {DEPTH_RES}  # cached by class and size
        moved = (final.poses[final.valid] - before.poses[final.valid])[:, :3, 3].norm(dim=1)
        log(f"rgbd pipeline: megapose-RGB + {name}: launches {launches[f'megapose-RGB+{name}']}, "
            f"expected {expected} "
            f"({expected - 1} + 1 depth render of {n_refine} rows at {DEPTH_RES}); s/image {_fmt(t_run)} beside "
            f"RGB-only {_fmt(t_rgb)} in this run; depth refiner alone {_fmt(t_ref)} s; valid poses "
            f"moved by {[round(x, 4) for x in moved.tolist()]} m")
    return launches


def _profile_summary(fn) -> str:
    """One call of `fn` under `torch.profiler`: the host and device time of
    `torch.linalg.svd` and `torch.linalg.solve` beside the call's own, the
    number of device kernels and their time, and the operators that take
    most of the host's time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = _timed(fn)
    averages = prof.key_averages()
    device = [e for e in averages if e.device_type == DeviceType.CUDA]
    parts = [f"profiled call {wall * 1e3:.1f} ms, {sum(e.count for e in device)} device kernels "
             f"and copies taking {sum(e.device_time_total for e in device) / 1e3:.2f} ms"]
    for op in ("linalg_svd", "linalg_solve"):
        ev = [e for e in averages if op in e.key]
        if ev:
            top = max(ev, key=lambda e: e.cpu_time_total)  # the outermost op holds the rest
            parts.append(f"{top.key} x{top.count}: host {top.cpu_time_total / 1e3:.2f} ms, "
                         f"device {top.device_time_total / 1e3:.2f} ms")
    host = sorted((e for e in averages if e.device_type != DeviceType.CUDA),
                  key=lambda e: e.self_cpu_time_total, reverse=True)[:5]
    parts.append("most host time (self): " + ", ".join(
        f"{e.key} x{e.count} {e.self_cpu_time_total / 1e3:.1f} ms" for e in host))
    return "; ".join(parts)


def phase_tie_order(dev) -> None:
    """The depth refiners lean on the first extremum among equals (the
    nearest-neighbour search, the farthest-point scan) and on a stable
    descending sort (the subsample), as the JAX versions do: on the card,
    tensors of a few distinct values (so nearly every extremum is tied) must
    give the lowest index, at the refiners' shapes."""
    g = torch.Generator().manual_seed(0)
    d2 = torch.randint(0, 4, (10, 512, 512), generator=g).float().to(dev)
    first = torch.where(d2 == d2.amin(-1, keepdim=True), torch.arange(512, device=dev), 512).amin(-1)
    assert torch.equal(d2.min(dim=-1).indices, first), "min(dim) is not the first minimum"
    assert torch.equal(d2.argmin(dim=-1), first), "argmin is not the first minimum"
    score = torch.randint(0, 3, (10, 120 * 160), generator=g).float().to(dev)
    score[:, ::7] = -torch.inf  # the farthest-point scan's penalty for invalid points
    first = torch.where(score == score.amax(-1, keepdim=True),
                        torch.arange(score.shape[1], device=dev), score.shape[1]).amin(-1)
    assert torch.equal(score.argmax(dim=-1), first), "argmax is not the first maximum"
    order = torch.sort(score, dim=-1, descending=True, stable=True).indices
    assert torch.equal(order.cpu(), torch.sort(score.cpu(), dim=-1, descending=True,
                                               stable=True).indices)
    same = score.gather(1, order[:, :-1]) == score.gather(1, order[:, 1:])
    assert bool((order[:, :-1] < order[:, 1:])[same].all()), "the sort is not stable"
    log("tie order on the card: min, argmin, argmax return the first extremum; the "
        "descending sort is stable")


def phase_depth_refiners(dev) -> dict:
    """Both depth refiners from the ground truth moved by a seeded offset:
    the translation error of every object must fall. Returns the poses for
    the scoring phase."""
    from happypose_tpu_torch.meshes import io
    from happypose_tpu_torch.meshes.database import MeshDataBase
    from happypose_tpu_torch.ops import rasterizer_fused as rf

    db = debug_mesh_db(MeshDataBase, io)
    obs, _, TCO_gt, ids = _synthetic_rgbd_frame(db, dev)
    est = _load("megapose-RGB", db, dev)
    start = _moved_poses(TCO_gt)
    err0 = (start - TCO_gt)[:, :3, 3].norm(dim=1)
    rot0 = torch.rad2deg(torch.acos(torch.clamp(
        ((start[:, :3, :3].transpose(1, 2) @ TCO_gt[:, :3, :3]).diagonal(dim1=1, dim2=2).sum(1) - 1)
        / 2, -1, 1)))
    log(f"depth refiners: start {[round(x, 4) for x in err0.tolist()]} m and "
        f"{[round(x, 2) for x in rot0.tolist()]} degrees from the ground truth")
    out = {"gt": TCO_gt, "moved": start, "ids": ids, "obs": obs, "db": db}
    for name in ("icp", "teaserpp"):
        est.cfg = dataclasses.replace(est.cfg, run_depth_refiner=True, depth_refiner=name)
        estimates = _estimates(est, obs, ids, start)
        est.run_depth_refiner(obs, estimates)  # warm-up
        rf.launches = 0
        refined, t = _timed(lambda: est.run_depth_refiner(obs, estimates))
        assert rf.launches == 1 and torch.isfinite(refined.poses).all()
        err1 = (refined.poses - TCO_gt)[:, :3, 3].norm(dim=1)
        log(f"depth refiners: {name}: translation error {[round(x, 5) for x in err1.tolist()]} m "
            f"after, {t:.4f} s for {len(ids)} poses at {DEPTH_RES}")
        assert bool((err1 < err0).all()), f"{name} did not cut the translation error: {err0} -> {err1}"
        out[name] = refined.poses
        # the pipeline's batch: D x top-5 = 10 rows, every one near an object
        rows = _estimates(est, obs, ids.repeat(5), start.repeat(5, 1, 1))
        t10 = [_timed(lambda: est.run_depth_refiner(obs, rows))[1] for _ in range(3)]
        log(f"depth refiners: {name}: 10 rows: {_fmt(t10)} s; "
            + _profile_summary(lambda: est.run_depth_refiner(obs, rows)))
    return out


def phase_bop19(dev, poses: dict) -> int:
    """BOP19 scoring and the pose-error meter on the card."""
    from happypose_tpu_torch.evaluation import bop19
    from happypose_tpu_torch.evaluation.meters import PoseErrorMeter
    from happypose_tpu_torch.ops import rasterizer_fused as rf

    db, obs = poses["db"], poses["obs"]
    ids = poses["ids"].cpu().numpy()
    K = obs.K[0].cpu().numpy()
    depth = obs.depth[0, 0].cpu().numpy()
    gt = poses["gt"].cpu().numpy()
    scores = np.ones(len(ids), np.float32)

    # the padded databases, built once per device (set-up, not scoring)
    dbs = {str(d): (db.batched(n_points=1000, device=d), db.render_assets(device=d))
           for d in (dev, "cpu")}

    def score(device, pred, res=None):
        meshes, assets = dbs[str(device)]
        ev = bop19.Bop19Evaluator(meshes=meshes, assets=assets, vsd_resolution=res)
        ev.add_image(pred, ids, scores, gt, ids, K, depth_test=depth, im_width=FRAME_RES[1])
        return ev.summary()

    def errors(device, pred, res=None):
        meshes, assets = dbs[str(device)]
        n = len(ids)
        inst = meshes.select(torch.as_tensor(ids, device=device))
        ms = bop19.mssd_mspd_batch(
            torch.as_tensor(pred, device=device), torch.as_tensor(gt, device=device),
            torch.as_tensor(K, device=device).expand(n, 3, 3), inst.points, inst.points_mask,
            inst.symmetries, inst.symmetries_mask)
        vsd = bop19.vsd_batch(pred, gt, ids, np.tile(K, (n, 1, 1)), np.tile(depth, (n, 1, 1)),
                              assets, meshes.diameters.cpu().numpy()[ids], resolution=res)
        return ms["mssd"].cpu().numpy(), ms["mspd"].cpu().numpy(), vsd

    # (a) the ground truth scores 1 with no error
    score(dev, gt)  # warm-up
    rf.launches = 0
    summary, t = _timed(lambda: score(dev, gt))
    launches = rf.launches
    assert launches == 2, f"{launches} launches for one scored image, expected 2"
    mssd, mspd, vsd = errors(dev, gt)
    t_image = [t] + [_timed(lambda: score(dev, gt))[1] for _ in range(4)]
    assets, diam = dbs[str(dev)][1], dbs[str(dev)][0].diameters.cpu().numpy()[ids]
    Kn, dn = np.tile(K, (len(ids), 1, 1)), np.tile(depth, (len(ids), 1, 1))
    t_vsd = [_timed(lambda: bop19.vsd_batch(gt, gt, ids, Kn, dn, assets, diam))[1]
             for _ in range(5)]
    log(f"bop19: ground-truth poses: {summary}; VSD error max {vsd.max():.3g}, MSSD max "
        f"{mssd.max():.3g}; {launches} launches for one image scored with VSD at {FRAME_RES} "
        f"({len(ids)} pairs): add_image + summary s {_fmt(t_image)}, of it vsd_batch s "
        f"{_fmt(t_vsd)}; " + _profile_summary(lambda: score(dev, gt)))
    assert summary == {"AR_VSD": 1.0, "AR_MSSD": 1.0, "AR_MSPD": 1.0, "bop19_AR": 1.0}
    assert vsd.max() == 0.0 and mssd.max() < 1e-6

    # (b) the moved poses before and after ICP
    meter = PoseErrorMeter(dbs[str(dev)][0])
    for g, key in enumerate(("gt", "moved", "icp", "teaserpp")):
        group = np.full(len(ids), g)
        meter.add(poses[key].cpu().numpy(), ids, scores, group, gt, ids, group)
    e = {k: np.concatenate(v).reshape(4, -1) for k, v in meter.errors.items()}
    log(f"bop19: PoseErrorMeter ADD [m] of gt / moved / icp / teaserpp: "
        f"{np.array2string(e['ADD'], precision=5)}; summary {meter.summary()}")
    assert meter.summary()["n_matched"] == 4 * len(ids) and e["ADD"][0].max() < 1e-6
    assert (e["ADD"][2] < e["ADD"][1]).all(), "ICP did not cut ADD"
    moved, refined = poses["moved"].cpu().numpy(), poses["icp"].cpu().numpy()
    m0, m1 = errors(dev, moved)[0], errors(dev, refined)[0]
    s0, s1 = score(dev, moved), score(dev, refined)
    log(f"bop19: MSSD [m] moved {np.round(m0, 5).tolist()} -> after ICP {np.round(m1, 5).tolist()}; "
        f"AR moved {s0} -> after ICP {s1}")
    assert (m1 < m0).all(), "ICP did not cut MSSD"
    assert s1["bop19_AR"] >= s0["bop19_AR"]

    # the same scene with VSD at a cut resolution, on the card and on the CPU
    for key, pred in (("moved", moved), ("icp", refined)):
        g, c = (score(d, pred, DEPTH_RES) for d in (dev, "cpu"))
        eg, ec = (errors(d, pred, DEPTH_RES) for d in (dev, "cpu"))
        diffs = [float(np.abs(a - b).max()) for a, b in zip(eg, ec)]
        # the recalls are decided where every error is further from each
        # threshold it is compared with than the two devices differ
        diam = db.batched(n_points=8, device="cpu").diameters.numpy()[ids]
        ths = np.asarray(bop19.CORRECTNESS_THS)
        gaps = [np.abs(ec[0][:, None] - ths * diam[:, None]).min(),
                np.abs(ec[1][:, None] - np.asarray(bop19.MSPD_THS) * FRAME_RES[1] / 640).min(),
                np.abs(ec[2][:, :, None] - ths).min()]
        decided = all(gap > diff for gap, diff in zip(gaps, diffs))
        log(f"bop19: {key} poses, VSD at {DEPTH_RES}, cuda vs cpu: recalls {g} / {c}; max diff "
            f"MSSD {diffs[0]:.3g} m, MSPD {diffs[1]:.3g} px, VSD {diffs[2]:.3g}; nearest "
            f"threshold {[float(f'{x:.3g}') for x in gaps]} away"
            f"{'' if decided else ' (closer than the difference: recalls may differ)'}")
        assert diffs[0] < 1e-6 and diffs[1] < 1e-3 and diffs[2] <= VSD_ATOL
        assert g == c or not decided, "recalls differ between the card and the CPU"
    return launches


def phase_rgbd_small_cross_check(dev) -> None:
    """The RGB-D pipeline cut to a small size with ICP, on the card and on
    the CPU. The frame is 48x64, so the depth refiner works at 48x64, and
    its cache is filled with a refiner that samples all 3072 pixels: the two
    devices' generators draw different numbers, and the subsample must be
    the same set. The pose head's perturbation is a twentieth of the other
    phases': the poses stay near the autodepth init, within reach of ICP's
    correspondence gate."""
    from happypose_tpu_torch.inference.icp_refiner import ICPRefiner
    from happypose_tpu_torch.meshes import io
    from happypose_tpu_torch.meshes.database import MeshDataBase
    from happypose_tpu_torch.ops.rasterizer_fused import render_batch_fused

    res = (48, 64)
    name = _small_megapose(run_depth_refiner=True, depth_refiner="icp")
    db = debug_mesh_db(MeshDataBase, io)
    runs = []
    for d in (dev, torch.device("cpu")):
        est = _load(name, db, d, head_noise=1.5e-4)
        est._depth_refiners[(ICPRefiner, res)] = ICPRefiner(
            est.assets, render_batch_fused, resolution=res, n_points=res[0] * res[1])
        obs, det, TCO_gt, _ = _synthetic_rgbd_frame(db, d, seed=5, res=res)
        runs.append((est.run_inference_pipeline(obs, det), TCO_gt.cpu()))
    (g, gt), (c, _) = runs
    assert "depth_refined" in g and "depth_refined" in c
    top = c["coarse"].coarse_logits.reshape(2, -1).sort(dim=1, descending=True).values
    n_compared = 0
    for i, oid in enumerate(c["coarse"].obj_ids.reshape(2, -1)[:, 0].tolist()):
        gap = (top[i, 1] - top[i, 2]).item()
        rows = [(r["final"].obj_ids.cpu() == oid) & r["final"].valid.cpu() for r in (g, c)]
        hyp = [r["final"].hypothesis_ids.cpu()[m] for r, m in zip((g, c), rows)]
        scored = (g["scored"].poses.cpu()[rows[0]] - c["scored"].poses[rows[1]]).abs().max().item()
        dp = (g["depth_refined"].poses.cpu()[rows[0]] - c["depth_refined"].poses[rows[1]]).abs()
        moved = (c["depth_refined"].poses[rows[1]] - c["scored"].poses[rows[1]])[:, :3, 3].norm(dim=1)
        err = (c["scored"].poses[rows[1]] - gt[i])[:, :3, 3].norm(dim=1)
        log(f"small rgbd cross-check cuda vs cpu: detection {i}: top-2 gap {gap:.3g}, final "
            f"hypotheses {hyp[0].tolist()} / {hyp[1].tolist()}, poses before the depth refiner "
            f"differ by {scored:.3g} and are {err.tolist()} m from the ground truth; ICP moved "
            f"them by {moved.tolist()} m; depth-refined poses differ by "
            f"{dp[:, :3, 3].max():.3g} m and {dp[:, :3, :3].max():.3g} in rotation entries")
        # the same hypothesis from the same start (the sphere's logits tie
        # across rotations, so its winner may differ between the devices)
        if torch.equal(hyp[0], hyp[1]) and scored < 1e-4:
            assert dp[:, :3, 3].max() < RGBD_ATOL
            n_compared += 1
    assert n_compared >= 1, "no detection started from the same pose on both devices"


def phase_small_cross_check(dev) -> None:
    """The pipeline cut to a small size, on the card (kernel, cuDNN) and on
    the CPU (plain path): coarse logits to 1e-3, the kept hypotheses and
    final poses to 1e-4 m / 1e-4 in rotation entries."""
    from happypose_tpu_torch.meshes import io
    from happypose_tpu_torch.meshes.database import MeshDataBase

    name = _small_megapose()
    db = debug_mesh_db(MeshDataBase, io)
    g, c = (
        _load(name, db, d).run_inference_pipeline(*_synthetic_frame(db, d, seed=1))
        for d in (dev, torch.device("cpu"))
    )
    dl = (g["coarse"].coarse_logits.cpu() - c["coarse"].coarse_logits).abs().max().item()
    log(f"small cross-check cuda vs cpu: coarse logits max diff {dl:.3g}")
    assert dl < 1e-3
    # per detection: where the top-2 set is decided (a gap at the 2nd logit;
    # the sphere's renders tie across rotations), the same final pose
    top = c["coarse"].coarse_logits.reshape(2, -1).sort(dim=1, descending=True).values
    for i, oid in enumerate(c["coarse"].obj_ids.reshape(2, -1)[:, 0].tolist()):
        gap = (top[i, 1] - top[i, 2]).item()
        rows = [(r["final"].obj_ids.cpu() == oid) & r["final"].valid.cpu() for r in (g, c)]
        hyp = [r["final"].hypothesis_ids.cpu()[m] for r, m in zip((g, c), rows)]
        dp = (g["final"].poses.cpu()[rows[0]] - c["final"].poses[rows[1]]).abs()
        log(f"  detection {i}: top-2 gap {gap:.3g}, final hypotheses {hyp[0].tolist()} / "
            f"{hyp[1].tolist()}, pose max diff t {dp[:, :3, 3].max():.3g} m, "
            f"R {dp[:, :3, :3].max():.3g}")
        if gap > 2e-3:
            assert torch.equal(hyp[0], hyp[1])
            assert dp[:, :3, 3].max() < 1e-4 and dp[:, :3, :3].max() < 1e-4


def _detector_input(obs, image_size):
    from happypose_tpu_torch.datasets.augmentations import crop_resize_to_aspect

    return crop_resize_to_aspect(obs.rgb, obs.K, image_size)


def _match_detections(a: dict, b: dict, img: int) -> int:
    """Valid detections of image `img` in post-processing outputs a and b
    pair up one to one by box (slot order may differ where scores tie to
    the last bit): same label, box within 1e-3 px, score within 1e-6
    relative, masks equal on >= 99.9% of pixels. Returns the count."""
    va, vb = a["valid"][img].nonzero()[:, 0].tolist(), b["valid"][img].nonzero()[:, 0].tolist()
    assert len(va) == len(vb), f"{len(va)} != {len(vb)} detections"
    for i in va:
        d = (b["boxes"][img, vb] - a["boxes"][img, i]).abs().amax(dim=1)
        j = vb[int(d.argmin())]
        assert d.min() < 1e-3 and a["labels"][img, i] == b["labels"][img, j]
        assert (a["scores"][img, i] - b["scores"][img, j]).abs() <= 1e-6 * b["scores"][img, j]
        assert (a["masks"][img, i] != b["masks"][img, j]).float().mean() <= 1e-3
    return len(va)


def phase_detector(dev) -> None:
    """Full-width detector on the card against the same model on the CPU."""
    from happypose_tpu_torch.meshes import io
    from happypose_tpu_torch.meshes.database import MeshDataBase
    from happypose_tpu_torch.models.detector import DetectorConfig, detector_postprocess
    from happypose_tpu_torch.utils.load_model import load_detector

    cfg = DetectorConfig(n_classes=2)
    gpu, cpu = (load_detector(cfg, seed=0, device=d) for d in (dev, "cpu"))
    obs, _ = _synthetic_frame(debug_mesh_db(MeshDataBase, io), dev)
    x, _ = _detector_input(obs, gpu.image_size)
    log(f"detector: {cfg}, input {tuple(x.shape)}")
    with torch.inference_mode():
        out = gpu.model(x)
        ref = cpu.model(x.cpu())
        for f in out._fields:
            o, r = getattr(out, f).cpu().double(), getattr(ref, f).double()
            assert o.shape == r.shape and torch.isfinite(o).all(), f
            err = ((o - r).abs().max() / r.abs().max().clamp(min=1e-30)).item()
            log(f"  {f} {tuple(o.shape)}: max abs diff / max |cpu| = {err:.3g}")
            assert err <= RAW_RTOL, f"{f}: {err}"
        post = detector_postprocess(out, score_threshold=0.0)
        post_cpu = detector_postprocess(type(out)(*(t.cpu() for t in out)), score_threshold=0.0)
        n = _match_detections({k: v.cpu() for k, v in post.items()}, post_cpu, 0)
        log(f"  postprocess on the card = on the CPU, same raw outputs: {n} detections")
        t_fwd = [_timed(lambda: gpu.model(x))[1] for _ in range(6)][1:]
        t_post = [_timed(lambda: detector_postprocess(out))[1] for _ in range(6)][1:]
    log(f"detector: warm forward s {_fmt(t_fwd)}; postprocess s {_fmt(t_post)}")


def phase_cosypose(dev) -> int:
    """cosypose-RGB at full width on the frame's 2 boxes."""
    from happypose_tpu_torch.meshes import io
    from happypose_tpu_torch.meshes.database import MeshDataBase
    from happypose_tpu_torch.ops import rasterizer_fused as rf

    db = debug_mesh_db(MeshDataBase, io)
    obs, det = _synthetic_frame(db, dev)
    est = _load("cosypose-RGB", db, dev)
    cfg = est.cfg
    D = det.n_rows
    expected = _eager_launches(cfg, D)  # every render is a pose update's, replayed
    log(f"cosypose: cosypose-RGB, {est.refiner_model.cfg.backbone}, render "
        f"{est.refiner_model.cfg.render_size}, {cfg.n_coarse_iterations} coarse + "
        f"{cfg.n_refiner_iterations} refiner iterations, D={D}")
    torch.cuda.reset_peak_memory_stats()
    _, t_first = _timed(lambda: est.run_inference_pipeline(obs, det))
    log(f"cosypose: first run {t_first:.3f} s")

    rf.launches = 0
    res, t_run = _timed(lambda: est.run_inference_pipeline(obs, det))
    launches = rf.launches
    log(f"cosypose: raster_fused launches {launches}, expected {expected}")
    assert launches == expected, f"kernel launches {launches} != {expected}"
    final = res["final"]
    assert final.poses.shape == (D, 4, 4) and torch.isfinite(final.poses).all()
    assert bool(final.valid.all()) and torch.equal(final.obj_ids, det.obj_ids)
    for prev, cur in (("init", "coarse"), ("coarse", "iteration=1"),
                      ("iteration=1", f"iteration={cfg.n_refiner_iterations}")):
        assert (res[cur].poses - res[prev].poses).abs().max() > 0, f"{prev} -> {cur} did not move"

    times = [t_run] + [_timed(lambda: est.run_inference_pipeline(obs, det))[1] for _ in range(2)]
    log(f"cosypose: warm s/image {_fmt(times)}; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    stages = {"init": [], "coarse": [], "refiner": []}
    for _ in range(3):
        init, t = _timed(lambda: est.make_TCO_init(obs, det))
        stages["init"].append(t)
        (coarse, _), t = _timed(lambda: est._forward_coarse_pose_model(obs, init))
        stages["coarse"].append(t)
        stages["refiner"].append(_timed(lambda: est.forward_refiner(obs, coarse))[1])
    log("cosypose: stage s " + "; ".join(f"{k} {_fmt(v)}" for k, v in stages.items()))

    # the path is bound by the host's kernel launches: count one frame's
    events, ours = profile_device(lambda: est.run_inference_pipeline(obs, det))
    log(f"cosypose: one frame under torch.profiler: {sum(e.count for e in events)} device "
        f"kernels and copies, {sum(e.count for e in ours)} of them the rasterizer's "
        f"({sum(e.device_time_total for e in ours) / 1e3:.3f} ms of "
        f"{sum(e.device_time_total for e in events) / 1e3:.3f} ms device time)")
    return launches


def phase_chained(dev) -> int:
    """Detector -> box mapping -> cosypose-RGB, all on the card."""
    from happypose_tpu_torch.evaluation.prediction_runner import boxes_to_frame
    from happypose_tpu_torch.inference.types import DetectionBatch, ObservationBatch
    from happypose_tpu_torch.meshes import io
    from happypose_tpu_torch.meshes.database import MeshDataBase
    from happypose_tpu_torch.models.detector import DetectorConfig
    from happypose_tpu_torch.ops import rasterizer_fused as rf
    from happypose_tpu_torch.utils.load_model import load_detector

    db = debug_mesh_db(MeshDataBase, io)
    obs, _ = _synthetic_frame(db, dev)
    detector = load_detector(DetectorConfig(n_classes=len(db.labels)), seed=0, device=dev)
    est = _load("cosypose-RGB", db, dev)

    def detect():
        x, K = _detector_input(obs, detector.image_size)
        det, _ = detector.get_detections(
            ObservationBatch(rgb=x, K=K), detection_th=0.0, one_instance_per_class=True,
        )
        return DetectionBatch.from_numpy(
            boxes=boxes_to_frame(det.boxes.cpu().numpy(), obs.K[0].cpu().numpy(),
                                 K[0].cpu().numpy()),
            obj_ids=det.obj_ids.cpu().numpy(), scores=det.scores.cpu().numpy(), device=dev,
        )

    detect()  # warm-up
    est.run_inference_pipeline(obs, detect())
    rf.launches = 0
    det, t_det = _timed(detect)
    res, t_pose = _timed(lambda: est.run_inference_pipeline(obs, det))
    launches = rf.launches
    final = res["final"]
    boxes = np.array2string(det.boxes.cpu().numpy(), precision=1, separator=", ")
    log(f"chained: {det.n_rows} detections, boxes {boxes}, "
        f"labels {det.obj_ids.tolist()}; detector {t_det:.4f} s, poses {t_pose:.4f} s; "
        f"raster_fused launches {launches}")
    assert det.n_rows >= 1 and torch.isfinite(det.boxes).all()
    assert final.poses.shape == (det.n_rows, 4, 4) and torch.isfinite(final.poses).all()
    assert bool(final.valid.all())
    expected = _eager_launches(est.cfg, det.n_rows)  # the warm-up captured its stage graphs
    assert launches == expected, f"kernel launches {launches} != {expected}"
    return launches


def phase_cosypose_small_cross_check(dev) -> None:
    """cosypose-RGB cut to WideResNet18, 64x128 and 2 refiner iterations, on
    the card and on the CPU: every stage's poses to 1e-4."""
    from happypose_tpu_torch.meshes import io
    from happypose_tpu_torch.meshes.database import MeshDataBase
    from happypose_tpu_torch.utils import load_model as lm

    spec = lm.NAMED_MODELS["cosypose-RGB"]
    small = {"backbone": "wide_resnet18", "render_size": (64, 128)}
    small_spec = dataclasses.replace(
        spec,
        refiner_cfg=dataclasses.replace(spec.refiner_cfg, **small),
        coarse_cfg=dataclasses.replace(spec.coarse_cfg, **small),
        inference_cfg=dataclasses.replace(spec.inference_cfg, n_refiner_iterations=2),
    )
    db = debug_mesh_db(MeshDataBase, io)
    g, c = (
        _load(small_spec, db, d).run_inference_pipeline(*_synthetic_frame(db, d, seed=1))
        for d in (dev, torch.device("cpu"))
    )
    assert sorted(g) == sorted(c)
    for k in g:
        dp = (g[k].poses.cpu() - c[k].poses).abs().max().item()
        log(f"small cosypose cross-check cuda vs cpu: {k} pose max diff {dp:.3g}")
        assert dp < 1e-4


TEXTURE_ATOL = 1e-4  # resolved rgb, card against CPU: the kernel's output is the plain version's
#   bit for bit; the division by iz, the bilinear texture lookup and the shading are float32
#   elementwise work that the two devices round differently in the last bits
N_EVAL_FRAMES = 8


def _bop_meshes():
    """The three models of the written dataset, in metres: a UV sphere with
    texture coordinates and a seeded 256x256 procedural texture, a box, and
    a capsule (a cylinder with round ends) coloured by position and cut by
    vertex clustering from ~25k faces to under 3000."""
    from happypose_tpu_torch.meshes import io

    sphere = io.make_uv_sphere(radius=0.05, n_lat=24, n_lon=32, with_uv=True)
    sphere.texture = io.make_procedural_texture(256, seed=0)
    dense = io.position_colored(io.make_capsule_mesh(radius=0.03, length=0.06, n_seg=128, n_cap=48))
    capsule = io.decimate_mesh(dense, 3000)
    assert 1000 < len(capsule.faces) <= 3000 < len(dense.faces), (len(capsule.faces), len(dense.faces))
    return {"obj_000001": sphere, "obj_000002": io.make_box_mesh((0.04, 0.03, 0.05)),
            "obj_000003": capsule}, len(dense.faces)


def _model_kernel_inputs(mesh_db, label: str, B: int, dev):
    """Packed faces of B seeded poses of one model of `mesh_db` at 240x320."""
    from happypose_tpu_torch.ops import rasterizer_fused as rf

    K = torch.tensor([[600.0, 0, RES[1] / 2], [0, 600.0, RES[0] / 2], [0, 0, 1]])
    ids = torch.full((B,), mesh_db.id_of(label), device=dev)
    inst = mesh_db.render_assets(device=dev).select(ids)
    fd, attrs = rf.face_inputs(inst, random_poses(B, seed=B).to(dev), K.expand(B, 3, 3).to(dev))
    return rf.pack_faces(fd.u, fd.v, fd.inv_z, fd.valid, attrs, RES)


def phase_textured(dev, root: Path, kernel: dict) -> None:
    """A textured model from a PLY file through the kernel: uv ride in the
    colour slots, the texture is resolved afterwards."""
    from happypose_tpu_torch.datasets.bop import BOPObjectDataset
    from happypose_tpu_torch.meshes import io
    from happypose_tpu_torch.ops.rasterizer_fused import render_batch_fused

    meshes, _ = _bop_meshes()
    sphere = meshes["obj_000001"]
    models = root / "textured_models"
    models.mkdir()
    io.save_ply(models / "obj_000001.ply", sphere.scaled(1000.0))
    assert (models / "obj_000001.png").exists()
    obj_ds = BOPObjectDataset(models)
    back = obj_ds.mesh_db.meshes["obj_000001"]
    assert back.texture is not None and back.texture.shape == (256, 256, 3)
    assert np.array_equal(back.vertex_uv, sphere.vertex_uv)
    assert np.abs(back.texture - sphere.texture).max() <= 1 / 255  # 8-bit PNG, truncated
    assert np.abs(back.vertices - sphere.vertices).max() < 1e-7

    B = BATCHES[0]
    A, bbox = _model_kernel_inputs(obj_ds.mesh_db, "obj_000001", B, dev)
    name = f"textured_sphere_B{B}"
    kernel["shapes"][name], err = _check_shape(name, A, bbox, RES)
    assert err == 0.0, f"{name}: kernel and plain version differ by {err}"
    kernel["max_abs_err"] = max(kernel["max_abs_err"], err)

    K = torch.tensor([[600.0, 0, RES[1] / 2], [0, 600.0, RES[0] / 2], [0, 0, 1]])
    TCO = random_poses(B, seed=B)
    outs = []
    for d in (dev, torch.device("cpu")):
        assets = obj_ds.mesh_db.render_assets(device=d)
        assert bool(assets.has_texture.all()) and assets.textures.shape[1] == 256
        outs.append(render_batch_fused(
            assets, torch.zeros(B, dtype=torch.int64, device=d), TCO.to(d),
            K.expand(B, 3, 3).to(d), resolution=RES))
    g, c = outs
    assert torch.equal(g.mask.cpu(), c.mask)
    diff = (g.rgb.cpu() - c.rgb).abs().amax(-1)
    close = (diff <= TEXTURE_ATOL).float().mean().item()
    spread = c.rgb[c.mask].std().item()
    log(f"textured: save_ply -> BOPObjectDataset -> render_batch_fused at {RES}, B={B}: resolved "
        f"rgb cuda vs cpu within {TEXTURE_ATOL} on {close:.6f} of pixels, max diff "
        f"{diff.max():.3g}; rgb std over the object {spread:.3f}")
    assert close >= MATCH_FRACTION and spread > 0.05, "the texture did not reach the render"


def phase_bop_dataset(dev, root: Path, kernel: dict) -> dict:
    """Write a BOP dataset (models and one scene of frames rendered on the
    card) and read it back."""
    from happypose_tpu_torch.datasets.bop import (
        BOPObjectDataset, BOPSceneDataset, SceneObservation, write_bop_models, write_bop_scene,
    )
    from happypose_tpu_torch.meshes import io
    from happypose_tpu_torch.meshes.database import MeshDataBase
    from happypose_tpu_torch.ops import rasterizer_fused as rf
    from happypose_tpu_torch.ops.rasterizer_fused import render_batch_fused
    from happypose_tpu_torch.ops.scene_renderer import render_scenes

    meshes, n_dense = _bop_meshes()
    models, split = root / "models", root / "test"
    t0 = time.perf_counter()
    write_bop_models(models, MeshDataBase(meshes))
    obj_ds = BOPObjectDataset(models)
    t_models = time.perf_counter() - t0
    db = obj_ds.mesh_db
    assert db.labels == sorted(meshes)
    for label, mesh in meshes.items():
        ply = models / f"{label}.ply"
        on_disk = io.load_ply(ply)
        assert np.array_equal(on_disk.vertices, (mesh.vertices * 1000.0).astype(np.float32)), label
        assert np.array_equal(on_disk.faces, mesh.faces), label
        assert np.abs(db.meshes[label].vertices - mesh.vertices).max() < 1e-7, label
        if mesh.vertex_uv is None:  # both parsers read the files without uv
            slow = io.load_ply(ply, native=False)
            assert np.array_equal(slow.vertices, on_disk.vertices), label
            assert np.array_equal(slow.faces, on_disk.faces), label
            assert np.array_equal(slow.vertex_colors, on_disk.vertex_colors), label
    from happypose_tpu_torch.csrc.fastply import get_fastply
    assert get_fastply() is not None, "fastply.cpp was not built"

    B = BATCHES[0]
    name = f"decimated_capsule_B{B}"
    A, bbox = _model_kernel_inputs(db, "obj_000003", B, dev)
    kernel["shapes"][name], err = _check_shape(name, A, bbox, RES)
    assert err == 0.0, f"{name}: kernel and plain version differ by {err}"

    # frames: 2 or 3 of the 3 models each, side by side, seeded poses
    H, W = FRAME_RES
    f = 600.0 * W / 640
    K = torch.tensor([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]])
    rs = np.random.RandomState(0)
    obj_ids, scene_ids, TCO = [], [], []
    for fi in range(N_EVAL_FRAMES):
        chosen = sorted(rs.permutation(3)[: 2 + fi % 2].tolist())
        T = random_poses(len(chosen), seed=100 + fi, z=(0.5, 0.65))
        T[:, 0, 3] = torch.tensor([(-0.13, 0.0, 0.13)[o] for o in chosen]) + T[:, 0, 3] * 0.3
        obj_ids += chosen
        scene_ids += [fi] * len(chosen)
        TCO.append(T)
    obj_ids = torch.tensor(obj_ids, device=dev)
    scene_ids = torch.tensor(scene_ids, device=dev)
    TCO = torch.cat(TCO).to(dev)
    N = len(obj_ids)
    assets = db.render_assets(device=dev)
    Kn = K.expand(N, 3, 3).to(dev)
    inst = render_batch_fused(assets, obj_ids, TCO, Kn, resolution=FRAME_RES)
    rf.launches = 0
    scenes, t_render = _timed(lambda: render_scenes(
        assets, obj_ids, scene_ids, TCO, Kn, torch.ones(N, dtype=torch.bool, device=dev),
        n_scenes=N_EVAL_FRAMES, resolution=FRAME_RES))
    assert rf.launches == 1, f"render_scenes made {rf.launches} launches"
    # an instance is visible where its own depth is the scene's
    visible = inst.mask & (inst.depth == scenes.depth[scene_ids])
    visib = visible.flatten(1).sum(1).float() / inst.mask.flatten(1).sum(1).clamp(min=1).float()
    g = torch.Generator().manual_seed(0)
    noise = (torch.rand(N_EVAL_FRAMES, H, W, 3, generator=g) * 0.3).to(dev)
    rgb8 = (torch.where(scenes.mask[..., None], scenes.rgb, noise) * 255).to(torch.uint8).cpu().numpy()
    depth = scenes.depth.cpu().numpy()
    frames = []
    for fi in range(N_EVAL_FRAMES):
        rows = (scene_ids == fi).nonzero()[:, 0].tolist()
        boxes = []
        for r in rows:
            ys, xs = torch.nonzero(visible[r], as_tuple=True)
            boxes.append([xs.min().item(), ys.min().item(), xs.max().item(), ys.max().item()])
        frames.append(SceneObservation(
            rgb=rgb8[fi], K=K.numpy(), depth=depth[fi],
            obj_labels=[db.labels[int(obj_ids[r])] for r in rows],
            TWO=TCO[rows].cpu().numpy(), bboxes=np.asarray(boxes, np.float32),
            visib_fract=visib[rows].cpu().numpy(), scene_id=1, view_id=fi,
        ))
    _, t_write = _timed(lambda: write_bop_scene(split, 1, frames))

    ds = BOPSceneDataset(split, load_depth=True)
    assert len(ds) == N_EVAL_FRAMES
    t0 = time.perf_counter()
    back = [ds[i] for i in range(len(ds))]
    t_read = time.perf_counter() - t0
    for f, b in zip(frames, back):
        assert np.array_equal(b.rgb, f.rgb) and b.obj_labels == f.obj_labels
        assert np.abs(b.depth - f.depth).max() <= 1e-3 + 1e-6  # uint16 mm, truncated
        assert np.abs(b.TWO - f.TWO).max() < 1e-6 and np.abs(b.bboxes - f.bboxes).max() < 1e-3
        assert np.abs(b.visib_fract - f.visib_fract).max() < 1e-6 and np.allclose(b.K, f.K)
    assert float(visib.min()) > 0.5, f"an instance is hidden: visib_fract {visib.tolist()}"
    # the files above carry no row filter; most encoders write Paeth and
    # Average rows, which the codec undoes one anti-diagonal at a time
    from happypose_tpu_torch.utils.png import decode_png, encode_png

    d16 = np.clip(frames[0].depth * 1000.0, 0, 65535).astype(np.uint16)
    filtered = [encode_png(frames[0].rgb, row_filter=4), encode_png(d16, row_filter=4)]
    t0 = time.perf_counter()
    decoded = [decode_png(b) for b in filtered]
    t_paeth = time.perf_counter() - t0
    assert np.array_equal(decoded[0], frames[0].rgb) and np.array_equal(decoded[1], d16)
    log(f"bop dataset: 3 models (textured sphere {len(meshes['obj_000001'].faces)} faces, box, "
        f"capsule {n_dense} -> {len(meshes['obj_000003'].faces)} faces) written and read in "
        f"{t_models:.3f} s, both PLY parsers agree; {N_EVAL_FRAMES} frames {FRAME_RES} with {N} "
        f"instances: render_scenes {t_render:.4f} s (1 launch), written in {t_write:.3f} s, "
        f"read back (rgb + depth PNG) in {t_read:.3f} s = {N_EVAL_FRAMES / t_read:.1f} frames/s "
        f"(one frame's two PNGs with Paeth rows decode in {t_paeth:.3f} s = "
        f"{1 / t_paeth:.1f} frames/s); "
        f"visib_fract {visib.min():.3f}-{visib.max():.3f}; rgb equal, depth within 1 mm, poses "
        f"within 1e-6 m")
    return {"models": models, "split": split, "n_instances": N,
            "n_per_frame": [len(f.obj_labels) for f in frames], "render_scenes": 1}


class _GroundTruthEstimator:
    """Stands in for a `PoseEstimator`: answers every frame with its
    ground-truth poses (the runner asks frame by frame, in order, through
    the graphed pipeline of an estimator without a device mesh)."""

    device_mesh = None
    _pipeline_jit_cache = ()  # no graphs: no frame key is ever added

    def __init__(self, scene_ds, mesh_db, dev):
        self.scene_ds, self.mesh_db, self.dev, self.next = scene_ds, mesh_db, dev, 0

    def run_inference_pipeline(self, obs_batch, det):
        from happypose_tpu_torch.inference.types import PoseEstimateBatch

        obs = self.scene_ds[self.next]
        self.next += 1
        ids = torch.as_tensor(self.mesh_db.ids_of(obs.obj_labels), device=self.dev)
        assert torch.equal(ids, det.obj_ids)
        n = len(ids)
        zeros = torch.zeros(n, dtype=torch.int64, device=self.dev)
        return {"final": PoseEstimateBatch(
            poses=torch.as_tensor(obs.TWO, device=self.dev), K=obs_batch.K.expand(n, 3, 3),
            obj_ids=ids, batch_im_ids=zeros, instance_ids=zeros, hypothesis_ids=zeros,
            scores=det.scores, coarse_logits=det.scores, pose_logits=det.scores,
            valid=torch.ones(n, dtype=torch.bool, device=self.dev),
        )}

    run_inference_pipeline_jit = run_inference_pipeline


def phase_run_eval(dev, root: Path, data: dict, s_per_image: float) -> int:
    """`scripts.run_eval` at full width on the written dataset."""
    from happypose_tpu_torch.datasets.bop import BOPObjectDataset, BOPSceneDataset
    from happypose_tpu_torch.evaluation.bop19 import Bop19Evaluator
    from happypose_tpu_torch.evaluation.bop_export import load_bop_csv
    from happypose_tpu_torch.evaluation.meters import PoseErrorMeter
    from happypose_tpu_torch.evaluation.prediction_runner import PredictionRunner, run_eval
    from happypose_tpu_torch.ops import rasterizer_fused as rf
    from happypose_tpu_torch.scripts import run_eval as run_eval_cli
    from happypose_tpu_torch.utils import load_model as lm

    registry = dict(lm.NAMED_MODELS)
    out_dir = root / "eval_megapose"
    rf.launches = 0
    res, t_all = _timed(lambda: run_eval_cli.run([
        "--split-dir", str(data["split"]), "--models-dir", str(data["models"]),
        "--model", "megapose-RGB", "--detections", "gt", "--bop19", "--out-dir", str(out_dir)]))
    launches = rf.launches
    assert lm.NAMED_MODELS == registry, "run_eval changed the registry of named models"
    preds, summary = res["predictions"], res["summary"]
    n_frames = len(preds)
    assert n_frames == N_EVAL_FRAMES
    cfg = registry["megapose-RGB"].inference_cfg
    per_frame = [_frame_launches(cfg, D, cfg.SO3_grid_size) for D in data["n_per_frame"]]
    expected = _runner_launches(zip(data["n_per_frame"], per_frame)) + 2 * n_frames
    log(f"run_eval megapose-RGB gt --bop19: {n_frames} frames, {data['n_instances']} instances; "
        f"raster_fused launches {launches}, expected {expected} "
        f"({per_frame} a frame, the first of each D twice: the capture's warm-up and the "
        f"capture; + 2 a scored image)")
    assert launches == expected, f"kernel launches {launches} != {expected}"
    for rec, D in zip(preds, data["n_per_frame"]):
        assert rec["poses"].shape == (D, 4, 4) and np.isfinite(rec["poses"]).all()
    on_disk = json.loads((out_dir / "summary_rank0.json").read_text())
    assert on_disk["n_gt"] == data["n_instances"] and "bop19_AR" in on_disk
    csv = load_bop_csv(out_dir / "preds_rank0.csv")
    poses = np.concatenate([r["poses"] for r in preds])
    assert csv["poses"].shape == poses.shape
    d_csv = np.abs(csv["poses"] - poses).max()
    assert d_csv < 1e-6, f"the csv's poses differ from the runner's by {d_csv}"
    times = summary["frame_seconds"]
    assert times == on_disk["frame_seconds"]
    # the first frame of each D includes its capture
    firsts = [data["n_per_frame"].index(D) for D in (2, 3)]
    warm = {D: [t for i, (t, d) in enumerate(zip(times, data["n_per_frame"]))
                if d == D and i not in firsts] for D in (2, 3)}
    log(f"run_eval: get_predictions {summary['eval_seconds_predictions']:.3f} s for {n_frames} "
        f"frames (first frames of D=2 and 3, captures included, "
        f"{[round(times[i], 3) for i in firsts]} s; warm s/frame D=2 {_fmt(warm[2])}, D=3 "
        f"{_fmt(warm[3])}; phase 4 read {s_per_image:.4f} s/image at D=2); metrics "
        f"{summary['eval_seconds_metrics']:.3f} s ({summary['eval_seconds_metrics'] / n_frames:.4f} "
        f"s a scored image); the whole call with loading {t_all:.2f} s; summary "
        f"{ {k: round(v, 4) for k, v in summary.items() if isinstance(v, float)} }; csv poses "
        f"within {d_csv:.2g}")
    # a time near 0 would mean the clock was read before the card finished
    for t in warm[2]:
        assert 0.5 * s_per_image < t < 2.0 * s_per_image, f"frame time {t} vs {s_per_image} s/image"
    for t in warm[3]:
        assert 0.5 * s_per_image < t < 3.0 * s_per_image, f"frame time {t} vs {s_per_image} s/image"

    # ground-truth poses through the same runner and metrics: AR = 1
    obj_ds = BOPObjectDataset(data["models"])
    scene_ds = BOPSceneDataset(data["split"], load_depth=True)
    runner = PredictionRunner(
        scene_ds=scene_ds, estimator=_GroundTruthEstimator(scene_ds, obj_ds.mesh_db, dev),
        mesh_db=obj_ds.mesh_db, detection_type="gt", device=str(dev))
    meshes = obj_ds.mesh_db.batched(n_points=512, device=dev)
    rf.launches = 0
    gt_summary = run_eval(
        runner, PoseErrorMeter(meshes=meshes, is_symmetric=obj_ds.is_symmetric),
        bop19_evaluator=Bop19Evaluator(meshes=meshes, assets=obj_ds.mesh_db.render_assets(device=dev)))
    assert rf.launches == 2 * n_frames
    log(f"run_eval on the ground-truth poses: {gt_summary}")
    assert gt_summary["bop19_AR"] == 1.0 and gt_summary["n_matched"] == data["n_instances"]
    return launches


def _seeded_state_dict(cfg, seed: int, head_noise=3e-3):
    """Seeded weights of a `PosePredictor` with a perturbed pose head."""
    from happypose_tpu_torch.models.pose_predictor import PosePredictor

    model = PosePredictor(cfg).init_weights(torch.Generator().manual_seed(seed))
    if cfg.predict_pose_update:
        g = torch.Generator().manual_seed(seed + 100)
        with torch.no_grad():
            model.pose_fc.weight += torch.randn(model.pose_fc.weight.shape, generator=g) * head_noise
    return model.state_dict()


def phase_detector_eval(dev, root: Path, data: dict) -> int:
    """`run_eval` with the detector in front of cosypose-RGB, both read from
    run directories, and `run_detection_eval` on the same split."""
    from happypose_tpu_torch.evaluation.coco_export import load_coco_json
    from happypose_tpu_torch.models.detector import DetectorConfig, FCOSDetector
    from happypose_tpu_torch.ops import rasterizer_fused as rf
    from happypose_tpu_torch.scripts import run_detection_eval, run_eval as run_eval_cli
    from happypose_tpu_torch.utils import load_model as lm

    spec = lm.NAMED_MODELS["cosypose-RGB"]
    ckpt = root / "cosypose_runs"
    for role, cfg, seed in (("refiner", spec.refiner_cfg, 0), ("coarse", spec.coarse_cfg, 1)):
        lm.save_run_dir(ckpt / role, _seeded_state_dict(cfg, seed),
                        {"backbone": cfg.backbone, "render_size": list(cfg.render_size)})
    det_cfg = DetectorConfig(n_classes=3)
    det_model = FCOSDetector(det_cfg).init_weights(torch.Generator().manual_seed(0))
    det_run = lm.save_run_dir(root / "detector_run", det_model.state_dict(),
                              {"fpn_channels": det_cfg.fpn_channels, "image_size": [240, 320]})

    out_dir = root / "eval_cosypose"
    rf.launches = 0
    res, t_all = _timed(lambda: run_eval_cli.run([
        "--split-dir", str(data["split"]), "--models-dir", str(data["models"]),
        "--model", "cosypose-RGB", "--checkpoints", str(ckpt), "--detections", "detector",
        "--detector-run", str(det_run), "--detection-th", "0.0", "--out-dir", str(out_dir)]))
    launches = rf.launches
    preds, summary = res["predictions"], res["summary"]
    n_det = [len(r["poses"]) for r in preds]
    expected = _runner_launches((D, _frame_launches(spec.inference_cfg, D)) for D in n_det)
    times = summary["frame_seconds"]
    log(f"run_eval cosypose-RGB, detector in front (threshold 0), run directories: "
        f"{len(preds)} frames, detections a frame {n_det}; raster_fused launches {launches}, "
        f"expected {expected}; first frame {times[0]:.3f} s, warm s/frame {_fmt(times[1:])}; "
        f"the whole call with loading {t_all:.2f} s; n_matched {summary['n_matched']} of "
        f"{summary['n_gt']}")
    assert len(preds) == N_EVAL_FRAMES and min(n_det) >= 1 and max(n_det) <= 8
    assert launches == expected, f"kernel launches {launches} != {expected}"
    assert all(np.isfinite(r["poses"]).all() for r in preds)
    assert (out_dir / "preds_rank0.csv").exists() and summary["n_gt"] == data["n_instances"]

    det_out = root / "eval_detector"
    _, t_det = _timed(lambda: run_detection_eval.main([
        "--split-dir", str(data["split"]), "--models-dir", str(data["models"]),
        "--detector-run", str(det_run), "--detection-th", "0.0", "--out-dir", str(det_out)]))
    det_summary = json.loads((det_out / "summary_rank0.json").read_text())
    coco = load_coco_json(det_out / "detections_rank0.json")
    log(f"run_detection_eval: {t_det:.2f} s, {len(coco)} detections in the COCO json, summary "
        f"{det_summary}")
    assert det_summary["n_gt"] == data["n_instances"] and len(coco) >= N_EVAL_FRAMES
    assert all(len(r["bbox"]) == 4 and r["category_id"] in (1, 2, 3) for r in coco)
    return launches


def phase_run_eval_cross_check(dev, root: Path, data: dict) -> None:
    """`run_eval` cut to 64x128 renders, a 72-rotation grid, top-2, 2
    iterations and 1 frame, on the card and on the CPU, from one pair of
    run directories: poses in the csv to 1e-4 m / 1e-4 in rotation entries
    for every row whose final score agrees to 1e-3 (the same hypothesis
    won on both devices)."""
    from happypose_tpu_torch.evaluation.bop_export import load_bop_csv
    from happypose_tpu_torch.scripts import run_eval as run_eval_cli
    from happypose_tpu_torch.utils import load_model as lm

    spec = lm.NAMED_MODELS["megapose-RGB"]
    ckpt = root / "small_runs"
    for role, cfg, seed in (("refiner", spec.refiner_cfg, 0), ("coarse", spec.coarse_cfg, 1)):
        lm.save_run_dir(ckpt / role,
                        _seeded_state_dict(dataclasses.replace(cfg, render_size=(64, 128)), seed),
                        {"backbone": cfg.backbone, "render_size": [64, 128]})
    csvs = []
    for d in (str(dev), "cpu"):
        out_dir = root / f"eval_small_{d.replace(':', '_')}"
        run_eval_cli.main([
            "--split-dir", str(data["split"]), "--models-dir", str(data["models"]),
            "--model", "from-checkpoints", "--checkpoints", str(ckpt), "--so3-grid", "72",
            "--n-pose-hypotheses", "2", "--n-refiner-iterations", "2", "--max-frames", "1",
            "--out-dir", str(out_dir), "--device", d])
        csvs.append(load_bop_csv(out_dir / "preds_rank0.csv"))
    g, c = csvs
    assert g["poses"].shape == c["poses"].shape and np.array_equal(g["obj_ids"], c["obj_ids"])
    same = np.abs(g["scores"] - c["scores"]) < 1e-3
    dt = np.abs(g["poses"] - c["poses"])[:, :3, 3].max(1)
    dR = np.abs(g["poses"] - c["poses"])[:, :3, :3].reshape(-1, 9).max(1)
    log(f"cut run_eval cuda vs cpu: {len(same)} rows, scores agree on {int(same.sum())}; pose "
        f"diff t {np.round(dt, 7).tolist()} m, R {np.round(dR, 7).tolist()}")
    assert same.sum() * 2 >= len(same), "most rows ended on different hypotheses"
    assert dt[same].max() < 1e-4 and dR[same].max() < 1e-4


def phase_example(dev, root: Path) -> int:
    """The quick start's first command, on the card."""
    from happypose_tpu_torch.ops import rasterizer_fused as rf
    from happypose_tpu_torch.scripts import run_inference_on_example
    from happypose_tpu_torch.utils.png import read_png

    example = root / "example"
    rf.launches = 0
    rc, t = _timed(lambda: run_inference_on_example.main(
        ["--example-dir", str(example), "--make-example"]))
    launches = rf.launches
    out = example / "outputs"
    records = json.loads((out / "object_data.json").read_text())
    overlay = read_png(out / "all_results.png")
    log(f"run_inference_on_example --make-example: {t:.2f} s, {launches} launches, "
        f"{len(records)} pose(s), overlay {overlay.shape} {overlay.dtype}, scene.glb "
        f"{(out / 'scene.glb').stat().st_size} bytes")
    assert rc == 0 and len(records) == 1 and np.isfinite(np.asarray(records[0]["TWO"])).all()
    assert overlay.shape == (240, 320, 3) and overlay.dtype == np.uint8
    assert (out / "scene.glb").read_bytes()[:4] == b"glTF"
    # the example's render, a megapose frame at grid 72 with D = 1, the overlay's render
    from happypose_tpu_torch.utils.load_model import NAMED_MODELS

    cfg = NAMED_MODELS["megapose-RGB"].inference_cfg
    expected = 1 + _eager_launches(dataclasses.replace(cfg, bsz_images=72), 1, 72, first=True) + 1
    assert launches == expected, f"kernel launches {launches} != {expected}"
    return launches


# ----------------------------------------------------------------- training

TRAIN_STEPS = 6  # steps 2-6 are timed
TRAIN_BATCH = {"refiner": 16, "coarse": 8}
REFINER_ITERATIONS = 3
GRID_HYPOTHESES = 8
# Cut training, card against CPU: the loss to CUT_LOSS_RTOL; the pose head's
# gradient (after every ReLU of the backbone) to CUT_HEAD_REL of its largest
# entry; the whole gradient to CUT_GLOBAL_L2 and each tensor to CUT_TENSOR_L2
# in relative L2 norm. A ReLU input within float32 rounding of 0 passes its
# gradient on one device and not on the other; on the CPU, images moved by
# 1e-6 (relative) moved the loss by <= 4e-6, the head by <= 5e-5, the whole
# gradient by <= 5e-3 and single tensors by up to 3% (13% of their largest
# entry), in every one of 6 seeded batches. The running statistics after the
# forward to CUT_STATS_RTOL of each buffer's largest entry: iteration 2's
# poses differ in the last bits, which can move an edge pixel of its render.
CUT_LOSS_RTOL = 1e-5
CUT_HEAD_REL = 1e-3
CUT_GLOBAL_L2 = 2e-2
CUT_TENSOR_L2 = 0.1
CUT_STATS_RTOL = 1e-3
# `run_pose_training` from training to serving: epochs, epoch size, batch
CLI_EPOCHS, CLI_EPOCH_SIZE, CLI_BATCH = 2, 32, 8


def _train_world(dev, role, backbone="resnet34", render=None, image=None, B=16,
                 n_iterations=REFINER_ITERATIONS, compute_dtype="float32", seed=0):
    """A pose model from seeded weights on the "textured" synthetic set
    (a UV-textured sphere and a box, 768 faces padded) with the intrinsics
    of `run_pose_training` (f = 300 px at `image`): its loss (the refiner's
    over `n_iterations`, or the coarse grid loss with GRID_HYPOTHESES), a
    train state (Adam, lr 3e-4, 2 warmup steps) and seeded batches and draws."""
    from types import SimpleNamespace

    from happypose_tpu_torch.models.pose_predictor import PosePredictor, PosePredictorConfig
    from happypose_tpu_torch.training import TrainState, make_optimizer, make_train_step
    from happypose_tpu_torch.training.forward_loss import (
        make_coarse_grid_loss_fn, make_refiner_loss_fn,
    )
    from happypose_tpu_torch.training.synth_data import (
        make_synth_batch, make_synth_mesh_db, sample_synth_scenes,
    )
    from happypose_tpu_torch.utils.random import generator_for

    render, image = render or RES, image or FRAME_RES
    db = make_synth_mesh_db("textured")
    assets, meshes = db.render_assets(device=dev), db.batched(n_points=256, device=dev)
    H, W = image
    K1 = torch.tensor([[300.0, 0, W / 2], [0, 300.0, H / 2], [0, 0, 1.0]], device=dev)
    cfg = PosePredictorConfig(backbone=backbone, render_size=render, compute_dtype=compute_dtype,
                              predict_pose_update=role == "refiner",
                              predict_rendered_views_logits=role == "coarse")
    model = PosePredictor(cfg).init_weights(torch.Generator().manual_seed(seed)).to(dev)
    loss_fn = (
        make_refiner_loss_fn(model, assets, meshes, n_iterations=n_iterations)
        if role == "refiner"
        else make_coarse_grid_loss_fn(model, assets, meshes, n_hypotheses=GRID_HYPOTHESES)
    )

    def batch(i):
        return make_synth_batch(assets, K1, sample_synth_scenes(
            generator_for("synth", seed, i, device=dev), len(db.labels), B, image))

    def draws(b, i):
        return loss_fn.sample(generator_for("step", seed, i, device=dev), b)

    return SimpleNamespace(
        db=db, assets=assets, meshes=meshes, K1=K1, model=model, loss_fn=loss_fn, B=B,
        state=TrainState(model, make_optimizer(model.parameters(), lr=3e-4, n_warmup_steps=2)),
        step=make_train_step(loss_fn), batch=batch, draws=draws)


def training_kernel_inputs(dev) -> dict:
    """Packed faces of the two renders training makes, from the training
    path's own tensors: the synthetic batch (16 scenes at 480x640, f = 300
    px, "textured" set) and the coarse grid loss's hypotheses (8 x 8 at
    240x320 in their crop cameras). {name: (A, chunk_bbox, resolution)}."""
    from happypose_tpu_torch.lib3d.so3_grid import load_SO3_grid
    from happypose_tpu_torch.lib3d.transforms import make_T, normalize_T
    from happypose_tpu_torch.ops import rasterizer_fused as rf
    from happypose_tpu_torch.training.forward_loss import sample_grid_hypotheses
    from happypose_tpu_torch.training.synth_data import sample_synth_scenes
    from happypose_tpu_torch.utils.random import generator_for

    w = _train_world(dev, "coarse", B=TRAIN_BATCH["coarse"])
    B = TRAIN_BATCH["refiner"]
    d = sample_synth_scenes(generator_for("synth", 0, 0, device=dev), len(w.db.labels), B, FRAME_RES)
    TCO = make_T(d["R"], torch.cat([d["xy"], d["z"]], dim=-1))
    fd, attrs = rf.face_inputs(w.assets.select(d["obj_ids"]), TCO, w.K1.expand(B, 3, 3))
    shapes = {f"synth_textured_B{B}_480x640": (
        *rf.pack_faces(fd.u, fd.v, fd.inv_z, fd.valid, attrs, FRAME_RES), FRAME_RES)}

    b = w.batch(0)
    inst0 = w.meshes.select(b.obj_ids)
    grid_R = torch.from_numpy(load_SO3_grid(576)).to(dev)
    hyp, _, _ = sample_grid_hypotheses(b.TCO_gt, inst0.symmetries, inst0.symmetries_mask, grid_R,
                                       w.draws(b, 0))
    n = GRID_HYPOTHESES
    T = normalize_T(hyp.reshape(-1, 4, 4))
    ids = b.obj_ids.repeat_interleave(n)
    inst = w.meshes.select(ids)
    K_crop = w.model._crop_inputs(
        b.images.repeat_interleave(n, 0), b.K.repeat_interleave(n, 0), T, T[:, :3, 3],
        inst.points, inst.points_mask)[1]
    fd, attrs = rf.face_inputs(w.assets.select(ids), T, K_crop)
    shapes[f"coarse_grid_B{len(T)}"] = (
        *rf.pack_faces(fd.u, fd.v, fd.inv_z, fd.valid, attrs, RES), RES)
    return shapes


def _parameters_and_buffers(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _train_steps(w, n_steps, first=0):
    """`n_steps` steps of `w`; returns (metrics, seconds a step with its
    batch, seconds of the batch alone, launches a step)."""
    from happypose_tpu_torch.ops import rasterizer_fused as rf

    metrics, times, data_times, launches = [], [], [], []
    for i in range(first, first + n_steps):
        rf.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b = w.batch(i)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        metrics.append(w.step(w.state, b, w.draws(b, i)))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        data_times.append(t1 - t0)
        launches.append(rf.launches)
    return metrics, times, data_times, launches


def _profile(fn) -> tuple:
    """One call of `fn` under `torch.profiler`: (a line with its wall time,
    the device kernels and copies and their time (the device's busy share)
    and the kernels that take most of it; the rasterizing kernels among
    them, counted on the device, so a CUDA graph's replay counts too)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from happypose_tpu_torch.ops import rasterizer_fused as rf

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = _timed(fn)
    device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.device_time_total for e in device) / 1e3
    top = sorted(device, key=lambda e: e.device_time_total, reverse=True)[:6]
    raster = sum(e.count for e in device if rf.KERNEL_NAME in e.key)
    return (f"{wall * 1e3:.1f} ms, {sum(e.count for e in device)} device kernels and copies "
            f"taking {busy:.1f} ms (busy {busy / (wall * 1e3):.2f}), {raster} rasterizing; "
            "most device time: "
            + ", ".join(f"{e.key[:60]} x{e.count} {e.device_time_total / 1e3:.1f} ms"
                        for e in top)), raster


def _step_profile(w, i, per_step: int) -> str:
    """One train step of `w` with its synthetic batch under
    `torch.profiler` (`_profile`): a replay of each graph, whose
    `per_step` rasterizing kernels the trace counts."""
    def step():
        b = w.batch(i)
        w.step(w.state, b, w.draws(b, i))

    line, raster = _profile(step)
    assert raster == per_step, f"{raster} rasterizing kernels in a step's trace, expected {per_step}"
    return "profiled step (synthetic batch and step, both replays) " + line


def _synth_keys() -> int:
    """Keys of the synthetic batch's graphs so far (one a shape)."""
    from happypose_tpu_torch.training.synth_data import synth_batch_graphs

    return len(synth_batch_graphs)


def _graph_launches(per_call: int, new_keys: int) -> int:
    """The wrapper's launches of a graphed function that launches the kernel
    `per_call` times: each new key's warm-up and capture; a replay runs no
    Python and adds none (its launches are counted in device traces)."""
    return 2 * per_call * new_keys


def _step_launches(per_step: int, n_steps: int, new_synth: int) -> list:
    """The wrapper's launches of each of `n_steps` steps of a fresh train
    step that renders `per_step - 1` times, each with its synthetic batch
    (one launch): the first captures the step and the batch's `new_synth`
    new keys; the others replay."""
    first = _graph_launches(per_step - 1, 1) + _graph_launches(1, new_synth)
    return [first] + [0] * (n_steps - 1)


def phase_training(dev) -> tuple:
    """Refiner (ResNet34, 240x320 rgb + normals renders, 480x640 images,
    B = 16, 3 iterations) and coarse grid training (ResNet34 classifier, 8
    hypotheses, B = 8) at full width: TRAIN_STEPS steps each from seeded
    weights, steps 2-6 timed. Returns ({role: figures}, {path: launches},
    the refiner's world)."""
    figures, launches, refiner = {}, {}, None
    for role, per_step in (("refiner", 1 + REFINER_ITERATIONS), ("coarse", 2)):
        w = _train_world(dev, role, B=TRAIN_BATCH[role])
        before = _parameters_and_buffers(w.model)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k0 = _synth_keys()
        metrics, times, data_times, n_launch = _train_steps(w, TRAIN_STEPS)
        expected = _step_launches(per_step, TRAIN_STEPS, _synth_keys() - k0)
        peak = torch.cuda.max_memory_allocated() / 2**30
        after = _parameters_and_buffers(w.model)
        unmoved = [k for k in before if not k.endswith("num_batches_tracked")
                   and torch.equal(before[k], after[k])]
        s_step = statistics.median(times[1:])
        figures[role] = {"s_per_step": s_step, "samples_per_s": w.B / s_step, "peak_gib": peak,
                         "s_batch": statistics.median(data_times[1:])}
        extra = (f", coarse_acc {[round(m['coarse_acc'], 3) for m in metrics]}"
                 if role == "coarse" else "")
        log(f"train {role} full width (ResNet34, render {RES}, images {FRAME_RES}, B={w.B}"
            f"{', 3 iterations' if role == 'refiner' else f', {GRID_HYPOTHESES} hypotheses'}): "
            f"wrapper launches a step {n_launch}, expected {expected} (the first step's "
            f"warm-up and capture; {per_step} a replayed step in its device trace); loss "
            f"{[round(m['loss'], 5) for m in metrics]}, grad_norm "
            f"{[round(m['grad_norm'], 3) for m in metrics]}{extra}; s/step (steps 2-{TRAIN_STEPS}, "
            f"batch included) {_fmt(times[1:])}, of it the synthetic batch "
            f"{figures[role]['s_batch']:.4f}; {figures[role]['samples_per_s']:.1f} samples/s; "
            f"peak memory {peak:.2f} GiB; first step {times[0]:.3f} s")
        assert n_launch == expected, f"{role}: launches {n_launch}"
        assert all(math.isfinite(m["loss"]) and m["loss"] > 0 for m in metrics)
        assert all(m["skipped_nonfinite"] == 0 for m in metrics)
        assert not unmoved, f"{role}: parameters or BatchNorm statistics did not move: {unmoved[:5]}"
        launches[f"train {role} ({TRAIN_STEPS} steps)"] = sum(n_launch)
        log(f"train {role}: " + _step_profile(w, TRAIN_STEPS, per_step))
        if role == "refiner":
            refiner = w
    return figures, launches, refiner


def phase_training_skip(dev, w) -> int:
    """A NaN pixel in one image of a full-width refiner batch: the step (a
    replay of phase 20's graph, its rasterizing kernels counted in its
    device trace) is skipped and the parameters, BatchNorm buffers, Adam's
    state and the schedule's count are bit-equal to before."""
    from happypose_tpu_torch.ops import rasterizer_fused as rf

    b = w.batch(1000)
    H, W = b.images.shape[2:]
    b.images[-1, :, H // 4, W // 3] = float("nan")
    draws = w.draws(b, 1000)
    before = _parameters_and_buffers(w.model)
    adam = {i: {k: v.clone() for k, v in st.items()}
            for i, st in w.state.optimizer.adam.state_dict()["state"].items()}
    count, n_step = w.state.optimizer.count, w.state.step
    rf.launches = 0
    out = []
    line, traced = _profile(lambda: out.append(w.step(w.state, b, draws)))
    m, launches = out[0], rf.launches
    after = _parameters_and_buffers(w.model)
    adam_after = w.state.optimizer.adam.state_dict()["state"]
    same = all(torch.equal(before[k], after[k]) for k in before) and all(
        torch.equal(v, adam_after[i][k]) for i in adam for k, v in adam[i].items())
    log(f"train skip: a NaN pixel in the last of {w.B} images: skipped_nonfinite {m['skipped_nonfinite']}, "
        f"loss {m['loss']}, grad_norm {m['grad_norm']}; parameters, buffers and Adam's state "
        f"bit-equal {same}; count {count} -> {w.state.optimizer.count}; {launches} wrapper "
        f"launches (a replay), {traced} rasterizing kernels in its trace ({line})")
    assert m["skipped_nonfinite"] == 1.0 and m["loss"] == 0.0 and m["grad_norm"] == 0.0
    assert same and w.state.optimizer.count == count and w.state.step == n_step + 1
    assert launches == 0 and traced == REFINER_ITERATIONS, (launches, traced)
    return launches


def phase_training_bf16(dev, figures: dict) -> int:
    """Both losses at full width with `compute_dtype="bfloat16"`: 3 steps
    each (the first warms cuDNN up), finite losses, s/step beside fp32's."""
    n_launches = 0
    for role in ("refiner", "coarse"):
        w = _train_world(dev, role, B=TRAIN_BATCH[role], compute_dtype="bfloat16")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        metrics, times, _, launches = _train_steps(w, 3)
        peak = torch.cuda.max_memory_allocated() / 2**30
        s_step = statistics.median(times[1:])
        fp32 = figures[role]
        figures[f"{role}_bf16"] = {"s_per_step": s_step, "samples_per_s": w.B / s_step,
                                   "peak_gib": peak}
        log(f"train {role} bf16 full width: loss {[round(m['loss'], 5) for m in metrics]}; s/step "
            f"{_fmt(times[1:])} ({w.B / s_step:.1f} samples/s, peak {peak:.2f} GiB) beside fp32 "
            f"{fp32['s_per_step']:.4f} ({fp32['samples_per_s']:.1f} samples/s, peak "
            f"{fp32['peak_gib']:.2f} GiB)")
        assert all(math.isfinite(m["loss"]) and m["skipped_nonfinite"] == 0 for m in metrics)
        n_launches += sum(launches)
    return n_launches


# The cut world card against CPU, by backbone: iterations and limits.
# EfficientNet-B3 from its own measurement (my CPU runs against float64 on
# this world): one iteration, loss 1.3e-5, head 8.9e-4, whole gradient L2
# 6.3e-4, worst tensor L2 2.9e-3 (a squeeze-excite bias), running statistics
# 3.7e-4 of max(their largest, 1e-3); each limit is ~4-8x that. With two
# iterations the CPU's float32 loss lies 4e-3 off float64 (the second
# iteration's renders follow the first's poses), so the cut runs one. The
# `bn2` biases of blocks 1-25 have gradient 0 in exact arithmetic (each
# feeds 1x1 convolutions into a train-mode BatchNorm) and a running mean
# behind a zero-mean residual stream is 0 too: such tensors are float
# noise on both devices, held below CUT_ZERO of the largest gradient entry
# (gradients) and by the floor of the statistics' scale.
CUT_ZERO = 1e-6
CUT_LIMITS = {
    "wide_resnet18": dict(n_iterations=2, loss=CUT_LOSS_RTOL, head=CUT_HEAD_REL,
                          glob=CUT_GLOBAL_L2, tensor=CUT_TENSOR_L2, stats=CUT_STATS_RTOL,
                          stats_floor=0.0),
    "efficientnet_b3": dict(n_iterations=1, loss=1e-4, head=5e-3, glob=5e-3, tensor=2e-2,
                            stats=3e-3, stats_floor=1e-3),
}


def phase_training_cross_check(dev, backbone="wide_resnet18") -> int:
    """Cut refiner training (`backbone`, WideResNet18 by default, 60x80
    renders, 120x160 images, B = 4, the iterations of CUT_LIMITS) on the
    card and on the CPU: the same weights, one batch and its draws made on
    the CPU and moved to the card. The loss, the gradients and the
    BatchNorm running statistics after the forward, within CUT_LIMITS."""
    from happypose_tpu_torch.ops import rasterizer_fused as rf

    lim = CUT_LIMITS[backbone]
    cut = dict(backbone=backbone, render=(60, 80), image=(120, 160), B=4,
               n_iterations=lim["n_iterations"])
    cpu = _train_world(torch.device("cpu"), "refiner", **cut)
    card = _train_world(dev, "refiner", **cut)
    b = cpu.batch(0)
    d = cpu.draws(b, 0)
    out = {}
    rf.launches = 0
    for name, w, bb, dd in (("cpu", cpu, b, d),
                            ("cuda", card, b.to(dev), {k: v.to(dev) for k, v in d.items()})):
        loss, _ = w.loss_fn(bb, dd)
        loss.backward()
        out[name] = (loss.item(), {n: p.grad.cpu() for n, p in w.model.named_parameters()},
                     {n: v.cpu() for n, v in w.model.named_buffers() if "running" in n})
    launches = rf.launches
    (l_cpu, g_cpu, s_cpu), (l_gpu, g_gpu, s_gpu) = out["cpu"], out["cuda"]
    largest = max(g.abs().max().item() for g in g_cpu.values())
    zero = [n for n, g in g_cpu.items() if g.abs().max().item() < CUT_ZERO * largest]
    zero_max = max([g_gpu[n].abs().max().item() / largest for n in zero] or [0.0])
    g_cpu = {n: g for n, g in g_cpu.items() if n not in zero}
    head = ((g_gpu["pose_fc.weight"] - g_cpu["pose_fc.weight"]).abs().max()
            / g_cpu["pose_fc.weight"].abs().max()).item()
    flat = lambda g: torch.cat([g[n].flatten() for n in g_cpu])  # noqa: E731
    glob = ((flat(g_gpu) - flat(g_cpu)).norm() / flat(g_cpu).norm()).item()
    per = {n: ((g_gpu[n] - g_cpu[n]).norm() / g_cpu[n].norm()).item() for n in g_cpu}
    worst = max(per, key=per.get)
    stats = max(((s_gpu[n] - s_cpu[n]).abs().max()
                 / max(s_cpu[n].abs().max().item(), lim["stats_floor"])).item() for n in s_cpu)
    log(f"train cut cuda vs cpu ({backbone}, 60x80, B=4, {lim['n_iterations']} iterations): "
        f"loss {l_gpu:.7f} / {l_cpu:.7f} (rel {abs(l_gpu - l_cpu) / l_cpu:.2e}); head gradient "
        f"{head:.2e} of its max; whole gradient L2 {glob:.2e}; worst tensor {worst} L2 "
        f"{per[worst]:.2e}; median tensor L2 {statistics.median(per.values()):.2e}; "
        f"{len(zero)} tensors of gradient 0 (card's largest {zero_max:.1e} of the whole "
        f"gradient's); running stats {stats:.2e} of their max; {launches} launches on the card")
    assert abs(l_gpu - l_cpu) <= lim["loss"] * l_cpu
    assert head <= lim["head"] and glob <= lim["glob"] and per[worst] <= lim["tensor"]
    assert zero_max < CUT_ZERO and stats <= lim["stats"]
    assert launches == lim["n_iterations"]
    return launches


def phase_train_cli(dev, root: Path, data: dict) -> dict:
    """From training to serving: `run_pose_training` on the card writes a
    refiner and a coarse run directory (CLI_EPOCHS epochs of CLI_EPOCH_SIZE,
    batch CLI_BATCH, 240x320 renders, 480x640 images, "textured" set), `eval_refiner_checkpoint`
    measures the refiner, and `run_eval --model from-checkpoints` reads both
    runs and estimates poses on 2 frames of the written split."""
    from happypose_tpu_torch.ops import rasterizer_fused as rf
    from happypose_tpu_torch.scripts import eval_refiner_checkpoint, run_pose_training
    from happypose_tpu_torch.scripts import run_eval as run_eval_cli
    from happypose_tpu_torch.utils.load_model import spec_from_checkpoints

    runs = root / "train_runs"
    common = ["--data", "synth", "--synth-set", "textured", "--epochs", str(CLI_EPOCHS),
              "--epoch-size", str(CLI_EPOCH_SIZE), "--batch-size", str(CLI_BATCH),
              "--render-size", *map(str, RES), "--image-size", *map(str, FRAME_RES),
              "--device", str(dev)]
    n_steps = CLI_EPOCHS * (CLI_EPOCH_SIZE // CLI_BATCH)
    launches = {}
    for role, extra, per_step in (("refiner", ["--n-iterations", "2"], 2),
                                  ("coarse", ["--model-type", "coarse"], 1)):
        rf.launches, k0 = 0, _synth_keys()
        rc, t = _timed(lambda: run_pose_training.main(["--run-dir", str(runs / role)] + common + extra))
        # the step's key and the synthetic batch's new ones: warm-up and capture
        expected = _graph_launches(per_step, 1) + _graph_launches(1, _synth_keys() - k0)
        launches[f"run_pose_training {role} ({n_steps} steps)"] = rf.launches
        lines = [json.loads(x) for x in (runs / role / "log.txt").read_text().splitlines()]
        log(f"run_pose_training {role}: {t:.2f} s, {n_steps} steps, wrapper launches "
            f"{rf.launches} (expected {expected}); epochs "
            f"{[{k: round(v, 4) for k, v in x.items()} for x in lines]}")
        assert rc == 0 and rf.launches == expected and len(lines) == CLI_EPOCHS
        assert all(math.isfinite(x["loss"]) and x["skipped_nonfinite"] == 0 for x in lines)

    rf.launches, k0 = 0, _synth_keys()
    rc, t = _timed(lambda: eval_refiner_checkpoint.main([
        "--run-dir", str(runs / "refiner"), "--n-batches", "2", "--batch-size", str(CLI_BATCH),
        "--image-size", *map(str, FRAME_RES), "--n-iterations", "3", "--device", str(dev)]))
    summary = json.loads((runs / "refiner" / "refiner_eval.json").read_text())
    # the refine graph's key (3 iterations) and the synthetic batch's new ones
    expected = _graph_launches(3, 1) + _graph_launches(1, _synth_keys() - k0)
    launches["eval_refiner_checkpoint (2 batches)"] = rf.launches
    log(f"eval_refiner_checkpoint: {t:.2f} s, launches {rf.launches} (expected {expected}); "
        f"{ {k: round(v, 4) for k, v in summary.items() if isinstance(v, float)} }")
    assert rc == 0 and rf.launches == expected
    assert all(math.isfinite(v) for v in summary.values() if isinstance(v, float))

    icfg = spec_from_checkpoints({"refiner": runs / "refiner", "coarse": runs / "coarse"}).inference_cfg
    rf.launches = 0
    res, t = _timed(lambda: run_eval_cli.run([
        "--split-dir", str(data["split"]), "--models-dir", str(data["models"]),
        "--model", "from-checkpoints", "--checkpoints", str(runs), "--max-frames", "2",
        "--out-dir", str(root / "eval_trained"), "--device", str(dev)]))
    expected = _runner_launches((D, _frame_launches(icfg, D, icfg.SO3_grid_size))
                                for D in data["n_per_frame"][:2])
    launches["run_eval from-checkpoints, trained runs (2 frames)"] = rf.launches
    poses = [r["poses"] for r in res["predictions"]]
    log(f"run_eval --model from-checkpoints on the trained runs: {t:.2f} s, {len(poses)} frames, "
        f"{sum(len(p) for p in poses)} poses, launches {rf.launches} (expected {expected}); "
        f"summary { {k: round(v, 4) for k, v in res['summary'].items() if isinstance(v, float)} }")
    assert len(poses) == 2 and all(np.isfinite(p).all() and len(p) > 0 for p in poses)
    assert rf.launches == expected
    return launches


# ----------------------------------------------------- training from disk

RECORD_BATCH = 16  # scenes a recorder batch
RECORD_SHADOW = 256  # shadow map side
RECORD_BATCHES = 2
RECORD_CUT = dict(res=(120, 160), shadow=64, scenes=2)
# The recorder, card against CPU on one cut batch with the same draws and
# noise. The kernel equals its plain version bit for bit, so the renders,
# the composite's depth and the annotations (integer counts and pixel
# coordinates of the same masks) are expected equal; shading, specular,
# blur and noise are float32 elementwise work that the two devices round
# differently in the last bits, and rounding to 8 bits turns such a
# difference into one level where a value lies near a half level.
REC_RGB_LEVELS, REC_RGB_SHARE = 1, 0.995
REC_PX_ATOL, REC_BBOX_ATOL, REC_DEPTH_ATOL = 2, 1.0, 1e-5
SPLIT_FRAMES = 32  # frames `record_synthetic_dataset` writes for phases 26-29
DISK_STEPS = 6  # steps of each training from disk; 2-6 are timed
DET_BATCH, DET_RES = 8, RES
# Cut detector training, card against CPU (FPN 32, 120x160, B = 2, one
# step): BatchNorm in train mode divides by the spread of 2 x 4 x 5 values
# at C5, so float32 rounding of 50+ layers is amplified; on the CPU the
# port's float32 outputs lay 3.5e-5 to 4.7e-4 of their largest entry from a
# float64 run. Loss to DET_CUT_LOSS_RTOL, each head's gradient to
# DET_CUT_HEAD_REL of its largest entry, the running statistics to
# DET_CUT_STATS_RTOL of each buffer's largest. The heads are those with no
# ReLU between them and the loss (the prototypes' last convolution has
# one: an output within rounding of 0 passes its gradient on one device
# only).
DET_CUT_LOSS_RTOL = 1e-4
DET_CUT_HEAD_REL = 1e-3
DET_CUT_STATS_RTOL = 1e-3
DET_HEADS = ("cls_head", "box_head", "ctr_head", "coef_head")


def _recorder(dev, res=None, scenes=None, shadow=None, seed=0):
    """The recorder on the "textured" set of phase 20 (under BOP labels)
    plus the floor, 2-4 objects a scene; by default at FRAME_RES with
    RECORD_BATCH scenes a batch and RECORD_SHADOW shadows."""
    from happypose_tpu_torch.datasets.scene_record import BatchedSceneRecorder
    from happypose_tpu_torch.datasets.scene_synth import SceneSynthConfig
    from happypose_tpu_torch.scripts.record_synthetic_dataset import builtin_mesh_db

    return BatchedSceneRecorder(
        builtin_mesh_db("textured"), SceneSynthConfig(resolution=res or FRAME_RES), seed=seed,
        batch_scenes=scenes or RECORD_BATCH, shadow_size=shadow or RECORD_SHADOW, device=dev)


def recorder_kernel_inputs(dev) -> dict:
    """Packed faces of the recorder's two renders of its first batch, from
    the recorder's own inputs: the instances at the frame's size and the
    shadow pass from the light cameras. {name: (A, chunk_bbox, resolution)}."""
    from happypose_tpu_torch.ops import rasterizer_fused as rf

    rec = _recorder(dev)
    _, inp = rec._sample_batch()
    so, ids, M = inp["scene_of"], inp["obj_ids"], len(inp["obj_ids"])
    inst = rec.assets.select(ids)
    T_LO = torch.einsum("mij,mjk->mik", inp["T_LC"][so], inp["TCO"])
    shapes = {}
    for name, T, K, res in (
            (f"recorder_instances_B{M}_{FRAME_RES[0]}x{FRAME_RES[1]}", inp["TCO"], inp["K"][so],
             FRAME_RES),
            (f"recorder_shadow_B{M}_{RECORD_SHADOW}x{RECORD_SHADOW}", T_LO, inp["K_L"][so],
             (RECORD_SHADOW, RECORD_SHADOW))):
        fd, attrs = rf.face_inputs(inst, T, K)
        shapes[name] = (*rf.pack_faces(fd.u, fd.v, fd.inv_z, fd.valid, attrs, res), res)
    return shapes


def phase_recorder(dev, root: Path) -> dict:
    """The recorder at full width: RECORD_BATCHES batches of RECORD_BATCH
    scenes at 480x640 with shadows at 256: 2 launches a batch, scenes/s on
    the device, accepted frames written as a BOP scene (frames/s written);
    then one cut batch on the card and on the CPU with the same draws and
    noise."""
    from happypose_tpu_torch.datasets.bop import SceneObservation, write_bop_scene
    from happypose_tpu_torch.datasets.scene_record import record_scene_batch
    from happypose_tpu_torch.ops import rasterizer_fused as rf

    rec = _recorder(dev)
    rf.launches = 0
    frames, times = [], []
    for _ in range(RECORD_BATCHES):
        (scenes, out), t = _timed(rec.record_batch)
        times.append(t)
        frames += [f for f in rec.frames_of(scenes, out) if f is not None]
    launches = rf.launches
    n_scenes = RECORD_BATCHES * RECORD_BATCH
    obs = [SceneObservation(rgb=f.rgb, K=f.K, depth=f.depth, obj_labels=f.labels, TWO=f.TCO,
                            bboxes=f.bboxes, visib_fract=f.visib_fract, view_id=i, TWC=f.TWC)
           for i, f in enumerate(frames)]
    _, t_write = _timed(lambda: write_bop_scene(root / "recorded", 0, obs))
    figures = {"s_per_batch": times, "scenes_per_s": RECORD_BATCH / statistics.median(times),
               "frames_accepted": len(frames), "frames_written_per_s": len(frames) / t_write}
    log(f"recorder full width (textured set + floor, {FRAME_RES}, {RECORD_BATCH} scenes a batch, "
        f"M = {rec.batch_scenes * rec.n_max}, shadows {RECORD_SHADOW}): {RECORD_BATCHES} batches, "
        f"launches {launches} (expected {2 * RECORD_BATCHES}); s/batch {_fmt(times)} (the first "
        f"includes warm-up), {figures['scenes_per_s']:.1f} scenes/s on the device; "
        f"{len(frames)} of {n_scenes} frames accepted; written as PNG + json in {t_write:.3f} s "
        f"({figures['frames_written_per_s']:.1f} frames/s)")
    assert launches == 2 * RECORD_BATCHES, launches
    assert len(frames) >= n_scenes // 4
    for f in frames:
        assert f.rgb.shape == (*FRAME_RES, 3) and f.rgb.dtype == np.uint8
        assert np.isfinite(f.depth).all() and f.depth.max() > 0.1
        assert (f.visib_fract > 0).all() and (f.visib_fract <= 1).all()

    # one cut batch, card against CPU: the same inputs, noise drawn on the CPU
    c = RECORD_CUT
    outs = {}
    for name, d in (("cpu", torch.device("cpu")), ("cuda", dev)):
        r = _recorder(d, res=c["res"], scenes=c["scenes"], shadow=c["shadow"], seed=3)
        _, inp = r._sample_batch()
        noise = torch.randn(c["scenes"], *c["res"], 3, generator=torch.Generator().manual_seed(5))
        outs[name] = [x.cpu() for x in record_scene_batch(
            r.assets, noise=noise.to(d), n_scenes=c["scenes"], resolution=c["res"],
            shadow_size=c["shadow"], bg_pool=r.bg_pool, **inp)]
    from happypose_tpu_torch.datasets.scene_record import RecordBatch

    a, b = RecordBatch(*outs["cpu"]), RecordBatch(*outs["cuda"])
    d_rgb = (a.rgb.int() - b.rgb.int()).abs()
    share = (d_rgb <= REC_RGB_LEVELS).float().mean().item()
    shown = a.visib_px > 0
    px = max((a.visib_px - b.visib_px).abs().max().item(), (a.solo_px - b.solo_px).abs().max().item())
    bb = (a.bbox[shown] - b.bbox[shown]).abs().max().item() if shown.any() else 0.0
    dd = (a.depth - b.depth).abs().max().item()
    log(f"recorder cut card vs cpu ({c['scenes']} scenes, {c['res'][0]}x{c['res'][1]}, shadow "
        f"{c['shadow']}): rgb within {REC_RGB_LEVELS} level on {share:.6f} of values (max "
        f"{int(d_rgb.max())}), equal on {(d_rgb == 0).float().mean().item():.6f}; visib/solo px "
        f"max diff {px}; bbox max diff {bb}; depth max diff {dd:.3g} m; any_vis "
        f"{a.any_vis.tolist()} / {b.any_vis.tolist()}")
    assert share >= REC_RGB_SHARE and px <= REC_PX_ATOL and bb <= REC_BBOX_ATOL
    assert dd <= REC_DEPTH_ATOL and torch.equal(a.any_vis, b.any_vis)
    assert torch.equal(a.border_bad, b.border_bad) and shown.any()
    figures["launches"] = launches
    return figures


def phase_record_cli(dev, root: Path) -> dict:
    """`record_synthetic_dataset --wds` on the card: SPLIT_FRAMES frames at
    480x640 in BOP layout and tar shards; `BOPSceneDataset` and
    `WebSceneDataset` read back the same frames."""
    from happypose_tpu_torch.datasets.bop import BOPObjectDataset, BOPSceneDataset
    from happypose_tpu_torch.datasets.scene_record import BatchedSceneRecorder
    from happypose_tpu_torch.datasets.web_scene_dataset import WebSceneDataset
    from happypose_tpu_torch.ops import rasterizer_fused as rf
    from happypose_tpu_torch.scripts import record_synthetic_dataset

    out = root / "synth_split"
    batches = []  # one entry a batch the CLI's recorder renders
    record_batch = BatchedSceneRecorder.record_batch
    BatchedSceneRecorder.record_batch = lambda self, *a: batches.append(1) or record_batch(self, *a)
    try:
        rf.launches = 0
        rc, t = _timed(lambda: record_synthetic_dataset.main([
            "--out-dir", str(out), "--n-frames", str(SPLIT_FRAMES), "--resolution",
            *map(str, FRAME_RES), "--batch-scenes", str(RECORD_BATCH), "--builtin-set", "textured",
            "--write-models", "--wds", "--shard-size", "8", "--device", str(dev)]))
        launches = rf.launches
    finally:
        BatchedSceneRecorder.record_batch = record_batch
    (bop, t_bop), (wds, t_wds) = _timed(lambda: BOPSceneDataset(out, load_depth=True)), _timed(
        lambda: WebSceneDataset(out / "wds"))
    reads = {}
    for name, ds in (("bop", bop), ("wds", wds)):
        t0 = time.perf_counter()
        reads[name] = [ds[i] for i in range(len(ds))]
        reads[name + "_fps"] = len(ds) / (time.perf_counter() - t0)
    n_inst = sum(len(o.obj_labels) for o in reads["bop"])
    log(f"record_synthetic_dataset --wds: {t:.2f} s for {SPLIT_FRAMES} frames ({SPLIT_FRAMES / t:.1f} "
        f"frames/s, recording and writing), launches {launches} in {len(batches)} batches (2 a batch), {n_inst} instances; "
        f"read back: BOP {reads['bop_fps']:.1f} frames/s, WDS {reads['wds_fps']:.1f} frames/s")
    assert rc == 0 and len(batches) >= math.ceil(SPLIT_FRAMES / RECORD_BATCH)
    assert launches == 2 * len(batches), (launches, len(batches))
    assert len(bop) == len(wds) == SPLIT_FRAMES
    for a, b in zip(reads["bop"], reads["wds"]):
        assert np.array_equal(a.rgb, b.rgb) and list(a.obj_labels) == list(b.obj_labels)
        assert np.abs(a.TWO - b.TWO).max() <= 1e-6 and np.abs(a.depth - b.depth).max() <= 1e-6
    db = BOPObjectDataset(out / "models").mesh_db
    assert db.labels == ["obj_000001", "obj_000002"]
    return {"split": out, "models": out / "models", "db": db, "launches": launches,
            "frames_per_s": SPLIT_FRAMES / t, "bop_read_fps": reads["bop_fps"],
            "wds_read_fps": reads["wds_fps"]}


def _disk_world(dev, split: dict):
    """A refiner at phase 20's width on the recorded objects: ResNet34,
    240x320 rgb + normals renders, 3 iterations, Adam lr 3e-4, 2 warmup steps."""
    from types import SimpleNamespace

    from happypose_tpu_torch.models.pose_predictor import PosePredictor, PosePredictorConfig
    from happypose_tpu_torch.training import TrainState, make_optimizer, make_train_step
    from happypose_tpu_torch.training.forward_loss import make_refiner_loss_fn
    from happypose_tpu_torch.utils.random import generator_for

    db = split["db"]
    assets, meshes = db.render_assets(device=dev), db.batched(n_points=256, device=dev)
    cfg = PosePredictorConfig(backbone="resnet34", render_size=RES, predict_pose_update=True,
                              predict_rendered_views_logits=False)
    model = PosePredictor(cfg).init_weights(torch.Generator().manual_seed(0)).to(dev)
    loss_fn = make_refiner_loss_fn(model, assets, meshes, n_iterations=REFINER_ITERATIONS)
    return SimpleNamespace(
        model=model, loss_fn=loss_fn, step=make_train_step(loss_fn),
        state=TrainState(model, make_optimizer(model.parameters(), lr=3e-4, n_warmup_steps=2)),
        draws=lambda b, i: loss_fn.sample(generator_for("step", 0, i, device=dev), b))


def phase_train_from_disk(dev, root: Path, split: dict, synth_s_step: float) -> dict:
    """The refiner at full width (480x640 images, B = 16) on the recorded
    split: DISK_STEPS steps through `PoseDataset` with `device_cache`, then
    DISK_STEPS through `StreamingPoseDataset`; `device_cache` batches equal
    the host path's; `eval_refiner_checkpoint --split-dir` on the run."""
    from happypose_tpu_torch.datasets.bop import BOPSceneDataset
    from happypose_tpu_torch.datasets.pose_dataset import PoseDataset
    from happypose_tpu_torch.datasets.streaming_pose_dataset import StreamingPoseDataset
    from happypose_tpu_torch.ops import rasterizer_fused as rf
    from happypose_tpu_torch.scripts import eval_refiner_checkpoint
    from happypose_tpu_torch.utils.checkpoint import save_checkpoint

    B = TRAIN_BATCH["refiner"]
    scene_ds = BOPSceneDataset(split["split"], cache_frames=True)
    kw = dict(batch_size=B, resolution=FRAME_RES, device=str(dev), seed=4)
    host, cached = iter(PoseDataset(scene_ds, split["db"], **kw)), iter(
        PoseDataset(scene_ds, split["db"], device_cache=True, **kw))
    for _ in range(2):
        a, b = next(host), next(cached)
        assert all(torch.equal(x, y) for x, y in zip(a, b)), "device_cache differs from the host path"
    w = _disk_world(dev, split)
    figures, launches = {}, {}
    # the first step captures the step (its warm-up and capture); the rest,
    # the streamed ones too (the same key), replay
    expected = iter(_step_launches(1 + REFINER_ITERATIONS, DISK_STEPS, 0) + [0] * DISK_STEPS)
    stream = StreamingPoseDataset(str(split["split"] / "wds"), split["db"], chunk_frames=16, **kw)
    try:
        for name, it in (("pose_dataset_device_cache", cached), ("streaming", iter(stream))):
            metrics, times, data_times, n_launch = [], [], [], []
            torch.cuda.reset_peak_memory_stats()
            for i in range(DISK_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                batch = next(it)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                rf.launches = 0
                metrics.append(w.step(w.state, batch, w.draws(batch, i)))
                torch.cuda.synchronize()
                n_launch.append(rf.launches)
                times.append(time.perf_counter() - t0)
                data_times.append(t1 - t0)
            s_step = statistics.median(times[1:])
            figures[name] = {"s_per_step": s_step, "samples_per_s": B / s_step,
                             "s_batch": statistics.median(data_times[1:]),
                             "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
            launches[f"train refiner from disk, {name} ({DISK_STEPS} steps)"] = sum(n_launch)
            want = [next(expected) for _ in range(DISK_STEPS)]
            b = next(it)
            line, traced = _profile(lambda: w.step(w.state, b, w.draws(b, DISK_STEPS)))
            log(f"train refiner from disk via {name} (ResNet34, render {RES}, images {FRAME_RES}, "
                f"B={B}, 3 iterations): wrapper launches a step {n_launch}, expected {want}; "
                f"a replayed step's trace: {line}; "
                f"loss {[round(m['loss'], 5) for m in metrics]}; s/step (steps 2-{DISK_STEPS}, "
                f"batch included) {_fmt(times[1:])}, of it the batch {figures[name]['s_batch']:.4f}; "
                f"beside phase 20's synthetic {synth_s_step:.4f}; "
                f"{figures[name]['samples_per_s']:.1f} samples/s; peak {figures[name]['peak_gib']:.2f} GiB")
            assert n_launch == want and traced == REFINER_ITERATIONS, (n_launch, traced)
            assert all(math.isfinite(m["loss"]) and m["skipped_nonfinite"] == 0 for m in metrics)
    finally:
        stream.stop()

    run = root / "disk_refiner"
    save_checkpoint(run, w.state, 1, config={"backbone": "resnet34", "render_size": list(RES)})
    rf.launches = 0
    rc, t = _timed(lambda: eval_refiner_checkpoint.main([
        "--run-dir", str(run), "--split-dir", str(split["split"]), "--models-dir",
        str(split["models"]), "--n-batches", "2", "--batch-size", "8", "--image-size",
        *map(str, FRAME_RES), "--n-iterations", "3", "--device", str(dev)]))
    summary = json.loads((run / "refiner_eval.json").read_text())
    launches["eval_refiner_checkpoint --split-dir (2 batches)"] = rf.launches
    expected = _graph_launches(3, 1)  # the refine graph's key; the second batch replays
    log(f"eval_refiner_checkpoint --split-dir: {t:.2f} s, launches {rf.launches} (expected "
        f"{expected}); { {k: round(v, 4) for k, v in summary.items() if isinstance(v, float)} }")
    assert rc == 0 and rf.launches == expected and summary["data"] == str(split["split"])
    assert all(math.isfinite(v) for v in summary.values() if isinstance(v, float))
    return {"figures": figures, "launches": launches}


def _detector_step_world(dev, split: dict, fpn: int, res, B: int, seed=0):
    """`run_detector_training`'s trainer (seeded model, plain Adam, step) on
    the recorded objects, and the CLI's batches."""
    from types import SimpleNamespace

    from happypose_tpu_torch.datasets.bop import BOPSceneDataset
    from happypose_tpu_torch.scripts.run_detector_training import BatchMaker, make_detector_trainer

    db = split["db"]
    trainer = make_detector_trainer(len(db.labels), fpn, 1e-4, dev, seed=seed)
    maker = BatchMaker(BOPSceneDataset(split["split"], cache_frames=True), db.label_to_id, res,
                       B, 8, dev)
    return SimpleNamespace(maker=maker, **trainer._asdict())


def phase_detector_training(dev, split: dict) -> dict:
    """The detector at full width (ResNet50-FPN, 256 channels, 16
    prototypes) on the recorded split at 240x320, B = DET_BATCH, DISK_STEPS
    steps; the mAP hook; then a cut step on the card and on the CPU."""
    from happypose_tpu_torch.datasets.augmentations import rgb_jitter, sample_rgb_jitter
    from happypose_tpu_torch.scripts.run_detector_training import eval_map

    w = _detector_step_world(dev, split, 256, DET_RES, DET_BATCH)
    before = _parameters_and_buffers(w.model)
    rng = np.random.RandomState(0)
    aug = torch.Generator(device=dev).manual_seed(7)
    torch.cuda.reset_peak_memory_stats()
    metrics, times = [], []
    for _ in range(DISK_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, targets = w.maker.make(rng)
        x = rgb_jitter(x, sample_rgb_jitter(aug, x.shape[0]))
        metrics.append(w.step(w.state, (x, targets), {}))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    after = _parameters_and_buffers(w.model)
    unmoved = [k for k in before if not k.endswith("num_batches_tracked")
               and torch.equal(before[k], after[k])]
    mAP, t_map = _timed(lambda: eval_map(w.model, w.maker, 8))
    s_step = statistics.median(times[1:])
    log(f"detector training full width (ResNet50-FPN 256, 16 prototypes, {DET_RES}, B={DET_BATCH}): "
        f"loss {[round(m['loss'], 4) for m in metrics]}; s/step (steps 2-{DISK_STEPS}, batch and "
        f"jitter included) {_fmt(times[1:])}, {DET_BATCH / s_step:.1f} images/s; peak {peak:.2f} "
        f"GiB; mAP@0.5 hook on 8 frames {mAP:.4f} in {t_map:.2f} s")
    assert all(math.isfinite(m["loss"]) and m["skipped_nonfinite"] == 0 for m in metrics)
    assert not unmoved, f"detector parameters or statistics did not move: {unmoved[:5]}"
    assert 0.0 <= mAP <= 1.0

    # cut: the same weights, batch and jitter on the CPU and on the card
    cpu = _detector_step_world(torch.device("cpu"), split, 32, (120, 160), 2, seed=1)
    card = _detector_step_world(dev, split, 32, (120, 160), 2, seed=1)
    x, targets = cpu.maker.make(np.random.RandomState(2))
    x = rgb_jitter(x, sample_rgb_jitter(torch.Generator().manual_seed(3), 2))
    out = {}
    for name, ww, xx, tt in (("cpu", cpu, x, targets), ("cuda", card, x.to(dev), targets.to(dev))):
        loss, _ = ww.loss((xx, tt), {})
        loss.backward()
        out[name] = (loss.item(), {h: getattr(ww.model, h).weight.grad.cpu() for h in DET_HEADS},
                     {k: v.cpu() for k, v in ww.model.named_buffers() if "running" in k})
    (l_cpu, g_cpu, s_cpu), (l_gpu, g_gpu, s_gpu) = out["cpu"], out["cuda"]
    heads = {h: ((g_gpu[h] - g_cpu[h]).abs().max() / g_cpu[h].abs().max()).item() for h in DET_HEADS}
    stats = max(((s_gpu[k] - s_cpu[k]).abs().max() / s_cpu[k].abs().max()).item() for k in s_cpu)
    log(f"detector cut cuda vs cpu (FPN 32, 120x160, B=2): loss {l_gpu:.7f} / {l_cpu:.7f} (rel "
        f"{abs(l_gpu - l_cpu) / l_cpu:.2e}); heads' gradients of their max "
        f"{ {h: f'{v:.2e}' for h, v in heads.items()} }; running stats {stats:.2e} of their max")
    assert abs(l_gpu - l_cpu) <= DET_CUT_LOSS_RTOL * l_cpu
    assert max(heads.values()) <= DET_CUT_HEAD_REL and stats <= DET_CUT_STATS_RTOL
    return {"s_per_step": s_step, "images_per_s": DET_BATCH / s_step, "peak_gib": peak,
            "mAP": mAP}


def phase_training_clis(dev, root: Path, split: dict) -> dict:
    """The CLIs end to end on the recorded split: `run_pose_training --data
    --stream` (1 epoch), `run_detector_training` writes a run directory, and
    `run_eval --model cosypose-RGB --detections detector` reads it on 2
    frames of the split: every pose finite, launches as the config implies."""
    from happypose_tpu_torch.ops import rasterizer_fused as rf
    from happypose_tpu_torch.scripts import run_detector_training, run_pose_training
    from happypose_tpu_torch.scripts import run_eval as run_eval_cli
    from happypose_tpu_torch.utils import load_model as lm

    launches = {}
    rf.launches = 0
    rc, t = _timed(lambda: run_pose_training.main([
        "--run-dir", str(root / "stream_run"), "--data", str(split["split"]), "--models-dir",
        str(split["models"]), "--stream", "--stream-chunk", "16", "--epochs", "1", "--epoch-size",
        "16", "--batch-size", "8", "--render-size", *map(str, RES), "--image-size",
        *map(str, FRAME_RES), "--device", str(dev)]))
    launches["run_pose_training --stream (2 steps)"] = rf.launches
    (line,) = [json.loads(x) for x in (root / "stream_run" / "log.txt").read_text().splitlines()]
    expected = _graph_launches(1, 1)  # one iteration: the step's warm-up and capture
    log(f"run_pose_training --data --stream: {t:.2f} s, launches {rf.launches} (expected "
        f"{expected}), loss {line['loss']:.5f}")
    assert rc == 0 and rf.launches == expected and math.isfinite(line["loss"])

    det_run = root / "det_run"
    rc, t = _timed(lambda: run_detector_training.main([
        "--run-dir", str(det_run), "--split-dir", str(split["split"]), "--models-dir",
        str(split["models"]), "--epochs", "1", "--epoch-size", "16", "--batch-size", "8",
        "--fpn-channels", "256", "--eval-interval", "1", "--device", str(dev)]))
    (line,) = [json.loads(x) for x in (det_run / "log.txt").read_text().splitlines()]
    log(f"run_detector_training: {t:.2f} s, epoch {line}")
    assert rc == 0 and math.isfinite(line["loss"]) and (det_run / "state_dict.pt").exists()

    spec = lm.NAMED_MODELS["cosypose-RGB"]
    rf.launches = 0
    res, t = _timed(lambda: run_eval_cli.run([
        "--split-dir", str(split["split"]), "--models-dir", str(split["models"]),
        "--model", "cosypose-RGB", "--detections", "detector", "--detector-run", str(det_run),
        "--detection-th", "0.0", "--max-frames", "2", "--out-dir", str(root / "eval_trained_det"),
        "--device", str(dev)]))
    preds = res["predictions"]
    n_det = [len(r["poses"]) for r in preds]
    expected = _runner_launches((D, _frame_launches(spec.inference_cfg, D)) for D in n_det)
    launches["run_eval cosypose-RGB, trained detector (2 frames)"] = rf.launches
    log(f"run_eval --model cosypose-RGB --detections detector (the trained run): {t:.2f} s, "
        f"detections a frame {n_det}, launches {rf.launches} (expected {expected})")
    assert len(preds) == 2 and min(n_det) >= 1 and rf.launches == expected
    assert all(np.isfinite(r["poses"]).all() for r in preds)
    return launches


# ----------------------------------------------------- multiview

MV_VIEWS = 4  # `run_multiview_eval --synthesize`: 4 views of 3 objects at 240x320
MV_OBJECTS = 3
MV_SUMMARY_RTOL = 1e-3  # the CLI's summary, card against CPU
MV_REPEATS = 3  # warm `predict_scene_state` calls timed
BA_VIEWS, BA_OBJECTS = 8, 15  # the larger BA: a T-LESS-sized scene, every object in every view
BA_ITERATIONS = 50
BA_STEP_LAMBDA = 1e4  # one LM step card vs CPU where its system is well conditioned
BA_STEP_ATOL = 1e-4  # poses after that step, card against CPU
BA_BLOCKS_REL = 1e-4  # Schur blocks card vs CPU, of the largest entry (index_add order)
#   Below lambda ~1e2 the step is float32 noise along the ortho6d null directions in both
#   packages and on both devices alike (tests/test_torch_multiview.py measures 0.92 in pose
#   at lambda 1e-3 between JAX and the port): such steps are only logged.


class _MultiviewProbe:
    """While active, times each `multiview_candidate_matching` call and
    each `MultiviewRefinement.solve` (host clock around synchronized work)
    and keeps the matches and the predictor's calls, so that a CLI run can
    be split into matching and BA and its scene replayed."""

    def __init__(self):
        self.match_s, self.ba_s, self.matches, self.calls, self.solves = [], [], [], [], []

    def __enter__(self):
        from happypose_tpu_torch.multiview import scene_predictor as sp
        from happypose_tpu_torch.multiview.bundle_adjustment import MultiviewRefinement

        self._saved = (sp.multiview_candidate_matching, MultiviewRefinement.solve,
                       sp.MultiviewScenePredictor.predict_scene_state)
        match, solve, predict = self._saved

        def timed_match(*a, **k):
            out, t = _timed(lambda: match(*a, **k))
            self.match_s.append(t)
            self.matches.append(out)
            return out

        def timed_solve(refiner, *a, **k):
            out, t = _timed(lambda: solve(refiner, *a, **k))
            self.ba_s.append(t)
            self.solves.append(out)
            return out

        def recorded_predict(predictor, *a, **k):
            self.calls.append((predictor, a, k))
            return predict(predictor, *a, **k)

        sp.multiview_candidate_matching = timed_match
        MultiviewRefinement.solve = timed_solve
        sp.MultiviewScenePredictor.predict_scene_state = recorded_predict
        return self

    def __exit__(self, *exc):
        from happypose_tpu_torch.multiview import scene_predictor as sp
        from happypose_tpu_torch.multiview.bundle_adjustment import MultiviewRefinement

        (sp.multiview_candidate_matching, MultiviewRefinement.solve,
         sp.MultiviewScenePredictor.predict_scene_state) = self._saved


class _KernelInputs:
    """While active, keeps the inputs of the first `raster_fused` call at
    each (batch, resolution), so that a path's shapes can be held to the
    plain version after its launches are counted."""

    def __init__(self):
        self.seen = {}

    def __enter__(self):
        from happypose_tpu_torch.ops import rasterizer_fused as rf

        self._launch = launch = rf.raster_fused

        def recording(A, chunk_bbox, resolution, *a, **k):
            self.seen.setdefault((A.shape[0], tuple(resolution)), (A, chunk_bbox, tuple(resolution)))
            return launch(A, chunk_bbox, resolution, *a, **k)

        rf.raster_fused = recording
        return self

    def __exit__(self, *exc):
        from happypose_tpu_torch.ops import rasterizer_fused as rf

        rf.raster_fused = self._launch


# (batch, resolution) of the shapes phase 3 holds
HELD_SHAPES = frozenset({(B, tuple(res)) for _, B, res, _, _ in KERNEL_SHAPES} | {
    (TRAIN_BATCH["refiner"], FRAME_RES), (TRAIN_BATCH["coarse"] * GRID_HYPOTHESES, RES),
    # the recorder's slots: 4 objects and the floor a scene
    (RECORD_BATCH * 5, FRAME_RES), (RECORD_BATCH * 5, (RECORD_SHADOW, RECORD_SHADOW))})


def _check_new_shapes(path: str, inputs: "_KernelInputs", kernel: dict, held=None) -> None:
    """Hold each shape a path launched at, and phase 3 does not hold (or
    that is not in `held`, where given), to the plain version: lists,
    output, time beside the bound."""
    held = kernel.setdefault("held", set(HELD_SHAPES)) if held is None else held
    for (B, res), (A, bbox, _) in sorted(inputs.seen.items()):
        if (B, res) in held:
            continue
        name = f"{path}_B{B}_{res[0]}x{res[1]}"
        kernel["shapes"][name], err = _check_shape(name, A, bbox, res, min_hit=0.0005)
        kernel["max_abs_err"] = max(kernel["max_abs_err"], err)
        held.add((B, res))


def _device_share(fn) -> str:
    """One call of `fn` under `torch.profiler`: its device kernels and
    copies, their time, the call's wall time and the device's idle share.
    The device's activity only: reading back a scene's ~100,000 host
    operators as well takes the profiler tens of seconds."""
    from happypose_tpu_torch.bench import busy_share

    p = busy_share(fn)
    return (f"{p['device_kernels']} device kernels and copies, {p['busy_s'] * 1e3:.2f} ms on "
            f"the device of {p['wall_s'] * 1e3:.1f} ms (idle {1 - p['busy_share']:.3f})")


def _scene_split(probe: _MultiviewProbe, solver: str) -> dict:
    """Replay the probe's first scene MV_REPEATS times, warm: s/scene of
    matching and of BA, then one scene under the profiler."""
    predictor, a, k = probe.calls[0]
    replay = _MultiviewProbe()
    with replay:
        totals = [_timed(lambda: predictor.predict_scene_state(*a, **k))[1]
                  for _ in range(MV_REPEATS)]
    prof = _device_share(lambda: predictor.predict_scene_state(*a, **k))
    fig = {"s_per_scene": totals, "match_s": replay.match_s[:MV_REPEATS],
           "ba_s": replay.ba_s[:MV_REPEATS]}
    log(f"multiview {solver}: warm s/scene {_fmt(totals)}; matching {_fmt(fig['match_s'])}; "
        f"BA ({predictor.ba_n_iterations} iterations) {_fmt(fig['ba_s'])}; one scene: {prof}")
    return fig


def phase_multiview_synthesize(dev, root: Path, kernel: dict) -> dict:
    """`run_multiview_eval --synthesize --n-views 4` on the card (dense BA),
    then `--ba-solver schur` on the written scene, then `--device cpu`."""
    from happypose_tpu_torch.ops import rasterizer_fused as rf
    from happypose_tpu_torch.scripts import run_multiview_eval as mv

    scene = root / "multiview"
    runs = {}
    for name, argv in (("dense", ["--synthesize", "--n-views", str(MV_VIEWS)]),
                       ("schur", ["--ba-solver", "schur"]),
                       ("cpu", ["--device", "cpu"])):
        out = root / f"multiview_{name}"
        device = ["--device", str(dev)] if name != "cpu" else []
        inputs = _KernelInputs()
        with _MultiviewProbe() as probe, inputs:
            rf.launches = 0
            rc, t = _timed(lambda: mv.main(
                ["--out-dir", str(scene if name == "dense" else out), "--models-dir",
                 str(scene / "models"), "--scenes-dir", str(scene / "scenes")] + argv + device))
            launches = rf.launches
        summary = json.loads(((scene if name == "dense" else out) / "multiview_summary.json").read_text())
        expected = MV_VIEWS * (1 + MV_OBJECTS) if name == "dense" else 0
        runs[name] = dict(probe=probe, summary=summary, launches=launches, s=t)
        log(f"run_multiview_eval {' '.join(argv)} ({name}): {t:.2f} s, launches {launches} "
            f"(expected {expected}), matching {probe.match_s[0]:.4f} s, BA {probe.ba_s[0]:.4f} s; "
            f"summary {json.dumps(summary)}")
        assert rc == 0 and launches == expected and summary["n_scenes"] == 1
        assert math.isfinite(summary["ba_loss_mean"]) and all(
            math.isfinite(s["loss"]) for s in probe.solves)
        if name == "dense":
            _check_new_shapes("multiview_synthesize", inputs, kernel)
    cuda, cpu = runs["dense"], runs["cpu"]
    np.testing.assert_array_equal(cuda["probe"].matches[0]["component_ids"],
                                  cpu["probe"].matches[0]["component_ids"])
    for k, v in cuda["summary"].items():
        if k == "candidates":
            assert v == cpu["summary"][k]
        else:
            np.testing.assert_allclose(v, cpu["summary"][k], rtol=MV_SUMMARY_RTOL, atol=1e-6,
                                       err_msg=k)
    log(f"run_multiview_eval card vs cpu: component ids equal "
        f"{cuda['probe'].matches[0]['component_ids'].tolist()}, summary within "
        f"{MV_SUMMARY_RTOL} relative")
    figures = {solver: _scene_split(runs[solver]["probe"], solver) for solver in ("dense", "schur")}
    return {"scene": scene, "figures": figures, "launches": {
        f"run_multiview_eval --synthesize ({MV_VIEWS} views, dense)": cuda["launches"],
        "run_multiview_eval --ba-solver schur (the written scene)": runs["schur"]["launches"]}}


def _scene_observations(scene: Path):
    from happypose_tpu_torch.datasets.bop import BOPObjectDataset, BOPSceneDataset

    ds = BOPSceneDataset(scene / "scenes")
    return BOPObjectDataset(scene / "models").mesh_db, [ds[i] for i in range(len(ds))]


def phase_multiview_pipeline(dev, root: Path, scene: Path, kernel: dict) -> dict:
    """Candidates from the single-view pipeline: `run_multiview_eval
    --checkpoints` on phase 24's run directories (ResNet34, 240x320, 5
    refiner iterations) and `_pipeline_candidates` with a seeded
    `cosypose-RGB` at full width, on the 4 views. Launches as the configs
    imply, finite poses; whether the seeded weights' candidates give a
    scene is logged, not asserted."""
    from happypose_tpu_torch.multiview import MultiviewCandidates
    from happypose_tpu_torch.multiview.scene_predictor import MultiviewScenePredictor
    from happypose_tpu_torch.ops import rasterizer_fused as rf
    from happypose_tpu_torch.scripts import run_multiview_eval as mv
    from happypose_tpu_torch.utils.load_model import (
        NAMED_MODELS, load_named_model, spec_from_checkpoints)

    db, obs = _scene_observations(scene)
    n_per_view = [len(o.obj_labels) for o in obs]
    launches = {}
    runs = root / "train_runs"
    icfg = dataclasses.replace(spec_from_checkpoints(
        {"refiner": runs / "refiner", "coarse": runs / "coarse"}).inference_cfg,
        n_refiner_iterations=5)
    candidates = []
    pipeline = mv._pipeline_candidates
    mv._pipeline_candidates = lambda *a: candidates.append(pipeline(*a)) or candidates[-1]
    inputs = _KernelInputs()
    try:
        with _MultiviewProbe() as probe, inputs:
            rf.launches = 0
            rc, t = _timed(lambda: mv.main([
                "--out-dir", str(root / "multiview_checkpoints"), "--models-dir",
                str(scene / "models"), "--scenes-dir", str(scene / "scenes"), "--checkpoints",
                str(runs), "--device", str(dev)]))
            n = rf.launches
    finally:
        mv._pipeline_candidates = pipeline
    expected = _runner_launches((D, _frame_launches(icfg, D, icfg.SO3_grid_size))
                                for D in n_per_view)
    launches[f"run_multiview_eval --checkpoints ({MV_VIEWS} views)"] = n
    (preds,) = candidates
    log(f"run_multiview_eval --checkpoints (phase 24's runs): {t:.2f} s, launches {n} (expected "
        f"{expected}), {sum(len(r['poses']) for r in preds.values())} candidates; scene "
        f"reconstructed: {rc == 0} (rc {rc}; BA loss "
        f"{[s['loss'] for s in probe.solves]})")
    assert rc in (0, 1) and n == expected and len(preds) == MV_VIEWS
    assert all(np.isfinite(r["poses"]).all() and len(r["poses"]) == D
               for r, D in zip(preds.values(), n_per_view))
    _check_new_shapes("multiview_checkpoints", inputs, kernel)

    est = load_named_model("cosypose-RGB", db, device=dev)
    cfg = NAMED_MODELS["cosypose-RGB"].inference_cfg
    inputs = _KernelInputs()
    with inputs:
        rf.launches = 0
        preds, t = _timed(lambda: mv._pipeline_candidates(obs, est, db, dev))
        n = rf.launches
    expected = _runner_launches((D, _frame_launches(cfg, D)) for D in n_per_view)
    launches[f"_pipeline_candidates cosypose-RGB ({MV_VIEWS} views)"] = n
    assert n == expected and all(np.isfinite(r["poses"]).all() for r in preds.values())
    poses = [p for v in sorted(preds) for p in preds[v]["poses"]]
    cands = MultiviewCandidates(
        poses=np.asarray(poses, np.float32),
        view_ids=np.concatenate([np.full(len(preds[v]["poses"]), i) for i, v in enumerate(sorted(preds))]),
        obj_ids=np.concatenate([preds[v]["obj_ids"] for v in sorted(preds)]),
        scores=np.ones(len(poses), np.float32))
    state = MultiviewScenePredictor(
        db.batched(n_points=128, device=dev), score_th=0.0, n_ransac_iter=30, n_min_inliers=2,
        device=dev).predict_scene_state(cands, np.stack([o.K for o in obs]))
    log(f"_pipeline_candidates cosypose-RGB (seeded, full width): {t:.2f} s for {MV_VIEWS} "
        f"views, launches {n} (expected {expected}), {len(poses)} candidates; scene "
        f"reconstructed: {state is not None}"
        + (f" ({len(state.obj_ids)} objects, BA loss {state.ba_loss:.4g})" if state else ""))
    _check_new_shapes("multiview_cosypose", inputs, kernel)
    return launches


def phase_multiview_record_dr(dev, root: Path, scene: Path, kernel: dict) -> dict:
    """`run_multiview_eval --record-dr 2 --n-views 4` with the synthesized
    scene's models: 2 launches a recorder batch."""
    from happypose_tpu_torch.datasets.scene_record import BatchedSceneRecorder
    from happypose_tpu_torch.ops import rasterizer_fused as rf
    from happypose_tpu_torch.scripts import run_multiview_eval as mv

    out = root / "multiview_dr"
    batches = []
    record_batch = BatchedSceneRecorder.record_batch
    BatchedSceneRecorder.record_batch = lambda self, *a: batches.append(1) or record_batch(self, *a)
    inputs = _KernelInputs()
    try:
        with _MultiviewProbe() as probe, inputs:
            rf.launches = 0
            rc, t = _timed(lambda: mv.main([
                "--out-dir", str(out), "--record-dr", "2", "--n-views", str(MV_VIEWS),
                "--models-dir", str(scene / "models"), "--device", str(dev)]))
            n = rf.launches
    finally:
        BatchedSceneRecorder.record_batch = record_batch
    n_written = len([d for d in (out / "scenes").iterdir() if d.is_dir()])
    summary = (json.loads((out / "multiview_summary.json").read_text())
               if (out / "multiview_summary.json").exists() else None)
    log(f"run_multiview_eval --record-dr 2 --n-views {MV_VIEWS}: {t:.2f} s, launches {n} in "
        f"{len(batches)} recorder batches (2 a batch), {n_written} scenes written; matching "
        f"{_fmt(probe.match_s) if probe.match_s else '-'} s, BA "
        f"{_fmt(probe.ba_s) if probe.ba_s else '-'} s; rc {rc}, summary {json.dumps(summary)}")
    assert n == 2 * len(batches) and len(batches) >= 1 and n_written == 2 and rc in (0, 1)
    _check_new_shapes("multiview_record_dr", inputs, kernel)
    return {f"run_multiview_eval --record-dr 2 ({len(batches)} batches)": n}


def _mv_models(models: Path, src: Path) -> None:
    """The synthesized scene's models, the sphere declared symmetric about z."""
    import shutil

    shutil.copytree(src, models)
    info = json.loads((models / "models_info.json").read_text())
    info["1"]["symmetries_continuous"] = [{"axis": [0, 0, 1], "offset": [0, 0, 0]}]
    (models / "models_info.json").write_text(json.dumps(info))


def _large_scene(n_views=BA_VIEWS, n_objects=BA_OBJECTS, seed=0):
    """A T-LESS-sized scene: n_objects on a 5 x 3 grid (object o of model o
    % 3: the sphere and the two boxes of the synthesized scene), n_views
    cameras on an arc 0.7 m from the origin looking at it, every object in
    every view as ground truth + noise (0.01 rad, 2 mm; as
    tests/test_ba_schur.py)."""
    from scipy.spatial.transform import Rotation as ScipyRot

    from happypose_tpu_torch.lib3d.multiview_geom import look_at_R

    rng = np.random.RandomState(seed)
    TWO = np.tile(np.eye(4), (n_objects, 1, 1))
    TWO[:, :3, :3] = ScipyRot.random(n_objects, random_state=seed + 1).as_matrix()
    gx, gz = np.meshgrid(np.linspace(-0.2, 0.2, 5), np.linspace(-0.1, 0.1, 3))
    TWO[:, 0, 3], TWO[:, 2, 3] = gx.ravel()[:n_objects], gz.ravel()[:n_objects]
    TWO[:, :3, 3] += rng.uniform(-0.01, 0.01, (n_objects, 3))
    TWC = np.tile(np.eye(4), (n_views, 1, 1))
    for v in range(n_views):
        ang = 1.2 * (v / max(n_views - 1, 1) - 0.5)
        pos = np.asarray([0.7 * np.sin(ang), -0.2, -0.7 * np.cos(ang)])
        TWC[v, :3, :3] = look_at_R(torch.from_numpy(pos)[None], torch.zeros(1, 3, dtype=torch.float64),
                                   torch.tensor([[0.0, -1.0, 0.0]], dtype=torch.float64)).numpy()[0]
        TWC[v, :3, 3] = pos
    K = np.tile(np.asarray([[400.0, 0, 160], [0, 400.0, 120], [0, 0, 1]], np.float32), (n_views, 1, 1))
    poses, views, objs = [], [], []
    for v in range(n_views):
        for o in range(n_objects):
            noise = np.eye(4)
            noise[:3, :3] = ScipyRot.from_rotvec(rng.normal(0, 0.01, 3)).as_matrix()
            noise[:3, 3] = rng.normal(0, 0.002, 3)
            poses.append(np.linalg.inv(TWC[v]) @ TWO[o] @ noise)
            views.append(v)
            objs.append(o)
    return dict(TWO=TWO, TWC=TWC, K=K, poses=np.asarray(poses, np.float32),
                view_ids=np.asarray(views), obj_idx=np.asarray(objs),
                obj_ids=np.asarray(objs) % 3)


def _write_scenario(out: Path, models_src: Path, poses, view_ids, obj_ids, K) -> Path:
    """A scenario directory of `run_custom_scenario`: candidates (scores
    0.9, one outlier of score 0.1 that `--sv-score-th` drops), cameras."""
    from happypose_tpu_torch.evaluation.bop_export import save_bop_csv

    _mv_models(out / "models", models_src)
    T_bad = np.eye(4, dtype=np.float32)
    T_bad[:3, 3] = [0.5, 0.5, 2.0]
    save_bop_csv(out / "candidates.csv", np.concatenate([poses, T_bad[None]]),
                 np.append(obj_ids, obj_ids[0]), np.zeros(len(poses) + 1, int),
                 np.append(view_ids, view_ids[0]), np.append(np.full(len(poses), 0.9), 0.1))
    (out / "scene_camera.json").write_text(json.dumps(
        {str(v): {"cam_K": K[i].reshape(-1).tolist()} for i, v in enumerate(np.unique(view_ids))}))
    return out


def phase_custom_scenario(dev, root: Path, scene: Path) -> dict:
    """`run_custom_scenario` at its defaults (200 RANSAC iterations, 256
    points, 64 symmetry slots, 10 BA iterations, NMS at 4 cm) on the card:
    on a scenario from the synthesized scene (its ground truth + noise) and
    on the T-LESS-sized scene (8 views x 15 objects, 5 of each model: 64
    tentative matches a view pair, so 200 hypotheses x 64 slots x 256
    points). Seconds and peak memory of each."""
    from scipy.spatial.transform import Rotation as ScipyRot

    from happypose_tpu_torch.evaluation.bop_export import load_bop_csv
    from happypose_tpu_torch.ops import rasterizer_fused as rf
    from happypose_tpu_torch.scripts import run_custom_scenario

    db, obs = _scene_observations(scene)
    rng = np.random.RandomState(2)
    poses, views, objs = [], [], []
    for v, o in enumerate(obs):
        for label, T in zip(o.obj_labels, o.TWO):
            noise = np.eye(4)
            noise[:3, :3] = ScipyRot.from_rotvec(rng.normal(0, 0.01, 3)).as_matrix()
            noise[:3, 3] = rng.normal(0, 0.002, 3)
            poses.append(T @ noise)
            views.append(v * 10)
            objs.append(int(label.split("_")[1]))
    big = _large_scene()
    scenarios = {
        "synthesized scene": (_write_scenario(root / "scenario_mv", scene / "models",
                                              np.asarray(poses, np.float32), np.asarray(views),
                                              np.asarray(objs), np.stack([o.K for o in obs])),
                              len(set(objs))),
        f"{BA_VIEWS} views x {BA_OBJECTS} objects": (
            _write_scenario(root / "scenario_large", scene / "models", big["poses"],
                            big["view_ids"], big["obj_ids"] + 1, big["K"]), BA_OBJECTS),
    }
    figures = {}
    for name, (path, n_obj) in scenarios.items():
        with _MultiviewProbe() as probe:
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated() / 2**30  # held by earlier phases
            rf.launches = 0
            rc, t = _timed(lambda: run_custom_scenario.main(["--scenario", str(path), "--device",
                                                             str(dev)]))
            peak = torch.cuda.max_memory_allocated() / 2**30 - resident
        out = json.loads((path / "results" / "scene.json").read_text())
        rows = load_bop_csv(path / "results" / "poses.csv")
        figures[name] = {"s": t, "match_s": probe.match_s[0], "ba_s": probe.ba_s[0],
                         "peak_gib": peak, "launches": rf.launches}
        log(f"run_custom_scenario ({name}, defaults): {t:.2f} s (matching {probe.match_s[0]:.3f}, "
            f"BA {probe.ba_s[0]:.3f}), peak memory {peak:.2f} GiB above the {resident:.2f} GiB "
            f"resident before; {len(out['objects'])} objects "
            f"(of {n_obj}) in {len(out['cameras'])} views, {len(rows['poses'])} pose rows")
        assert rc == 0 and 1 <= len(out["objects"]) <= n_obj and rf.launches == 0
        assert np.isfinite(rows["poses"]).all()
        assert all(np.isfinite(o["TWO"]).all() for o in out["objects"])
    return figures


def _ba_refiner(big, meshes, solver, dev):
    from happypose_tpu_torch.multiview.bundle_adjustment import MultiviewRefinement

    return MultiviewRefinement(
        cand_TCO=big["poses"], cand_view_idx=big["view_ids"], cand_obj_idx=big["obj_idx"],
        cand_obj_ids=big["obj_ids"], K=big["K"], meshes=meshes, n_points=8, solver=solver,
        device=dev)


def phase_large_ba(dev, scene: Path) -> dict:
    """Dense and Schur BA of the 8 x 15 scene, 50 iterations from the chain
    of exact relative cameras (as `test_solvers_agree_end_to_end`): s/solve,
    s/LM step, accepted steps, the two solvers' losses; one LM step and the
    Schur blocks on the card against the CPU."""
    from happypose_tpu_torch.datasets.bop import BOPObjectDataset
    from happypose_tpu_torch.lib3d.transforms import T_to_pose9d, pose9d_to_T

    big = _large_scene()
    models = BOPObjectDataset(scene / "models").mesh_db.batched(n_points=64, device=dev)
    TWC = big["TWC"]
    pairs = [(v, v + 1) for v in range(BA_VIEWS - 1)]
    TC1C2 = np.stack([np.linalg.inv(TWC[a]) @ TWC[b] for a, b in pairs]).astype(np.float32)
    figures, results = {}, {}
    for solver in ("dense", "schur"):
        ref = _ba_refiner(big, models, solver, dev)
        losses = []
        loss = ref._loss
        ref._loss = lambda *a: losses.append(float(loss(*a))) or torch.tensor(losses[-1])
        ref.solve(pairs, TC1C2, n_iterations=2)  # warm-up
        losses.clear()
        results[solver], t = _timed(lambda: ref.solve(pairs, TC1C2, n_iterations=BA_ITERATIONS))
        del ref._loss
        accepted = sum(1 for i in range(1, len(losses)) if losses[i] < min(losses[:i]))
        step = ref._lm_step if solver == "dense" else ref._lm_step_schur
        TCW = torch.as_tensor(np.linalg.inv(TWC), dtype=torch.float32, device=dev)
        TWO = torch.as_tensor(big["TWO"], dtype=torch.float32, device=dev)
        params = torch.cat([T_to_pose9d(TWO).reshape(-1), T_to_pose9d(TCW).reshape(-1)])
        target = ref._align_targets(*ref._split(params))
        step_s = [_timed(lambda: step(params, target, 1e-3, 25.0))[1] for _ in range(10)]
        prof = _device_share(lambda: step(params, target, 1e-3, 25.0))
        figures[solver] = {"s_per_solve": t, "s_per_step": statistics.median(step_s),
                           "accepted_steps": accepted, "loss": results[solver]["loss"]}
        log(f"BA {solver} {BA_VIEWS} views x {BA_OBJECTS} objects ({len(big['poses'])} candidates, "
            f"8 points): {BA_ITERATIONS} iterations {t:.3f} s, loss {losses[0]:.4f} -> "
            f"{results[solver]['loss']:.4f}, {accepted} of {BA_ITERATIONS} steps accepted; "
            f"s/LM step {_fmt(step_s)}; one step: {prof}")
        assert math.isfinite(results[solver]["loss"])
        assert np.isfinite(results[solver]["TWO"]).all() and np.isfinite(results[solver]["TWC"]).all()

        # one step on the card against the CPU, from the same parameters and targets
        cpu = _ba_refiner(big, models.to("cpu"), solver, "cpu")
        cpu_step = cpu._lm_step if solver == "dense" else cpu._lm_step_schur
        for lambd in (1e-3, BA_STEP_LAMBDA):
            p_card, l_card = step(params, target, lambd, 25.0)
            p_cpu, l_cpu = cpu_step(params.cpu(), target.cpu(), lambd, 25.0)
            d_pose = (pose9d_to_T(p_card.reshape(-1, 9)).cpu() -
                      pose9d_to_T(p_cpu.reshape(-1, 9))).abs().max().item()
            d_loss = abs(float(l_card) - float(l_cpu)) / abs(float(l_cpu))
            log(f"BA {solver} one LM step at lambda {lambd:g}, card vs cpu: poses max diff "
                f"{d_pose:.3g}, loss rel diff {d_loss:.3g}")
            assert d_loss <= 1e-5
            if lambd == BA_STEP_LAMBDA:
                assert d_pose <= BA_STEP_ATOL, d_pose
        if solver == "schur":
            card = ref._cand_blocks(params, target, ref.o_idx, ref.v_idx, ref.cand_points,
                                    ref.cand_weight, 25.0)
            host = cpu._cand_blocks(params.cpu(), target.cpu(), cpu.o_idx, cpu.v_idx,
                                    cpu.cand_points, cpu.cand_weight, 25.0)
            rel = max(((a.cpu() - b).abs().max() / b.abs().max()).item() for a, b in zip(card, host))
            log(f"BA Schur blocks card vs cpu: max diff {rel:.3g} of the largest entry")
            assert rel <= BA_BLOCKS_REL
    r_d, r_s = results["dense"]["loss"], results["schur"]["loss"]
    log(f"BA dense vs schur at {BA_VIEWS} x {BA_OBJECTS}: loss {r_d:.4f} vs {r_s:.4f}")
    assert r_s < max(2.0 * r_d, 1.0), (r_d, r_s)
    return figures

# ------------------------------------------- the other backbones and the tools

BACKBONE_TRAINING = (  # (backbone, role, compute dtype)
    ("efficientnet_b3", "refiner", "float32"),
    ("efficientnet_b3", "coarse", "float32"),
    ("efficientnet_b3", "refiner", "bfloat16"),
    ("flownet", "refiner", "float32"),
)
# `run_pose_training` with the new backbones: epochs, epoch size, batch
BB_CLI_EPOCHS, BB_CLI_EPOCH_SIZE, BB_CLI_BATCH = 1, 16, 8
# `run_accuracy_demo` at megapose-RGB's width: 16 scenes in one batch,
# the 576-rotation grid, top-5, 5 refiner iterations
DEMO_SCENES, DEMO_BATCH, DEMO_GRID, DEMO_HYPOTHESES, DEMO_ITERATIONS = 16, 16, 576, 5, 5


def phase_backbone_training(dev) -> tuple:
    """Training at full width with the other backbones: EfficientNet-B3 as
    refiner (240x320 renders, 480x640 images, B = 16, 3 iterations) and as
    coarse grid classifier (B = 8 x 8), both in float32, the refiner in
    bfloat16 too, and the FlowNetS refiner; TRAIN_STEPS steps each from
    seeded weights (phase 20's world with the backbone swapped): launches a
    step asserted, finite losses, no skipped step; s/step of steps 2-6,
    samples/s, peak memory, one step under the profiler. Then the cut
    EfficientNet-B3 refiner on the card against the CPU (its CUT_LIMITS).
    Returns ({case: figures}, {path: launches})."""
    figures, launches = {}, {}
    for backbone, role, dtype in BACKBONE_TRAINING:
        n_steps = TRAIN_STEPS
        per_step = 1 + REFINER_ITERATIONS if role == "refiner" else 2
        w = _train_world(dev, role, backbone=backbone, B=TRAIN_BATCH[role], compute_dtype=dtype)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k0 = _synth_keys()
        metrics, times, data_times, n_launch = _train_steps(w, n_steps)
        expected = _step_launches(per_step, n_steps, _synth_keys() - k0)
        peak = torch.cuda.max_memory_allocated() / 2**30
        s_step = statistics.median(times[1:])
        name = f"{backbone} {role} {dtype}"
        figures[name] = {"s_per_step": s_step, "samples_per_s": w.B / s_step, "peak_gib": peak,
                         "s_batch": statistics.median(data_times[1:])}
        log(f"train {name} full width (render {RES}, images {FRAME_RES}, B={w.B}"
            f"{', 3 iterations' if role == 'refiner' else f', {GRID_HYPOTHESES} hypotheses'}): "
            f"wrapper launches a step {n_launch}, expected {expected}; loss "
            f"{[round(m['loss'], 5) for m in metrics]}, grad_norm "
            f"{[round(m['grad_norm'], 3) for m in metrics]}; s/step (steps 2-{n_steps}, batch "
            f"included) {_fmt(times[1:])}, of it the synthetic batch "
            f"{figures[name]['s_batch']:.4f}; {figures[name]['samples_per_s']:.1f} samples/s; "
            f"peak memory {peak:.2f} GiB; first step {times[0]:.3f} s")
        assert n_launch == expected, f"{name}: launches {n_launch}"
        assert all(math.isfinite(m["loss"]) and m["loss"] > 0 for m in metrics)
        assert all(m["skipped_nonfinite"] == 0 for m in metrics)
        launches[f"train {name} ({n_steps} steps)"] = sum(n_launch)
        log(f"train {name}: " + _step_profile(w, n_steps, per_step))
        del w
    launches["train cut cuda efficientnet_b3 (1 step)"] = phase_training_cross_check(
        dev, backbone="efficientnet_b3")
    return figures, launches


class _StageClock:
    """While active, the seconds of each `PoseEstimator` stage call (coarse
    scoring, refiner, re-scoring; host clock around synchronized work)."""

    STAGES = ("forward_coarse", "forward_refiner", "forward_scoring")

    def __init__(self):
        self.seconds = {k: [] for k in self.STAGES}
        self.last_call = {}

    def __enter__(self):
        from happypose_tpu_torch.inference.pose_estimator import PoseEstimator

        self._saved = {k: getattr(PoseEstimator, k) for k in self.STAGES}
        for k, fn in self._saved.items():
            def timed(est, *a, _fn=fn, _k=k, **kw):
                out, t = _timed(lambda: _fn(est, *a, **kw))
                self.seconds[_k].append(t)
                self.last_call[_k] = (_fn, est, a, kw)
                return out
            setattr(PoseEstimator, k, timed)
        return self

    def __exit__(self, *exc):
        from happypose_tpu_torch.inference.pose_estimator import PoseEstimator

        for k, fn in self._saved.items():
            setattr(PoseEstimator, k, fn)


def phase_backbone_serving(dev, root: Path, kernel: dict) -> dict:
    """From training to serving with the other backbones: `run_pose_training
    --backbone efficientnet_b3` writes a refiner and a coarse run directory
    and `--backbone flownet` a refiner (240x320 renders, 480x640 images,
    2 steps each), then `run_accuracy_demo` at megapose-RGB's width reads
    them: EfficientNet-B3 refiner + coarse (576-rotation grid, top-5, 5
    iterations; 1 + 32 + 1 launches a batch of 16 scenes, + 2 x 5 for the
    refiner's stage graph in the first) and the FlowNetS refiner alone (the
    CosyPose flavour: 1 a batch, + 2 x 5 in the first). Seconds a batch,
    the stage split, peak memory; every shape the demo launches at is held
    to the plain version with the demo's own inputs."""
    from happypose_tpu_torch.ops import rasterizer_fused as rf
    from happypose_tpu_torch.scripts import run_accuracy_demo, run_pose_training

    runs = root / "backbone_runs"
    common = ["--data", "synth", "--synth-set", "textured", "--epochs", str(BB_CLI_EPOCHS),
              "--epoch-size", str(BB_CLI_EPOCH_SIZE), "--batch-size", str(BB_CLI_BATCH),
              "--render-size", *map(str, RES), "--image-size", *map(str, FRAME_RES),
              "--device", str(dev)]
    n_steps = BB_CLI_EPOCHS * (BB_CLI_EPOCH_SIZE // BB_CLI_BATCH)
    launches = {}
    for name, extra, per_step in (
            ("b3_refiner", ["--backbone", "efficientnet_b3", "--n-iterations", "2"], 2),
            ("b3_coarse", ["--backbone", "efficientnet_b3", "--model-type", "coarse"], 1),
            ("flownet_refiner", ["--backbone", "flownet", "--n-iterations", "2"], 2)):
        rf.launches, k0 = 0, _synth_keys()
        rc, t = _timed(lambda: run_pose_training.main(["--run-dir", str(runs / name)] + common + extra))
        expected = _graph_launches(per_step, 1) + _graph_launches(1, _synth_keys() - k0)
        launches[f"run_pose_training {name} ({n_steps} steps)"] = rf.launches
        lines = [json.loads(x) for x in (runs / name / "log.txt").read_text().splitlines()]
        log(f"run_pose_training {name}: {t:.2f} s, {n_steps} steps, wrapper launches "
            f"{rf.launches} (expected {expected}); loss {[round(x['loss'], 4) for x in lines]}")
        assert rc == 0 and rf.launches == expected and len(lines) == BB_CLI_EPOCHS
        assert all(math.isfinite(x["loss"]) and x["skipped_nonfinite"] == 0 for x in lines)

    from happypose_tpu_torch.inference.types import InferenceConfig

    n_batches = DEMO_SCENES // DEMO_BATCH
    icfg = InferenceConfig(n_refiner_iterations=DEMO_ITERATIONS, n_pose_hypotheses=DEMO_HYPOTHESES,
                           SO3_grid_size=DEMO_GRID)
    demo_args = ["--image-size", *map(str, FRAME_RES), "--so3-grid", str(DEMO_GRID),
                 "--n-hypotheses", str(DEMO_HYPOTHESES), "--n-refiner-iterations",
                 str(DEMO_ITERATIONS), "--batch-size", str(DEMO_BATCH), "--n-scenes",
                 str(DEMO_SCENES), "--synth-set", "textured"]
    figures = {}
    # the textured set's shapes are held with the demo's own inputs (the debug
    # mesh's rows of phase 3 share their batch and resolution only), but for
    # the batch of scenes, phase 3's training row
    held = {(TRAIN_BATCH["refiner"], FRAME_RES)}
    # a batch: its scenes (the synthetic batch's graph: a new key's warm-up
    # and capture, else a replay), then the pipeline on one detection a scene,
    # whose refiner chunks capture their stage graphs in the first batch and
    # replay them after (`once`)
    for name, dirs, per_batch, once in (
            ("efficientnet_b3 refiner + coarse",
             ["--refiner-dir", str(runs / "b3_refiner"), "--coarse-dir", str(runs / "b3_coarse")],
             _eager_launches(icfg, DEMO_BATCH, DEMO_GRID),
             _stage_launches(icfg, [(DEMO_BATCH * DEMO_HYPOTHESES, DEMO_ITERATIONS)])),
            ("flownet refiner", ["--refiner-dir", str(runs / "flownet_refiner")], 0,
             _stage_launches(icfg, [(DEMO_BATCH, DEMO_ITERATIONS)]))):
        out = root / "accuracy_demo.json"
        inputs = _KernelInputs()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated() / 2**30
        with _StageClock() as clock, inputs:
            rf.launches, k0 = 0, _synth_keys()
            rc, t = _timed(lambda: run_accuracy_demo.main(
                dirs + demo_args + ["--out", str(out), "--device", str(dev)]))
            n = rf.launches
            captures = _graph_launches(1, _synth_keys() - k0) + once
        peak = torch.cuda.max_memory_allocated() / 2**30 - resident
        summary = json.loads(out.read_text())
        stages = {k: round(sum(v) / n_batches, 4) for k, v in clock.seconds.items() if v}
        figures[name] = {"s_per_batch": t / n_batches, "stages_s_per_batch": stages,
                         "peak_gib": peak, "launches": n}
        launches[f"run_accuracy_demo {name} ({n_batches} batches of {DEMO_BATCH})"] = n
        log(f"run_accuracy_demo {name}: {t:.2f} s for {n_batches} batches of {DEMO_BATCH} scenes "
            f"({t / n_batches:.3f} s a batch, models loaded and first calls included); stage "
            f"seconds a batch {stages}; peak memory {peak:.2f} GiB above the resident; launches "
            f"{n} (expected {per_batch * n_batches + captures}); summary {json.dumps(summary)}")
        assert rc == 0 and n == per_batch * n_batches + captures, (n, per_batch * n_batches + captures)
        assert summary["n_scenes"] == DEMO_SCENES
        # what bounds the slowest stage: its last call again, under the profiler
        stage = max(stages, key=stages.get)
        fn, est, a, kw = clock.last_call[stage]
        log(f"run_accuracy_demo {name}: one {stage} call of a batch, profiled: "
            + _profile(lambda: fn(est, *a, **kw))[0])
        assert all(math.isfinite(v) for v in summary.values() if isinstance(v, float))
        _check_new_shapes("accuracy_demo_textured", inputs, kernel, held=held)
    return {"figures": figures, "launches": launches}


def phase_host_tools(dev, root: Path) -> None:
    """The host tools on the card's machine: a DeepIM-ModelNet tree written
    with the port's PNG writer and read back through `make_scene_dataset`;
    `preprocess_object_dataset` (scale, pointclouds, stats, subset) on the
    meshes of the "textured" training set; `download` from a local mirror
    written here (a symlink, then a copy; no mirror: exit code 2);
    `log_memory` and `get_device_memory` on the card."""
    import logging

    import os

    from happypose_tpu_torch.datasets.datasets_cfg import make_scene_dataset
    from happypose_tpu_torch.datasets.deepim_modelnet import DeepImModelNetDataset
    from happypose_tpu_torch.meshes.io import load_ply, save_ply
    from happypose_tpu_torch.scripts import download, preprocess_object_dataset
    from happypose_tpu_torch.training.synth_data import make_synth_mesh_db
    from happypose_tpu_torch.utils.png import write_png
    from happypose_tpu_torch.utils.resources import get_device_memory, log_memory

    t0 = time.perf_counter()
    data = root / "modelnet" / "modelnet_render_v1" / "data"
    (root / "modelnet" / "model_set").mkdir(parents=True)
    (root / "modelnet" / "model_set" / "chair_test.txt").write_text("chair_0001\nchair_0002\n")
    rs = np.random.RandomState(0)
    written = []
    for obj in ("chair_0001", "chair_0002"):
        for im in range(2):
            stem = f"{obj}_{im:04d}"
            rgb = rs.randint(0, 255, (480, 640, 3)).astype(np.uint8)
            depth = (rs.rand(480, 640) * 2000).astype(np.uint16)
            label = np.zeros((480, 640), np.uint8)
            label[100 + im:300, 200:500] = 1
            T = np.eye(4)
            T[:3, 3] = [0.01 * im, 0.0, 0.8]
            for sub, suffix in (("real", ""), ("rendered", "_0")):
                d = data / sub / "chair" / "test"
                d.mkdir(parents=True, exist_ok=True)
                (d / f"{stem}{suffix}-pose.txt").write_text(
                    "\n".join(" ".join(str(x) for x in T[r]) for r in range(3)))
            d = data / "real" / "chair" / "test"
            write_png(d / f"{stem}-color.png", rgb)
            write_png(d / f"{stem}-depth.png", depth)
            write_png(d / f"{stem}-label.png", label)
            written.append((rgb, depth, T))
    ds = make_scene_dataset("deepim.modelnet-chair-test", data_dir=root, load_depth=True)
    assert isinstance(ds, DeepImModelNetDataset) and np.array_equal(ds[0].rgb, written[0][0])
    ds = DeepImModelNetDataset(root / "modelnet", "chair", n_images_per_object=2, load_depth=True)
    for (rgb, depth, T), obs in zip(written, (ds[i] for i in range(len(ds)))):
        assert np.array_equal(obs.rgb, rgb)
        assert np.array_equal(obs.depth, depth.astype(np.float32) / 1000.0)
        assert np.allclose(obs.TWO[0], T) and np.allclose(obs.TWO_init[0], T)
    log(f"DeepIM-ModelNet tree: {len(ds)} frames 480x640 written with the port's PNG writer and "
        f"read back (make_scene_dataset): rgb, depth (mm -> m), poses equal, boxes "
        f"{[ds[i].bboxes[0].tolist() for i in range(2)]}")

    meshes = root / "tool_meshes"
    (meshes / "sub").mkdir(parents=True)
    for label, mesh in make_synth_mesh_db("textured").meshes.items():
        save_ply(meshes / ("sub" if label == "box" else "") / f"{label}.ply", mesh)
    out = root / "tool_out"
    assert preprocess_object_dataset.main(["scale", "--in-dir", str(meshes), "--out-dir",
                                           str(out / "scaled"), "--target-diameter", "0.2"]) == 0
    assert preprocess_object_dataset.main(["pointclouds", "--in-dir", str(meshes), "--out-dir",
                                           str(out / "pc"), "--n-points", "2000"]) == 0
    assert preprocess_object_dataset.main(["stats", "--in-dir", str(meshes), "--out",
                                           str(out / "stats.json")]) == 0
    assert preprocess_object_dataset.main(["subset", "--stats", str(out / "stats.json"), "--out",
                                           str(out / "subset.json"), "--max-faces", "100"]) == 0
    stats = json.loads((out / "stats.json").read_text())
    diameters = [load_ply(p).diameter for p in sorted((out / "scaled").rglob("*.ply"))]
    with np.load(out / "pc" / "sphere.npz") as pc:
        radius = np.linalg.norm(pc["points"], axis=-1)
    subset = json.loads((out / "subset.json").read_text())
    log(f"preprocess_object_dataset: stats {stats}; scaled diameters {diameters}; 2000 points on "
        f"the sphere at radius {radius.min():.4f}-{radius.max():.4f}; subset --max-faces 100 "
        f"{subset}")
    assert sorted(stats) == ["sphere.ply", "sub/box.ply"]
    assert all(abs(d - 0.2) < 1e-5 for d in diameters) and len(diameters) == 2
    assert np.allclose(radius, 0.04, atol=1e-3) and subset == ["sub/box.ply"]

    mirror = root / "mirror"
    (mirror / "examples" / "demo").mkdir(parents=True)
    (mirror / "examples" / "demo" / "f.txt").write_text("x")
    base = ["--examples", "demo", "--mirror", str(mirror)]
    assert download.main(base + ["--data-dir", str(root / "dl_link")]) == 0
    assert download.main(base + ["--data-dir", str(root / "dl_copy"), "--copy"]) == 0
    env = os.environ.pop(download.MIRROR_ENV, None)
    try:
        assert download.main(["--examples", "demo", "--data-dir", str(root / "dl_none")]) == 2
    finally:
        if env is not None:
            os.environ[download.MIRROR_ENV] = env
    link, copy = root / "dl_link" / "examples" / "demo", root / "dl_copy" / "examples" / "demo"
    assert link.is_symlink() and not copy.is_symlink()
    assert (link / "f.txt").read_text() == (copy / "f.txt").read_text() == "x"
    log("download: linked and copied examples/demo from a local mirror")

    logger = logging.getLogger("chip_smoke.resources")
    logger.addHandler(logging.StreamHandler(sys.stdout))
    logger.setLevel(logging.INFO)
    log_memory(logger, prefix="log_memory: ")
    memory = get_device_memory()
    log(f"get_device_memory: {memory}")
    assert 0 < memory["bytes_in_use_gib"] <= memory["bytes_limit_gib"] < 200
    log(f"host tools: {time.perf_counter() - t0:.1f} s")


# ------------------------------------------- the sharded paths (world size 1)

SHARD_LOGIT_REL = 1e-5  # coarse logits, sharded vs serial, of the largest |logit|
# `run_pose_training --dp` against the run without, on the first step (the same parameters,
# batch and draws): the first iteration's loss to DP_ITER1_RTOL (the same renders; the synced
# BatchNorm merges its statistics in another order than cuDNN's), the step's loss and
# gradient norm to DP_LOSS_RTOL / DP_GRAD_NORM_RTOL: iterations 2 and 3 render poses that
# differ in the last bits, which can move an edge pixel (as `CUT_STATS_RTOL`), and cuDNN's
# backward sums in an order of its own (`CUT_HEAD_REL`)
DP_ITER1_RTOL = 1e-5
DP_LOSS_RTOL = 1e-3
DP_GRAD_NORM_RTOL = 1e-3
DP_STEPS = 3  # steps of `run_pose_training` with and without --dp, one an epoch


def _median_timed(fn, n=3):
    """Host seconds of `n` synchronized calls of `fn` after one warm-up call."""
    _timed(fn)
    return [_timed(fn)[1] for _ in range(n)]


def phase_sharded(dev, root: Path, scene: Path) -> dict:
    """The sharded paths on an NCCL process group of one rank, made by
    `make_mesh` (`init_distributed_mode` joins nothing at WORLD_SIZE 1), at
    full width, each beside its unsharded counterpart:
    (a) megapose-RGB with `PoseEstimator(device_mesh=...)`: the coarse
    logits equal the serial path's, the top-5 sets are the same, 4 launches
    at B = 288 in the coarse stage and the whole frame's count;
    (b) `run_pose_training --dp` at phase 20's width (480x640, B = 16, 3
    iterations, ResNet34 refiner, 3 steps) against the same run without
    `--dp`: loss and gradient norm; only rank 0 writes; then the same under
    `torchrun --standalone --nproc-per-node 1`;
    (c) `schur_sharded` bundle adjustment of the 8 x 15 scene against
    `schur`: one LM step's poses and the solve's outcome;
    (d) a render through the object-sharded `select` against the whole
    database's. Times are medians of 3 after a warm-up, on the host clock
    around synchronized calls."""
    import os

    from happypose_tpu_torch.datasets.bop import BOPObjectDataset
    from happypose_tpu_torch.inference.pose_estimator import PoseEstimator
    from happypose_tpu_torch.lib3d.transforms import T_to_pose9d, pose9d_to_T
    from happypose_tpu_torch.meshes import io
    from happypose_tpu_torch.meshes.database import MeshDataBase
    from happypose_tpu_torch.ops import rasterizer_fused as rf
    from happypose_tpu_torch.parallel import make_mesh
    from happypose_tpu_torch.parallel.mesh import pad_objects_to_multiple, shard_objects
    from happypose_tpu_torch.scripts import run_pose_training

    import torch.distributed as dist

    card = card_line()
    mesh = make_mesh((1,), ("hp",))
    log(f"sharded: process group {dist.get_backend()} of {dist.get_world_size()} rank(s), "
        f"mesh {mesh}; {card}")
    assert dist.get_backend() == {"cuda": "nccl", "cpu": "gloo"}[dev.type]
    launches, figures = {}, {}

    # (a) megapose-RGB, coarse hypotheses split over the mesh axis
    db = debug_mesh_db(MeshDataBase, io)
    obs, det = _synthetic_frame(db, dev)
    est = _load("megapose-RGB", db, dev)
    sharded = PoseEstimator(est.refiner_model, est.coarse_model, est.assets, est.meshes, est.cfg,
                            device_mesh=mesh, mesh_axis="hp")
    D, M = det.n_rows, est.SO3_grid.shape[0]
    sharded.forward_coarse(obs, det)
    torch.cuda.synchronize()
    rf.launches = 0
    coarse_sh = sharded.forward_coarse(obs, det)
    torch.cuda.synchronize()
    launches["megapose-RGB sharded coarse stage (world 1)"] = n_coarse = rf.launches
    coarse = est.forward_coarse(obs, det)
    expected = math.ceil(M * D / est.cfg.bsz_images)
    a, b = coarse_sh.coarse_logits, coarse.coarse_logits
    d_logit = ((a - b).abs().max() / b.abs().max()).item()
    top_sh = a.reshape(D, M).topk(est.cfg.n_pose_hypotheses, dim=1).indices.sort(dim=1).values
    top = b.reshape(D, M).topk(est.cfg.n_pose_hypotheses, dim=1).indices.sort(dim=1).values
    log(f"sharded megapose-RGB coarse: {n_coarse} launches at B = {est.cfg.bsz_images} "
        f"(expected {expected}), logits sharded vs serial max diff {d_logit:.3g} of the largest "
        f"(bit-equal: {torch.equal(a, b)}), top-{est.cfg.n_pose_hypotheses} sets equal: "
        f"{torch.equal(top_sh, top)}")
    assert n_coarse == expected and d_logit <= SHARD_LOGIT_REL and torch.equal(top_sh, top)
    rf.launches = 0
    res = sharded.run_inference_pipeline(obs, det)
    torch.cuda.synchronize()
    launches["megapose-RGB sharded frame (world 1)"] = n_frame = rf.launches
    assert n_frame == _eager_launches(est.cfg, D, M, first=True), n_frame
    final = res["final"]
    assert torch.isfinite(final.poses).all() and int(final.valid.sum()) == D
    t_sh = _median_timed(lambda: sharded.forward_coarse(obs, det))
    t_serial = _median_timed(lambda: est.forward_coarse(obs, det))
    f_sh = _median_timed(lambda: sharded.run_inference_pipeline(obs, det))
    f_serial = _median_timed(lambda: est.run_inference_pipeline(obs, det))
    figures["megapose_coarse_s"] = {"sharded": t_sh, "serial": t_serial}
    figures["megapose_frame_s"] = {"sharded": f_sh, "serial": f_serial}
    log(f"sharded megapose-RGB ({card}): coarse stage s {_fmt(t_sh)} vs serial {_fmt(t_serial)}; "
        f"frame s/image {_fmt(f_sh)} vs serial {_fmt(f_serial)}; frame launches {n_frame}")
    del est, sharded

    # (b) run_pose_training --dp at phase 20's width, one step an epoch: the
    # log's first line is the first step's, taken from the same parameters
    runs = root / "dp_runs"
    common = ["--backbone", "resnet34", "--data", "synth", "--synth-set", "textured",
              "--epochs", str(DP_STEPS), "--epoch-size", str(TRAIN_BATCH["refiner"]),
              "--batch-size", str(TRAIN_BATCH["refiner"]), "--n-iterations",
              str(REFINER_ITERATIONS), "--render-size", *map(str, RES),
              "--image-size", *map(str, FRAME_RES), "--device", str(dev)]
    logs, seconds = {}, {}
    for name, extra in (("single", []), ("dp", ["--dp"])):
        rf.launches, k0 = 0, _synth_keys()
        rc, seconds[name] = _timed(lambda: run_pose_training.main(
            ["--run-dir", str(runs / name)] + common + extra))
        launches[f"run_pose_training {name} ({DP_STEPS} steps)"] = rf.launches
        # the step's key (--dp: its NCCL collectives captured with it) and the
        # synthetic batch's new ones: warm-up and capture; the later steps replay
        expected = (_graph_launches(REFINER_ITERATIONS, 1)
                    + _graph_launches(1, _synth_keys() - k0))
        assert rc == 0 and rf.launches == expected, (rf.launches, expected)
        logs[name] = [json.loads(x) for x in (runs / name / "log.txt").read_text().splitlines()]
        assert len(logs[name]) == DP_STEPS
        assert all(math.isfinite(x["loss"]) and x["skipped_nonfinite"] == 0 for x in logs[name])
    assert dist.is_initialized(), "run_pose_training destroyed a group it did not make"
    first = {k: logs[k][0] for k in logs}
    d_loss = abs(first["dp"]["loss"] - first["single"]["loss"]) / abs(first["single"]["loss"])
    d_gn = abs(first["dp"]["grad_norm"] - first["single"]["grad_norm"]) / first["single"]["grad_norm"]
    it1 = "loss_TCO_iter1"
    d_it1 = abs(first["dp"][it1] - first["single"][it1]) / abs(first["single"][it1])
    written = sorted(x.name for x in (runs / "dp").iterdir())
    step_s = {k: [x["time"] for x in logs[k][1:]] for k in logs}  # the first step warms up
    figures["dp_train_s_per_step"] = step_s
    log(f"run_pose_training --dp ({card}): s/step {_fmt(step_s['dp'])} vs without "
        f"{_fmt(step_s['single'])} (steps 2-{DP_STEPS}); whole runs {seconds['dp']:.2f} s vs "
        f"{seconds['single']:.2f} s; first step: iteration 1's loss rel diff {d_it1:.3g}, loss "
        f"{first['dp']['loss']:.6f} vs "
        f"{first['single']['loss']:.6f} (rel {d_loss:.3g}), grad_norm {first['dp']['grad_norm']:.5f} "
        f"vs {first['single']['grad_norm']:.5f} (rel {d_gn:.3g}); later steps' losses "
        f"{[round(x['loss'], 6) for x in logs['dp'][1:]]} vs "
        f"{[round(x['loss'], 6) for x in logs['single'][1:]]} (after Adam's first steps, about "
        f"lr x sign(g), not compared); rank 0 wrote {written}")
    assert d_it1 <= DP_ITER1_RTOL and d_loss <= DP_LOSS_RTOL and d_gn <= DP_GRAD_NORM_RTOL
    assert "state_dict.pt" in written

    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "1",
         "-m", "happypose_tpu_torch.scripts.run_pose_training", "--run-dir",
         str(runs / "torchrun"), "--dp"] + common + ["--epochs", "1"], capture_output=True,
        text=True, env=env,
        cwd=str(ROOT), timeout=300)
    t_torchrun = time.perf_counter() - t0
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    tr_log = json.loads((runs / "torchrun" / "log.txt").read_text().splitlines()[0])
    d_tr = abs(tr_log["loss"] - first["single"]["loss"]) / abs(first["single"]["loss"])
    log(f"torchrun --standalone --nproc-per-node 1 run_pose_training --dp: {t_torchrun:.1f} s "
        f"(process start included), first step loss {tr_log['loss']:.6f} (rel {d_tr:.3g} of the "
        "run without --dp)")
    assert d_tr <= DP_LOSS_RTOL

    # (c) schur_sharded bundle adjustment at 8 views x 15 objects
    big = _large_scene()
    models = BOPObjectDataset(scene / "models").mesh_db.batched(n_points=64, device=dev)
    pairs = [(v, v + 1) for v in range(BA_VIEWS - 1)]
    TWC = big["TWC"]
    TC1C2 = np.stack([np.linalg.inv(TWC[a]) @ TWC[b] for a, b in pairs]).astype(np.float32)
    ba_mesh = make_mesh((1,), ("ba",))
    schur = _ba_refiner(big, models, "schur", dev)
    sh = dataclasses.replace(schur, solver="schur_sharded", device_mesh=ba_mesh)
    TCW = torch.as_tensor(np.linalg.inv(TWC), dtype=torch.float32, device=dev)
    TWO = torch.as_tensor(big["TWO"], dtype=torch.float32, device=dev)
    params = torch.cat([T_to_pose9d(TWO).reshape(-1), T_to_pose9d(TCW).reshape(-1)])
    target = schur._align_targets(*schur._split(params))
    for lambd in (1e-3, BA_STEP_LAMBDA):
        p_a, l_a = schur._lm_step_schur(params, target, lambd, 25.0)
        p_b, l_b = sh._lm_step_schur_sharded(params, target, lambd, 25.0)
        d_pose = (pose9d_to_T(p_a.reshape(-1, 9)) - pose9d_to_T(p_b.reshape(-1, 9))).abs().max().item()
        d_loss = abs(float(l_a) - float(l_b)) / abs(float(l_a))
        log(f"schur_sharded vs schur, one LM step at lambda {lambd:g}: poses max diff {d_pose:.3g}, "
            f"loss rel diff {d_loss:.3g}")
        assert d_loss <= 1e-5
        if lambd == BA_STEP_LAMBDA:
            assert d_pose <= BA_STEP_ATOL, d_pose
    s_step = {name: _median_timed(lambda: fn(params, target, 1e-3, 25.0))
              for name, fn in (("schur_sharded", sh._lm_step_schur_sharded),
                               ("schur", schur._lm_step_schur))}
    out_sh, t_solve_sh = _timed(lambda: sh.solve(pairs, TC1C2, n_iterations=BA_ITERATIONS))
    out, t_solve = _timed(lambda: schur.solve(pairs, TC1C2, n_iterations=BA_ITERATIONS))
    d_fused = max(np.abs(out_sh[k] - out[k]).max() for k in ("TWO", "TWC"))
    figures["ba_step_s"] = s_step
    figures["ba_solve_s"] = {"schur_sharded": t_solve_sh, "schur": t_solve}
    log(f"schur_sharded at {BA_VIEWS} x {BA_OBJECTS} ({card}): s/LM step {_fmt(s_step['schur_sharded'])} "
        f"vs schur {_fmt(s_step['schur'])}; {BA_ITERATIONS} iterations {t_solve_sh:.3f} s vs "
        f"{t_solve:.3f} s; loss {out_sh['loss']:.6f} vs {out['loss']:.6f}, poses max diff {d_fused:.3g}")
    assert abs(out_sh["loss"] - out["loss"]) <= 1e-5 * abs(out["loss"]) and d_fused <= BA_STEP_ATOL

    # (d) object-sharded assets: the render through the sharded select
    assets = db.render_assets(device=dev)
    sharded_assets = shard_objects(pad_objects_to_multiple(assets, 1), mesh, "hp")
    B = BATCHES[0]
    ids = (torch.arange(B) % len(db.labels)).to(dev)
    TCO = random_poses(B, seed=B).to(dev)
    K = torch.tensor([[600.0, 0, RES[1] / 2], [0, 600.0, RES[0] / 2], [0, 0, 1]],
                     device=dev).expand(B, 3, 3)
    rf.launches = 0
    out_sh = rf.render_batch_fused(sharded_assets, ids, TCO, K, resolution=RES)
    torch.cuda.synchronize()
    launches["render through the object-sharded select (world 1)"] = rf.launches
    out = rf.render_batch_fused(assets, ids, TCO, K, resolution=RES)
    equal = all(torch.equal(getattr(out_sh, k), getattr(out, k)) for k in ("rgb", "depth", "mask", "normals"))
    t_r_sh = _median_timed(lambda: rf.render_batch_fused(sharded_assets, ids, TCO, K, resolution=RES))
    t_r = _median_timed(lambda: rf.render_batch_fused(assets, ids, TCO, K, resolution=RES))
    figures["render_s"] = {"sharded": t_r_sh, "whole": t_r}
    log(f"object-sharded render, B = {B} at {RES[0]}x{RES[1]} ({card}): {_fmt(t_r_sh)} s vs the "
        f"whole database {_fmt(t_r)} s; outputs bit-equal: {equal}")
    assert equal and launches["render through the object-sharded select (world 1)"] == 1
    dist.destroy_process_group()
    return {"launches": launches, "figures": figures}


# ------------------------------------------------ the JAX package's run directories

# the keys of `config.json` that the JAX package's training scripts write
# (`vars(args)`, the pose trainer's with its `cfg` string)
JAX_POSE_CONFIG = {
    "run_dir": "", "model_type": "refiner", "backbone": "resnet34", "data": "synth",
    "models_dir": None, "synth_set": "debug", "mesh_files": None, "max_faces": 0, "epochs": 2,
    "epoch_size": 64, "batch_size": 8, "lr": 0.0003, "n_warmup_steps": 50, "n_iterations": 1,
    "coarse_negatives": "grid", "coarse_hypotheses": 8, "add_iteration_epoch_interval": 0,
    "n_iterations_max": 3, "render_size": [240, 320], "image_size": [480, 640], "eval_every": 0,
    "save_every": 10, "no_augment": False, "stream": False, "stream_chunk": 512,
    "resume": False, "init_from": None, "dp": False, "bf16": False, "profile": False, "cfg": "",
}
JAX_DETECTOR_CONFIG = {
    "run_dir": "", "split_dir": "", "models_dir": None, "image_size": [240, 320], "epochs": 2,
    "epoch_size": 32, "batch_size": 2, "max_gt": 8, "lr": 0.0001, "fpn_channels": 64,
    "resume": False, "save_every": 5, "eval_interval": 0, "eval_frames": 8, "no_augment": False,
}
JAX_RESUME_BATCH = 8  # `run_pose_training --resume`: one step an epoch
JAX_DIR_FRAMES = 4  # frames of phase 15's split served from the JAX-format directories
# the second resumed step's loss, JAX-format against the port's checkpoint
# (7.8e-5 apart in the first run on the card): it follows the first step's
# update, whose backward pass need not be deterministic there (the phase
# runs the port's resume twice to show it); the loaded state and the first
# step's loss are compared exactly
RESUME_SECOND_RTOL = 1e-3
DECODE_REPEATS = 3


def _same_predictions(a: list, b: list) -> None:
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        for k in ("poses", "obj_ids", "scores"):
            assert np.array_equal(np.asarray(ra[k]), np.asarray(rb[k])), (
                f"frame {ra['scene_id']}/{ra['view_id']}: {k} differ")


def phase_jax_run_dirs(dev, root: Path, data: dict, kernel: dict) -> dict:
    """40. The JAX package's run directories on the card: megapose-RGB
    (ResNet34, 240x320 rgb + normals) refiner and coarse model and the
    ResNet50-FPN detector (64 FPN channels), seeded weights of the port
    carried over by the weight bridge and written by `flax_msgpack` with the
    JAX trainers' `config.json` keys; `run_eval --model from-checkpoints
    --detections detector` on the first `JAX_DIR_FRAMES` frames of phase 15's
    split serves them, and its poses
    equal bit for bit those of the same models handed their state dicts
    (no file); then a refiner trained 2 steps by `run_pose_training`, its
    TrainState written in JAX's layout (Adam's state included) and decoded
    (s, MB/s), loaded into the same state as the port's own checkpoint (weights,
    Adam's moments, counts, bit for bit), and resumed by `run_pose_training
    --resume` for 2 steps beside that checkpoint's resume: the first step's
    loss equal, the second's within `RESUME_SECOND_RTOL`."""
    from happypose_tpu_torch.datasets.bop import BOPObjectDataset, BOPSceneDataset
    from happypose_tpu_torch.evaluation.prediction_runner import PredictionRunner
    from happypose_tpu_torch.models.detector import DetectorConfig, FCOSDetector
    from happypose_tpu_torch.models.pose_predictor import PosePredictor
    from happypose_tpu_torch.ops import rasterizer_fused as rf
    from happypose_tpu_torch.scripts import run_eval as run_eval_cli
    from happypose_tpu_torch.scripts import run_pose_training
    from happypose_tpu_torch.training import TrainState, make_optimizer
    from happypose_tpu_torch.utils import checkpoint as ckpt
    from happypose_tpu_torch.utils import flax_msgpack
    from happypose_tpu_torch.utils import load_model as lm
    from happypose_tpu_torch.utils.weights_from_jax import (
        detector_variables, pose_predictor_variables,
    )

    launches, figures = {}, {}
    spec = lm.NAMED_MODELS["megapose-RGB"]
    runs = root / "jax_runs"
    sds = {}
    for role, cfg, seed in (("refiner", spec.refiner_cfg, 0), ("coarse", spec.coarse_cfg, 1)):
        sds[role] = _seeded_state_dict(cfg, seed)
        lm.save_flax_run_dir(runs / role, pose_predictor_variables(sds[role], cfg.backbone), {
            **JAX_POSE_CONFIG, "run_dir": str(runs / role), "model_type": role,
            "backbone": cfg.backbone, "render_size": list(cfg.render_size), "cfg": str(cfg)})
        assert not (runs / role / lm.STATE_DICT_FILE).exists()
        back = lm.read_state_dict(runs / role)
        assert back.keys() == sds[role].keys() and all(torch.equal(back[k], v)
                                                       for k, v in sds[role].items())
    obj_ds = BOPObjectDataset(data["models"])
    det_cfg = DetectorConfig(n_classes=len(obj_ds.labels), fpn_channels=64)
    det_sd = FCOSDetector(det_cfg).init_weights(torch.Generator().manual_seed(0)).state_dict()
    det_dir = lm.save_flax_run_dir(root / "jax_detector", detector_variables(det_sd), {
        **JAX_DETECTOR_CONFIG, "run_dir": str(root / "jax_detector"),
        "split_dir": str(data["split"]), "models_dir": str(data["models"])})
    spec = lm.spec_from_checkpoints({r: runs / r for r in ("refiner", "coarse")})
    icfg = spec.inference_cfg

    # served from the directories by the CLI, and from the state dicts (no file)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True):
        rf.launches = 0
        with _KernelInputs() as inputs:
            res, t_cli = _timed(lambda: run_eval_cli.run([
                "--split-dir", str(data["split"]), "--models-dir", str(data["models"]),
                "--model", "from-checkpoints", "--checkpoints", str(runs),
                "--detections", "detector", "--detector-run", str(det_dir),
                "--detection-th", "0.0", "--max-frames", str(JAX_DIR_FRAMES),
                "--out-dir", str(root / "eval_jax_runs"), "--device", str(dev)]))
        n = rf.launches
        preds = res["predictions"]
        est = lm.load_named_model(spec, obj_ds.mesh_db, state_dicts=sds, device=dev)
        detector = lm.load_detector(det_cfg, state_dict=det_sd, image_size=(240, 320), device=dev)
        runner = PredictionRunner(
            scene_ds=BOPSceneDataset(data["split"]), estimator=est, mesh_db=obj_ds.mesh_db,
            detection_type="detector", detector=detector, detection_th=0.0, device=str(dev),
            max_frames=JAX_DIR_FRAMES)
        direct, t_direct = _timed(lambda: runner.get_predictions()["final"])
    n_det = [len(r["poses"]) for r in preds]
    per_frame = [_frame_launches(icfg, D, icfg.SO3_grid_size) for D in n_det]
    expected = _runner_launches(zip(n_det, per_frame))
    launches[f"run_eval from JAX run dirs, detector->megapose-RGB ({len(preds)} frames)"] = n
    log(f"run_eval --model from-checkpoints on JAX-format run directories (megapose-RGB + "
        f"detector, threshold 0): {len(preds)} frames, detections a frame {n_det}; raster_fused "
        f"launches {n}, expected {expected} ({per_frame} a frame, the first of each D twice: "
        f"the capture's warm-up and the capture); the whole call with loading {t_cli:.2f} s, the same models "
        f"from state dicts {t_direct:.2f} s")
    assert len(preds) == JAX_DIR_FRAMES and min(n_det) >= 1 and n == expected
    assert all(np.isfinite(r["poses"]).all() for r in preds)
    _same_predictions(preds, direct)
    log("poses, object ids and scores from the JAX-format directories equal the directly "
        "loaded models' bit for bit")
    _check_new_shapes("jax_run_dirs", inputs, kernel)

    # a TrainState in JAX's layout: decoded, then resumed beside the port's own checkpoint
    trained = root / "jax_resume"
    common = ["--data", "synth", "--synth-set", "textured", "--epoch-size", str(JAX_RESUME_BATCH),
              "--batch-size", str(JAX_RESUME_BATCH), "--render-size", *map(str, RES),
              "--image-size", *map(str, FRAME_RES), "--backbone", "resnet34",
              "--n-iterations", "2", "--save-every", "1", "--device", str(dev)]
    pt_dir, flax_dir = trained / "pt", trained / "flax"
    assert run_pose_training.main(["--run-dir", str(pt_dir), "--epochs", "2"] + common) == 0
    model = PosePredictor(lm.config_from_run_dir(pt_dir, coarse=False))
    state = TrainState(model, make_optimizer(model.parameters(), lr=JAX_POSE_CONFIG["lr"],
                                             n_warmup_steps=JAX_POSE_CONFIG["n_warmup_steps"]))
    ckpt.load_checkpoint(pt_dir, state)
    assert state.step == 2 and state.optimizer.count == 2
    path, t_enc = _timed(lambda: ckpt.save_flax_checkpoint(
        flax_dir, state, epoch=2, config=json.loads((pt_dir / "config.json").read_text())))
    (flax_dir / "log.txt").write_text((pt_dir / "log.txt").read_text())
    mb = path.stat().st_size / 1e6
    decode = []
    for _ in range(DECODE_REPEATS):
        tree, t = _timed(lambda: flax_msgpack.read_file(path))
        decode.append(t)
    del tree
    figures["train_state_mb"] = round(mb, 1)
    figures["decode_s"] = decode
    figures["decode_mb_per_s"] = round(mb / statistics.median(decode), 1)
    log(f"{card_line()}: the JAX-format TrainState of the ResNet34 refiner (params, batch stats, "
        f"Adam's mu and nu): {mb:.1f} MB, written in {t_enc:.3f} s; flax_msgpack.read_file "
        f"{_fmt(decode)} s, {figures['decode_mb_per_s']} MB/s")
    # both checkpoints load into the same state: weights, Adam's moments and counts
    loaded = {}
    for d in (pt_dir, flax_dir):
        m = PosePredictor(lm.config_from_run_dir(d, coarse=False))
        st = TrainState(m, make_optimizer(m.parameters(), lr=JAX_POSE_CONFIG["lr"],
                                          n_warmup_steps=JAX_POSE_CONFIG["n_warmup_steps"]))
        ckpt.load_checkpoint(d, st)
        loaded[d.name] = (m.state_dict(), st.optimizer.adam.state_dict()["state"],
                          st.optimizer.count, st.step)
    (sd_a, adam_a, *counts_a), (sd_b, adam_b, *counts_b) = loaded["pt"], loaded["flax"]
    assert counts_a == counts_b == [2, 2] and sd_a.keys() == sd_b.keys()
    assert all(torch.equal(sd_a[k], sd_b[k]) for k in sd_a)
    assert adam_a.keys() == adam_b.keys() and all(
        torch.equal(adam_a[i][k], adam_b[i][k]) for i in adam_a for k in adam_a[i])
    again = trained / "pt_again"  # the port's resume twice: is the second step reproducible?
    shutil.copytree(pt_dir, again)
    resumed = {}
    for d in (pt_dir, flax_dir, again):
        rf.launches, k0 = 0, _synth_keys()
        rc, t = _timed(lambda: run_pose_training.main(
            ["--run-dir", str(d), "--epochs", "4", "--resume"] + common))
        lines = [json.loads(x) for x in (d / "log.txt").read_text().splitlines()]
        # the resumed step's key (2 iterations) and the synthetic batch's new ones
        expected = _graph_launches(2, 1) + _graph_launches(1, _synth_keys() - k0)
        resumed[d.name] = dict(rc=rc, launches=rf.launches, lines=lines, seconds=t,
                               expected=expected)
        launches[f"run_pose_training --resume from {d.name} (2 steps)"] = rf.launches
    pt, fx = resumed["pt"], resumed["flax"]

    def apart(a, b):  # the second resumed step's losses, relative
        return abs(a["lines"][3]["loss"] - b["lines"][3]["loss"]) / abs(a["lines"][3]["loss"])

    second, repeat = apart(pt, fx), apart(pt, resumed["pt_again"])
    log(f"run_pose_training --resume, 2 steps: from the port's checkpoint losses "
        f"{[x['loss'] for x in pt['lines'][2:]]} ({pt['seconds']:.2f} s), from the JAX-format "
        f"TrainState {[x['loss'] for x in fx['lines'][2:]]} ({fx['seconds']:.2f} s): the first "
        f"step's equal, the second's {second:.3g} apart; the port's resume run again: "
        f"{[x['loss'] for x in resumed['pt_again']['lines'][2:]]}, the second {repeat:.3g} "
        f"apart; launches {pt['launches']}, {fx['launches']} (expected {pt['expected']}, "
        f"{fx['expected']})")
    assert pt["rc"] == fx["rc"] == 0
    assert pt["launches"] == pt["expected"] and fx["launches"] == fx["expected"]
    assert [x["epoch"] for x in fx["lines"]] == [0, 1, 2, 3]
    first_pt, first_fx = pt["lines"][2], fx["lines"][2]
    assert all(first_pt[k] == first_fx[k] for k in first_pt if k != "time"), (first_pt, first_fx)
    assert second < RESUME_SECOND_RTOL and math.isfinite(fx["lines"][3]["loss"])
    figures["resume_second_step_rel"] = {"jax_format": second, "port_again": repeat}
    return {"launches": launches, "figures": figures}


def phase_bench(dev, kernel: dict) -> dict:
    """The port's measured entry points (`happypose_tpu_torch/bench.py`) at
    full width, in this process: `refiner_bench` at B = 16 and 64 (one
    launch an iteration: 1 warm + N_SCAN timed + N_SCAN profiled),
    `pipeline_bench` (8 images + 1 warm; the frame's launches from the
    chunk sizes), `breakdown` (N_SCAN + 1 renders and full iterations) and
    `entry()`'s forward (one launch; a second call equal). Each path's new
    shapes are held to the plain version after its count: `entry()`'s
    textured world at B = 4, the pipeline's last refiner chunk (B = 4 at
    D = 4) and its scoring chunk (B = 20), the refiner at B = 64."""
    from happypose_tpu_torch import bench
    from happypose_tpu_torch.ops import rasterizer_fused as rf

    log(f"bench: {card_line()}; refiner and breakdown {bench.precision('bfloat16')}, "
        f"pipeline and entry() {bench.precision('float32')}")
    launches, figures, n = {}, {}, bench.N_SCAN
    held = {(BATCHES[0], RES), (BATCHES[1], RES)}  # the debug set's shapes of phase 3
    for B in (16, 64):
        rf.launches = 0
        with _KernelInputs() as inputs:
            line, notes = bench.refiner_bench(batch=B, device=dev)
        count = rf.launches
        # the warm call captures the stage graph (its warm-up and the capture
        # launch through the wrapper); the replays are counted on the device
        assert notes["launches"] == count == 2, (notes["launches"], count)
        assert notes["profile"]["raster_kernels"] == n, notes["profile"]
        assert torch.isfinite(notes["TCO"]).all()
        assert notes["compute_dtype"] == bench.precision("bfloat16"), notes["compute_dtype"]
        launches[f"bench refiner B={B}"] = count
        figures[f"refiner_b{B}"] = {"line": line, "seconds": notes["seconds"],
                                    "profile": notes["profile"]}
        log(f"bench refiner B={B}: {json.dumps(line)}; {count} wrapper launches (the capture's "
            f"warm-up and the capture); {notes['profile']['raster_kernels']} raster kernels in "
            f"the device trace of the {n} profiled replays; profiled window "
            f"{json.dumps(notes['profile'])}")
        _check_new_shapes(f"bench_refiner_B{B}", inputs, kernel, held=set(held))

    rf.launches = 0
    with _KernelInputs() as inputs:
        line, notes = bench.pipeline_bench(n_images=8, device=dev)
    # the warm frame captures the frame's graph: its warm-up and the capture
    # launch through the wrapper, the replays inside the graph
    count, expected = rf.launches, 2 * notes["launches_per_frame"]
    assert notes["launches_per_frame"] == 19, notes["launches_per_frame"]  # 8 + 2 x 5 + 1 at D = 4
    assert count == notes["launches"] == expected, (count, notes["launches"], expected)
    final = notes["results"]["final"]
    assert int(final.valid.sum()) == 4 and torch.isfinite(final.poses).all()
    launches["bench --pipeline (9 frames, warm-up and capture)"] = count
    figures["pipeline"] = line
    log(f"bench pipeline: {json.dumps(line)}; {count} wrapper launches ({notes['launches_per_frame']} "
        f"a frame, the capture's warm-up and the capture; {notes['frames']} replays)")
    _check_new_shapes("bench_pipeline", inputs, kernel, held=set(held))

    rf.launches = 0
    line = bench.breakdown(device=dev)
    assert rf.launches == 2 * (1 + n), rf.launches
    launches["bench --breakdown"] = rf.launches
    figures["breakdown"] = line
    log(f"bench breakdown: {json.dumps(line)}; {rf.launches} launches")

    forward, args = bench.entry(device=dev)
    rf.launches = 0
    with _KernelInputs() as inputs:
        out = forward(*args)
    torch.cuda.synchronize()
    assert rf.launches == 1 and out.shape == (4, 4, 4) and torch.isfinite(out).all()
    launches["bench entry()"] = rf.launches
    again = forward(*args)
    assert torch.equal(out, again), "entry()'s forward differs between two calls"
    log(f"bench entry(): forward {tuple(out.shape)}, 1 launch, equal to a second call")
    _check_new_shapes("bench_entry", inputs, kernel, held=set())
    return {"launches": launches, "figures": figures}


# ----------------------------------------------------------------- graphs (41)

GRAPH_REPEATS = 2  # timed calls of each path, eager and graph in turn
# graph against eager: bit for bit (the same kernels and the same cuDNN
# algorithms under capture; TF32 off)
GRAPH_ATOL = 0.0


def _results_diff(a: dict, b: dict) -> float:
    """The largest difference between two pipeline results over every
    stage and float field (infinite logits compare as equal where both are
    the same infinity); the other fields must be equal."""
    assert sorted(a) == sorted(b), (sorted(a), sorted(b))
    worst = 0.0
    for k in a:
        for f in dataclasses.fields(a[k]):
            x, y = getattr(a[k], f.name), getattr(b[k], f.name)
            assert x.shape == y.shape, (k, f.name, x.shape, y.shape)
            if x.is_floating_point():
                d = torch.where(x == y, 0.0, (x - y).abs())
                worst = max(worst, float(d.max()) if d.numel() else 0.0)
            else:
                assert torch.equal(x, y), (k, f.name)
    return worst


def _in_turns(eager, graph, n=GRAPH_REPEATS):
    """Seconds of `eager()` and `graph()` on the host clock around
    synchronized calls, in the order eager, graph, graph, eager, ..."""
    times = {"eager": [], "graph": []}
    for i in range(n):
        for name in (("eager", "graph") if i % 2 == 0 else ("graph", "eager")):
            times[name].append(_timed(eager if name == "eager" else graph)[1])
    return times


def _eager_detector(detector):
    """The same detector with its forward run eagerly (no graph)."""
    from happypose_tpu_torch.inference.detector import Detector

    eager = Detector(detector.model, image_size=detector.image_size)
    eager._forward = eager.model
    return eager


def _graph_check(name, est, expected, figures, launches, traced, run, run_eager, frames):
    """One path through its frame graph: `run(frames[0])` captures (timed,
    the wrapper's launches counted: the warm-up's and the capture's) and is
    held to `run_eager(frames[0])`; one replay on `frames[1]` (other
    image, depth and boxes, the same shapes) runs under `torch.profiler`,
    which counts its rasterizing kernels on the device, and is held to
    `run_eager(frames[1])`; then both are timed in turns on `frames[1]`."""
    from happypose_tpu_torch import bench
    from happypose_tpu_torch.ops import rasterizer_fused as rf

    a, b = frames
    eager = run_eager(a)  # warm: cuDNN's algorithms, the allocator
    n_keys = len(est._pipeline_jit_cache)
    rf.launches = 0
    first, t_capture = _timed(lambda: run(a))
    launches[f"graphs: {name} (warm-up and capture)"] = n_wrapper = rf.launches
    assert len(est._pipeline_jit_cache) == n_keys + 1
    assert n_wrapper == 2 * expected, f"{name}: {n_wrapper} wrapper launches, expected 2 x {expected}"
    err = _results_diff(first, eager)
    replayed = []
    prof = bench.busy_share(lambda: replayed.append(run(b)))
    assert len(est._pipeline_jit_cache) == n_keys + 1, "the second frame made a new key"
    err = max(err, _results_diff(replayed[0], run_eager(b)))
    traced[f"{name} (one replay)"] = n = prof["raster_kernels"]
    assert n == expected, f"{name}: {n} kernels in a replay's trace, expected {expected}"
    times = _in_turns(lambda: run_eager(b), lambda: run(b))
    pool = est._pipeline_jit_cache.pool_bytes()
    figures[name] = {"s_per_image": times, "capture_s": t_capture, "max_abs_diff": err,
                     "launches_per_replay_traced": n, "busy_share_replay": prof["busy_share"],
                     "pool_bytes": pool}
    log(f"graphs {name} ({card_line()}): s/image graph {_fmt(times['graph'])} vs eager "
        f"{_fmt(times['eager'])}; first call (warm-up, capture, replay) {t_capture:.3f} s, "
        f"{n_wrapper} wrapper launches; graph vs eager max abs diff {err:g} (limit "
        f"{GRAPH_ATOL}; the capture's frame and a replay on another frame); {n} raster kernels "
        f"in a replay's device trace (expected {expected}), busy share {prof['busy_share']:.3f}; "
        f"graph pool {pool / 2**20:.1f} MiB")
    assert err <= GRAPH_ATOL, f"{name}: graph vs eager {err}"
    return first


def _moved(det, dx=5.0, dy=3.0):
    """The same detections with their boxes moved by (dx, dy) pixels."""
    shift = torch.tensor([dx, dy, dx, dy], device=det.boxes.device)
    return dataclasses.replace(det, boxes=det.boxes + shift)


def _graphs_pipeline(dev, kernel, figures, launches, traced):
    """The bench's `--pipeline` frame (detector -> megapose-RGB, 576-grid,
    top-5, 5 iterations, D = 4, float32) through the detector's and the
    frame's graphs against the eager path, captured on the bench's frame
    and replayed on another (seed 1, boxes moved); then D = 2, 4, 2 on the
    same estimator (one shared pool), and `forward_coarse_jit` against
    `forward_coarse` at D = 2 on both frames."""
    from happypose_tpu_torch import bench
    from happypose_tpu_torch.inference.detector import Detector
    from happypose_tpu_torch.inference.types import DetectionBatch, ObservationBatch
    from happypose_tpu_torch.models.detector import DetectorConfig, FCOSDetector
    from happypose_tpu_torch.utils.load_model import load_named_model

    with bench._tf32(), _KernelInputs() as inputs:
        db = bench._mesh_db("debug")
        est = load_named_model("megapose-RGB", db, device=dev)
        K = torch.tensor([bench.K_BENCH], device=dev)
        obs_a, obs_b = (ObservationBatch(rgb=torch.from_numpy(np.random.RandomState(seed).rand(
            1, 3, *bench.RES).astype(np.float32)).to(dev), K=K) for seed in (0, 1))
        detector = Detector(FCOSDetector(DetectorConfig(n_classes=len(db.labels)))
                            .init_weights(torch.Generator().manual_seed(0)).to(dev),
                            image_size=bench.RES)
        eager_detector = _eager_detector(detector)
        dets = {D: DetectionBatch.from_numpy(np.asarray(bench.PIPELINE_BOXES[:D], np.float32),
                                            np.asarray(bench.PIPELINE_OBJ_IDS[:D]), device=dev)
                for D in (2, 4)}
        frames = [(obs_a, dets[4]), (obs_b, _moved(dets[4]))]

        # the detector's forward alone: graph against eager, captured on the
        # first image, replayed on the second
        det_err = 0.0
        for obs in (obs_a, obs_b):
            with torch.inference_mode():
                raw = eager_detector.model(obs.rgb)
            out = detector._forward(obs.rgb)
            det_err = max([det_err] + [float((x - y).abs().max()) for x, y in zip(out, raw)])
        assert len(detector._forward_graphs) == 1, len(detector._forward_graphs)
        assert det_err <= GRAPH_ATOL, f"detector forward: graph vs eager {det_err}"

        def run(frame):
            detector.get_detections(frame[0], detection_th=0.3)
            return est.run_inference_pipeline_jit(*frame, 5, 5)

        def run_eager(frame):
            eager_detector.get_detections(frame[0], detection_th=0.3)
            return est.run_inference_pipeline(*frame, 5, 5)

        expected = bench.frame_launches(
            dataclasses.replace(est.cfg, n_refiner_iterations=5, n_pose_hypotheses=5), 4,
            est.SO3_grid.shape[0])
        _graph_check("bench --pipeline (detector -> megapose-RGB, D = 4)", est, expected,
                     figures, launches, traced, run, run_eager, frames)
        figures["detector_forward_max_abs_diff"] = det_err
        figures["detector_pool_bytes"] = detector._forward_graphs.pool_bytes()

        # D = 2, 4, 2 on one estimator: one pool, each result the eager one's
        order, kept, pools, eager = [], None, [], {}
        for D in (2, 4, 2):
            res = est.run_inference_pipeline_jit(obs_b, dets[D], 5, 5)
            if D not in eager:
                eager[D] = est.run_inference_pipeline(obs_b, dets[D], 5, 5)
            err = _results_diff(res, eager[D])
            assert err <= GRAPH_ATOL, f"D = {D}: graph vs eager {err}"
            if kept is None:
                first, kept = res, {k: v.poses.clone() for k, v in res.items()}
            order.append(D)
            pools.append(est._pipeline_jit_cache.pool_bytes())
        assert all(torch.equal(first[k].poses, v) for k, v in kept.items()), \
            "a later replay changed the first call's results"
        assert len(est._pipeline_jit_cache) == 2, len(est._pipeline_jit_cache)
        capture = est._pipeline_jit_cache.capture_seconds
        figures["d_order"] = {"order": order, "pool_bytes": pools, "capture_s": capture}
        log(f"graphs D = 2, 4, 2 on one estimator: each equal to eager, the first call's results "
            f"untouched; {len(est._pipeline_jit_cache)} frame graphs, capture s a key "
            f"{[round(c, 3) for c in capture]}, pool MiB after each call "
            f"{[round(p / 2**20, 1) for p in pools]}; reserved "
            f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB")

        # the coarse stage alone: captured on the first frame, replayed on the second
        coarse_err = 0.0
        for obs, det in ((obs_a, dets[2]), (obs_b, _moved(dets[2]))):
            coarse_err = max(coarse_err, _results_diff(
                {"coarse": est.forward_coarse_jit(obs, det)},
                {"coarse": est.forward_coarse(obs, det)}))
        assert len(est._pipeline_jit_cache) == 3, len(est._pipeline_jit_cache)
        figures["forward_coarse_jit"] = {"max_abs_diff": coarse_err,
                                         "capture_s": est._pipeline_jit_cache.capture_seconds[-1]}
        log(f"graphs forward_coarse_jit vs forward_coarse (megapose-RGB, 576-grid, D = 2, the "
            f"capture's frame and another): max abs diff {coarse_err:g} (limit {GRAPH_ATOL})")
        assert coarse_err <= GRAPH_ATOL, f"forward_coarse_jit vs forward_coarse {coarse_err}"
    _check_new_shapes("graphs_pipeline", inputs, kernel)


def _graphs_cosypose(dev, kernel, figures, launches, traced):
    """Detector (its graph) -> cosypose-RGB (the frame's graph) at full
    width on the 480x640 frame against the eager path, captured on one
    seeded frame and replayed on another."""
    from happypose_tpu_torch.evaluation.prediction_runner import boxes_to_frame
    from happypose_tpu_torch.inference.types import DetectionBatch, ObservationBatch
    from happypose_tpu_torch.meshes import io
    from happypose_tpu_torch.meshes.database import MeshDataBase
    from happypose_tpu_torch.models.detector import DetectorConfig
    from happypose_tpu_torch.utils.load_model import load_detector

    db = debug_mesh_db(MeshDataBase, io)
    frames = [_synthetic_frame(db, dev, seed)[0] for seed in (0, 1)]
    detector = load_detector(DetectorConfig(n_classes=len(db.labels)), seed=0, device=dev)
    eager_detector = _eager_detector(detector)
    est = _load("cosypose-RGB", db, dev)

    def detect(d, obs):
        x, K = _detector_input(obs, d.image_size)
        found, _ = d.get_detections(ObservationBatch(rgb=x, K=K), detection_th=0.0,
                                    one_instance_per_class=True)
        return DetectionBatch.from_numpy(
            boxes=boxes_to_frame(found.boxes.cpu().numpy(), obs.K[0].cpu().numpy(),
                                 K[0].cpu().numpy()),
            obj_ids=found.obj_ids.cpu().numpy(), scores=found.scores.cpu().numpy(), device=dev)

    for obs in frames:
        det, det_g = detect(eager_detector, obs), detect(detector, obs)
        assert torch.equal(det.boxes, det_g.boxes) and torch.equal(det.obj_ids, det_g.obj_ids), \
            "the graphed detector found other boxes"

    with _KernelInputs() as inputs:
        _graph_check(f"detector -> cosypose-RGB (D = {det.n_rows})", est,
                     _frame_launches(est.cfg, det.n_rows), figures, launches, traced,
                     lambda obs: est.run_inference_pipeline_jit(obs, detect(detector, obs)),
                     lambda obs: est.run_inference_pipeline(obs, detect(eager_detector, obs)),
                     frames)
    _check_new_shapes("graphs_cosypose", inputs, kernel)


def _graphs_rgbd(dev, kernel, figures, launches, traced):
    """megapose-RGB + ICP and + "teaserpp" at full width on the RGB-D frame
    (the depth refiner inside the frame's graph), captured on one seeded
    frame and replayed on another."""
    from happypose_tpu_torch.meshes import io
    from happypose_tpu_torch.meshes.database import MeshDataBase

    db = debug_mesh_db(MeshDataBase, io)
    frames = [_synthetic_rgbd_frame(db, dev, seed)[:2] for seed in (0, 1)]
    est = _load("megapose-RGB", db, dev)
    rgb_cfg = est.cfg
    D = frames[0][1].n_rows
    with _KernelInputs() as inputs:
        for name in ("icp", "teaserpp"):
            est.cfg = dataclasses.replace(rgb_cfg, run_depth_refiner=True, depth_refiner=name)
            res = _graph_check(f"megapose-RGB + {name} (D = {D})", est,
                               _megapose_launches(est, D) + 1, figures, launches, traced,
                               lambda frame: est.run_inference_pipeline_jit(*frame),
                               lambda frame: est.run_inference_pipeline(*frame), frames)
            moved = (res["final"].poses - res["scored"].poses)[res["final"].valid]
            assert moved.abs().max() > 0, f"{name} did not move a pose inside the graph"
    _check_new_shapes("graphs_rgbd", inputs, kernel)


def _graphs_refiner(dev, figures, launches, traced):
    """The refiner bench's iteration (bfloat16, debug set) at B = 16 (phase
    39 replays B = 64 through the same graph): `N_SCAN` chained calls of the stage graph `_refine_fn` (each replay on
    the previous one's poses) against the model's eager call, the final
    poses compared, both timed in turns and profiled (device busy share,
    the rasterizing kernels counted on the device)."""
    from happypose_tpu_torch import bench
    from happypose_tpu_torch.inference.pose_estimator import _refine_fn, _stage_graphs
    from happypose_tpu_torch.models.pose_predictor import PosePredictorConfig
    from happypose_tpu_torch.ops import rasterizer_fused as rf

    with bench._tf32():
        db = bench._mesh_db("debug")
        assets = db.render_assets(device=dev)
        meshes_db = db.batched(n_points=512, device=dev)
        model = bench.seeded_predictor(PosePredictorConfig(
            backbone="resnet34", render_size=bench.RES, compute_dtype="bfloat16"), dev)
        for B in (16,):
            images, K, obj_ids, TCO0 = bench.bench_inputs(B, dev)
            meshes = meshes_db.select(obj_ids)

            def eager(TCO=TCO0):
                with torch.inference_mode():
                    for _ in range(bench.N_SCAN):
                        TCO = model(images, K, obj_ids, TCO, assets, meshes).TCO_output[-1]
                return TCO

            def graph(TCO=TCO0):
                for _ in range(bench.N_SCAN):
                    TCO = _refine_fn(model, images, K, obj_ids, TCO, assets, meshes, 1)[-1]
                return TCO

            ref = eager()
            rf.launches = 0
            graph()  # the first call captures
            launches[f"graphs: refiner stage B={B} (warm-up and capture)"] = rf.launches
            assert rf.launches == 2, rf.launches
            out = graph()
            err = float((out - ref).abs().max())
            times = _in_turns(eager, graph)
            prof = {"graph": bench.busy_share(graph), "eager": bench.busy_share(eager)}
            traced[f"refiner stage B={B} ({bench.N_SCAN} replays)"] = n = \
                prof["graph"]["raster_kernels"]
            assert n == bench.N_SCAN == prof["eager"]["raster_kernels"], (n, prof)
            per_iter = {k: [t / bench.N_SCAN for t in v] for k, v in times.items()}
            figures[f"refiner_b{B}"] = {"s_per_iteration": per_iter, "profile": prof,
                                        "max_abs_diff": err,
                                        "pool_bytes": _stage_graphs[model].pool_bytes()}
            log(f"graphs refiner B={B} ({card_line()}): s/iteration graph "
                f"{_fmt(per_iter['graph'])} vs eager {_fmt(per_iter['eager'])} "
                f"({B / statistics.median(per_iter['graph']):.1f} vs "
                f"{B / statistics.median(per_iter['eager']):.1f} pose-iterations/s); busy share "
                f"graph {prof['graph']['busy_share']:.3f} vs eager {prof['eager']['busy_share']:.3f}; "
                f"poses after {bench.N_SCAN} iterations max abs diff {err:g} (limit {GRAPH_ATOL}); "
                f"{n} raster kernels in the device trace of {bench.N_SCAN} replays")
            assert err <= GRAPH_ATOL, f"refiner B={B}: graph vs eager {err}"


def phase_graphs(dev, kernel: dict) -> dict:
    """Phase 41: the compiled entry points as CUDA graphs against the eager
    paths (see the docstring of the module)."""
    import gc

    figures, launches, traced = {}, {}, {}
    for part in (lambda: _graphs_pipeline(dev, kernel, figures, launches, traced),
                 lambda: _graphs_cosypose(dev, kernel, figures, launches, traced),
                 lambda: _graphs_rgbd(dev, kernel, figures, launches, traced),
                 lambda: _graphs_refiner(dev, figures, launches, traced)):
        part()
        gc.collect()
        torch.cuda.empty_cache()
    return {"launches": launches, "traced": traced, "figures": figures}


# ------------------------------------------------------- graphed training (42)

GT_STEPS = 5  # steps of each copy: a warm-up of 3 updates, a decay at update 4
GT_NAN_STEP = 2  # the step whose batch holds phase 21's NaN pixel (skipped)
GT_TIMED = 4  # steps of graph and eager each, in turns, with cuDNN's default algorithms


def _train_state_tensors(state) -> list:
    """Parameters, buffers, Adam's state and the count of a train state."""
    return ([t.detach() for t in state.model.state_dict().values()]
            + state.optimizer.state_tensors())


def _gt_copy(w, role):
    """A train state and step on a copy of `w`'s initial model, with the
    rate schedule of phase 42: 3 warm-up updates, a decay at update 3."""
    import copy

    from happypose_tpu_torch.training import TrainState, make_optimizer, make_train_step
    from happypose_tpu_torch.training.forward_loss import (
        make_coarse_grid_loss_fn, make_refiner_loss_fn,
    )

    model = copy.deepcopy(w.model)
    loss_fn = (make_refiner_loss_fn(model, w.assets, w.meshes, n_iterations=REFINER_ITERATIONS)
               if role == "refiner" else
               make_coarse_grid_loss_fn(model, w.assets, w.meshes, n_hypotheses=GRID_HYPOTHESES))
    opt = make_optimizer(model.parameters(), lr=3e-4, n_warmup_steps=3, decay_steps=(3,))
    return TrainState(model, opt), make_train_step(loss_fn)


def _graphed_training_role(dev, role, per_step, figures, launches, traced):
    """One loss of phase 42 (see `phase_graphed_training`)."""
    from happypose_tpu_torch import bench
    from happypose_tpu_torch.ops import rasterizer_fused as rf

    w = _train_world(dev, role, B=TRAIN_BATCH[role])
    batches = []
    for i in range(GT_STEPS):
        b = w.batch(1000 if i == GT_NAN_STEP else i)
        if i == GT_NAN_STEP:
            H, W = b.images.shape[2:]
            b.images[-1, :, H // 4, W // 3] = float("nan")
        batches.append((b, w.draws(b, i)))
    copies = {name: _gt_copy(w, role) for name in ("graph", "eager", "eager_again")}
    rates, gaps, diffs, wrapper, times = [], [], [], [], {k: [] for k in copies}
    total = 0  # every wrapper launch of the phase's calls, graph and eager
    for i, (b, d) in enumerate(batches):
        rates.append(copies["graph"][0].optimizer.schedule(copies["graph"][0].optimizer.count))
        metrics = {}
        for name, (state, step) in copies.items():
            rf.launches = 0
            fn = step if name == "graph" else step.eager
            metrics[name], t = _timed(lambda: fn(state, b, d))
            times[name].append(t)
            total += rf.launches
            if name == "graph":
                wrapper.append(rf.launches)
        g, e, e2 = (_train_state_tensors(copies[k][0]) for k in copies)
        gaps.append(max(float((x - y).abs().max()) if x.is_floating_point()
                        else float((x != y).any()) for x, y in zip(e, e2)))
        diffs.append(max(float((x - y).abs().max()) if x.is_floating_point()
                         else float((x != y).any()) for x, y in zip(g, e)))
        skipped = [metrics[k]["skipped_nonfinite"] for k in copies]
        assert skipped == [float(i == GT_NAN_STEP)] * 3, (i, skipped)
    counts = [(c[0].optimizer.count, c[0].step) for c in copies.values()]
    assert counts == [(GT_STEPS - 1, GT_STEPS)] * 3, counts
    assert wrapper == [_graph_launches(per_step - 1, 1)] + [0] * (GT_STEPS - 1), wrapper
    bit_equal = max(gaps) == 0.0
    for i, (gap, diff) in enumerate(zip(gaps, diffs)):
        assert diff <= gap, f"{role} step {i}: graph vs eager {diff}, eager vs eager {gap}"
    state, step = copies["graph"]
    capture_s = step.graphs.capture_seconds[0]

    # a replay of the synthetic batch and the step under the profiler
    def replay():
        b = w.batch(GT_STEPS)
        step(state, b, w.draws(b, GT_STEPS))

    rf.launches = 0
    prof = bench.busy_share(replay)
    total += rf.launches
    traced[f"graphed training {role} (one step, batch and step)"] = prof["raster_kernels"]
    assert prof["raster_kernels"] == per_step, prof

    # graph and eager in turns with cuDNN's default (nondeterministic)
    # algorithms: another key for the graph, captured by an untimed call
    torch.backends.cudnn.deterministic = False
    e_state, e_step = copies["eager"]
    turns = {"graph": [], "eager": []}
    rf.launches = 0
    for i in range(-1, GT_TIMED):
        b, d = batches[i % 2]
        order = ("graph", "eager") if i % 2 == 0 else ("eager", "graph")
        for name in order:
            fn = ((lambda: step(state, b, d)) if name == "graph"
                  else (lambda: e_step.eager(e_state, b, d)))
            t = _timed(fn)[1]
            if i >= 0:
                turns[name].append(t)
    total += rf.launches
    torch.backends.cudnn.deterministic = True
    assert len(step.graphs) == 2
    pool = step.graphs.pool_bytes()
    launches[f"graphed training {role} (graph and eager, {3 * GT_STEPS + 2 * GT_TIMED + 3} "
             "steps)"] = total
    figures[role] = {
        "rates": rates, "graph_vs_eager_max_abs": diffs, "eager_vs_eager_max_abs": gaps,
        "bit_equal": bit_equal, "s_per_step_deterministic": {k: v[1:] for k, v in times.items()},
        "s_per_step": turns, "busy_share_replay": prof["busy_share"],
        "device_kernels_replay": prof["device_kernels"], "capture_s": step.graphs.capture_seconds,
        "pool_bytes": pool}
    log(f"graphed training {role} ({card_line()}; ResNet34, render {RES}, images {FRAME_RES}, "
        f"B={w.B}; cuDNN deterministic): rates a step {[f'{r:.3g}' for r in rates]}, step "
        f"{GT_NAN_STEP + 1} skipped by a NaN pixel; graph vs eager max abs after each step "
        f"{diffs}, eager vs eager {gaps} ({'bit for bit' if bit_equal else 'held within the gap'}); "
        f"wrapper launches a graph step {wrapper}; s/step (steps 2-{GT_STEPS}) graph "
        f"{_fmt(times['graph'][1:])}, eager {_fmt(times['eager'][1:])}; with cuDNN's default "
        f"algorithms, in turns: graph {_fmt(turns['graph'])}, eager {_fmt(turns['eager'])}; a "
        f"replay (batch and step): {prof['raster_kernels']} rasterizing kernels on the device, "
        f"{prof['device_kernels']} kernels and copies, busy share {prof['busy_share']:.3f}; first "
        f"call (warm-up and capture) {capture_s:.3f} s; graph pool {pool / 2**20:.1f} MiB")


def phase_graphed_training(dev) -> dict:
    """Phase 42: the train step as one CUDA graph replay, beside its eager
    body (see the docstring of the module)."""
    import gc

    figures, launches, traced = {}, {}, {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for role, per_step in (("refiner", 1 + REFINER_ITERATIONS), ("coarse", 2)):
            _graphed_training_role(dev, role, per_step, figures, launches, traced)
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return {"launches": launches, "traced": traced, "figures": figures}


MASKRCNN_KERNELS = {"nms": ("nms_mask_kernel", "nms_scan_kernel"),
                    "roi_align": ("roi_align_kernel",)}  # csrc/mask_rcnn_ops.cu
ROI_ALIGN_RTOL = 1e-6  # of the features' largest |value|: the plain version's float32 operations


def _tensors_mapped(x, fn):
    """A call's arguments or outputs with `fn` applied to each tensor, lists
    and tuples copied through, the rest as they are."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, (list, tuple)):
        return type(x)(_tensors_mapped(v, fn) for v in x)
    return x


class _MaskRCNNCalls:
    """While active, keeps the arguments and outputs of each `nms` and
    `multiscale_roi_align` call of Mask R-CNN's forward that runs (not those
    a graph capture records), by wrapper."""

    def __enter__(self):
        from happypose_tpu_torch.models import mask_rcnn as mr

        self.calls = {"nms": [], "roi_align": []}
        self._wrapped = {"nms": mr.nms, "multiscale_roi_align": mr.multiscale_roi_align}

        def recording(name, fn):
            def call(*args):
                out = fn(*args)
                if not torch.cuda.is_current_stream_capturing():
                    self.calls[name].append(_tensors_mapped((args, out), torch.clone))
                return out
            return call

        mr.nms = recording("nms", mr.nms)
        mr.multiscale_roi_align = recording("roi_align", mr.multiscale_roi_align)
        return self

    def __exit__(self, *exc):
        from happypose_tpu_torch.models import mask_rcnn as mr

        for name, fn in self._wrapped.items():
            setattr(mr, name, fn)


def _maskrcnn_bounds(calls: dict) -> dict:
    """The least time of one frame's calls of each kernel family, by
    `benchmark/maskrcnn_counts.py` (the counts `nms_roofline.maskrcnn` and
    `roi_align_roofline.maskrcnn` read): NMS its candidates read and its
    bitmask written once, over the memory rate; RoIAlign the larger of its
    bytes (outputs once, each touched feature value once) over the memory
    rate and its flops over the float32 rate."""
    from benchmark import maskrcnn_counts

    nms_bytes = sum(maskrcnn_counts.nms_bytes(args[1].shape[-1], args[1].numel()
                                              // args[1].shape[-1])
                    for args, _ in calls["nms"])
    roi_bytes = roi_flops = 0
    for (feats, scales, rois, levels, size, S), _ in calls["roi_align"]:
        hw = [tuple(f.shape[-2:]) for f in feats]
        for b in range(rois.shape[0]):
            n_bytes, n_flops = maskrcnn_counts.roi_align_work(
                hw, scales, feats[0].shape[1], rois[b].cpu().numpy(), levels[b].cpu().numpy(),
                size, S)
            roi_bytes, roi_flops = roi_bytes + n_bytes, roi_flops + n_flops
    out = {"nms": {"bytes_ms": nms_bytes / HBM_BYTES_PER_S * 1e3, "ops_ms": 0.0}}
    out["roi_align"] = {"bytes_ms": roi_bytes / HBM_BYTES_PER_S * 1e3,
                        "ops_ms": roi_flops / FP32_FLOP_PER_S * 1e3}
    for v in out.values():
        v.update(bound_ms=max(v["bytes_ms"], v["ops_ms"]),
                 bound_by="bytes" if v["bytes_ms"] >= v["ops_ms"] else "operations")
    return out


def _maskrcnn_call_check(name: str, args: tuple, out) -> dict:
    """One recorded call of a Mask R-CNN kernel against its plain version
    on the CPU copies of its arguments: NMS keeps index for index,
    RoIAlign within `ROI_ALIGN_RTOL` of the features' largest value.
    Returns the call's shape, the plain version's ms and the gap ("gap":
    RoIAlign's over the largest feature, NMS's 0)."""
    from happypose_tpu_torch.ops import multiscale_roi_align as mra
    from happypose_tpu_torch.ops import nms as nms_ops

    cpu_args = _tensors_mapped(args, torch.Tensor.cpu)
    t0 = time.perf_counter()
    if name == "nms":
        keep, kv = nms_ops.nms_reference(*cpu_args)
        plain_ms = (time.perf_counter() - t0) * 1e3
        got, got_v = (t.cpu() for t in out)
        assert torch.equal(got_v, kv) and torch.equal(got[kv], keep[kv]), \
            f"nms at {tuple(args[1].shape)}: the kernel's keeps differ from the plain scan's"
        return {"candidates": args[1].shape[-1], "groups": int(cpu_args[2].max()) + 1,
                "budget": args[5], "threshold": args[4], "kept": int(kv.sum()),
                "plain_ms": plain_ms, "gap": 0.0}
    want = mra.roi_align_reference(*cpu_args)
    plain_ms = (time.perf_counter() - t0) * 1e3
    top = max(float(f.abs().max()) for f in cpu_args[0])
    gap = float((out.cpu() - want).abs().max())
    assert gap <= ROI_ALIGN_RTOL * top, f"roi_align: gap {gap} of {top}"
    return {"rois": args[2].shape[1], "size": args[4], "channels": args[0][0].shape[1],
            "levels": [int((cpu_args[3] == i).sum()) for i in range(len(args[0]))],
            "plain_ms": plain_ms, "gap": gap / top}


def phase_maskrcnn(dev) -> list:
    """Phase 43: Mask R-CNN's kernels on the detector's own 480x640 frame.
    `load_detector(MaskRCNNConfig(...))` at every published setting
    (seeded, score threshold 0) on phase 4's synthetic frame: the first
    frame warms up and captures the detector's graph, so each wrapper counts
    its two calls twice (`_graph_launches`); a second frame replays it and
    counts none, and its device trace holds each kernel twice. The calls the
    warm-up made are held to their plain versions on their own inputs: NMS
    index for index, RoIAlign to `ROI_ALIGN_RTOL` of the features' largest
    value. Each kernel family's device time a frame (the replay's trace)
    beside its least time (`_maskrcnn_bounds`), each wrapper call's time
    (CUDA events, its sort and gathers included) and the plain version's.
    Returns the kernels line's rows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from happypose_tpu_torch.meshes import io
    from happypose_tpu_torch.meshes.database import MeshDataBase
    from happypose_tpu_torch.models.mask_rcnn import MaskRCNNConfig
    from happypose_tpu_torch.ops import multiscale_roi_align as mra
    from happypose_tpu_torch.ops import nms as nms_ops
    from happypose_tpu_torch.utils import profiling
    from happypose_tpu_torch.utils.load_model import load_detector

    det = load_detector(MaskRCNNConfig(box_score_thresh=0.0), seed=0, device=dev,
                        image_size=FRAME_RES)
    db = debug_mesh_db(MeshDataBase, io)
    (obs, _), (obs2, _) = _synthetic_frame(db, dev, seed=0), _synthetic_frame(db, dev, seed=1)

    def replays():
        c = profiling.counters()
        return c.get("graphs.detector.captures", 0), c.get("graphs.detector.replays", 0)

    nms_ops.launches = mra.launches = 0
    c0 = replays()
    with _MaskRCNNCalls() as rec:
        rows, _ = det.get_detections(obs, detection_th=0.0)
    torch.cuda.synchronize()
    c1 = replays()
    launches = {"nms": nms_ops.launches, "roi_align": mra.launches}
    for name, calls in rec.calls.items():
        assert len(calls) == 2, f"{name}: {len(calls)} calls in the warm-up, expected 2"
        assert launches[name] == _graph_launches(2, 1), \
            f"{name}: {launches[name]} launches in the first frame, expected {_graph_launches(2, 1)}"
    assert (c1[0] - c0[0], c1[1] - c0[1]) == (1, 0), f"first frame: captures, replays {c0} -> {c1}"
    det.get_detections(obs2, detection_th=0.0)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        det.get_detections(obs, detection_th=0.0)
        torch.cuda.synchronize()
    c2 = replays()
    assert (c2[0] - c1[0], c2[1] - c1[1]) == (0, 2), f"replays: captures, replays {c1} -> {c2}"
    assert {"nms": nms_ops.launches, "roi_align": mra.launches} == launches, \
        "a replay ran a wrapper"
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    log(f"maskrcnn: {rows.n_rows} rows a frame; {launches} wrapper launches in the first frame "
        f"(warm-up and capture), none in two replays")

    bounds = _maskrcnn_bounds(rec.calls)
    results = []
    for name, calls in rec.calls.items():
        traced = {k: sum(e.count for e in events if k in e.key) for k in MASKRCNN_KERNELS[name]}
        assert all(n == 2 for n in traced.values()), f"{name}: {traced} in a replay's trace"
        ms = sum(e.device_time_total for e in events
                 if any(k in e.key for k in MASKRCNN_KERNELS[name])) / 1e3
        shapes = [_maskrcnn_call_check(name, args, out) for args, out in calls]
        for (args, _), shape in zip(calls, shapes):
            wrapper = nms_ops.nms if name == "nms" else mra.multiscale_roi_align
            shape["wrapper_ms"] = cuda_ms(lambda: wrapper(*args), 10)
        err = max(shape.pop("gap") for shape in shapes)
        b = bounds[name]
        row = {"name": name, "route": "cuda", "source": "happypose_tpu_torch/csrc/mask_rcnn_ops.cu",
               "kernels": list(MASKRCNN_KERNELS[name]),
               "replaces": None,  # new: the JAX package has no Mask R-CNN
               "launches": launches[name],
               "launches_by_path": {"maskrcnn frame (warm-up and capture)": launches[name]},
               "replay_launches_traced": {"maskrcnn frame": traced},
               # NMS: keeps index for index; RoIAlign: the largest gap over the largest feature
               "max_abs_err": err,
               # both calls of a frame: the kernels' device time in a replay's trace
               "ms": ms,
               "plain_ms": sum(s["plain_ms"] for s in shapes),
               "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
               "share_of_bound": b["bound_ms"] / ms,
               "library_ms": None,  # no torchvision on the card
               "shapes": shapes}
        log(f"maskrcnn {name}: {ms:.4f} ms a frame in a replay ({traced}), bound "
            f"{b['bound_ms']:.5f} ms ({b['bound_by']}: bytes {b['bytes_ms']:.5f}, operations "
            f"{b['ops_ms']:.5f}), {100 * row['share_of_bound']:.2f}% of it; calls: "
            + json.dumps(shapes))
        results.append(row)
    return results


PHASE_SECONDS: dict = {}  # host seconds of each `phase_*` call, by function name
T_START = time.perf_counter()


def _clocked(fn):
    """`fn` that adds its seconds to `PHASE_SECONDS` and logs them."""
    def run(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            t = time.perf_counter()
            PHASE_SECONDS[fn.__name__] = PHASE_SECONDS.get(fn.__name__, 0.0) + t - t0
            log(f"[{fn.__name__}: {t - t0:.1f} s, {t - T_START:.1f} s since the start]")
    return run


def main() -> None:
    sys.path.insert(0, str(ROOT))
    for name in [n for n in globals() if n.startswith("phase_")]:
        globals()[name] = _clocked(globals()[name])
    device = phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    kernel = phase_kernel(dev)
    n_launches, s_per_image = phase_pipeline(dev)
    launches = {"megapose-RGB": n_launches}
    phase_small_cross_check(dev)
    phase_detector(dev)
    launches["cosypose-RGB"] = phase_cosypose(dev)
    launches["detector->cosypose-RGB"] = phase_chained(dev)
    phase_cosypose_small_cross_check(dev)
    launches.update(phase_rgbd_pipeline(dev))
    phase_tie_order(dev)
    poses = phase_depth_refiners(dev)
    launches["bop19 add_image (one image, VSD)"] = phase_bop19(dev, poses)
    phase_rgbd_small_cross_check(dev)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        phase_textured(dev, root, kernel)
        data = phase_bop_dataset(dev, root, kernel)
        launches["render_scenes (8 frames)"] = data["render_scenes"]
        launches["run_eval megapose-RGB gt --bop19 (8 frames)"] = phase_run_eval(
            dev, root, data, s_per_image)
        launches["run_eval detector->cosypose-RGB (8 frames)"] = phase_detector_eval(dev, root, data)
        phase_run_eval_cross_check(dev, root, data)
        launches["run_inference_on_example"] = phase_example(dev, root)
        figures, train_launches, refiner = phase_training(dev)
        launches.update(train_launches)
        launches["train skip (1 step)"] = phase_training_skip(dev, refiner)
        del refiner
        launches["train bf16 (3 steps each)"] = phase_training_bf16(dev, figures)
        launches["train cut cuda (1 step)"] = phase_training_cross_check(dev)
        launches.update(phase_train_cli(dev, root, data))
        log(f"training figures: {json.dumps(figures)}")
        recorder = phase_recorder(dev, root)
        launches[f"recorder ({RECORD_BATCHES} batches)"] = recorder["launches"]
        split = phase_record_cli(dev, root)
        launches[f"record_synthetic_dataset ({SPLIT_FRAMES} frames)"] = split["launches"]
        disk = phase_train_from_disk(dev, root, split, figures["refiner"]["s_per_step"])
        launches.update(disk["launches"])
        detector = phase_detector_training(dev, split)
        launches.update(phase_training_clis(dev, root, split))
        log("recorder and training-from-disk figures: " + json.dumps({
            "recorder": recorder, "record_cli": {k: split[k] for k in (
                "frames_per_s", "bop_read_fps", "wds_read_fps")},
            "refiner_from_disk": disk["figures"], "detector": detector}))
        mv = phase_multiview_synthesize(dev, root, kernel)
        launches.update(mv["launches"])
        launches.update(phase_multiview_pipeline(dev, root, mv["scene"], kernel))
        launches.update(phase_multiview_record_dr(dev, root, mv["scene"], kernel))
        custom = phase_custom_scenario(dev, root, mv["scene"])
        launches["run_custom_scenario (2 scenarios)"] = sum(f["launches"] for f in custom.values())
        ba = phase_large_ba(dev, mv["scene"])
        log("multiview phases 30-34 figures: " + json.dumps(
            {"scene": mv["figures"], "custom_scenario": custom, "large_ba": ba}))
        bb_figures, bb_launches = phase_backbone_training(dev)
        launches.update(bb_launches)
        serving = phase_backbone_serving(dev, root, kernel)
        launches.update(serving["launches"])
        phase_host_tools(dev, root)
        log("backbone phases 35-36 figures: " + json.dumps(
            {"training": bb_figures, "serving": serving["figures"]}))
        sharded = phase_sharded(dev, root, mv["scene"])
        launches.update(sharded["launches"])
        log("sharded phase 38 figures: " + json.dumps(sharded["figures"]))
        bench_run = phase_bench(dev, kernel)
        launches.update(bench_run["launches"])
        log("bench phase 39 figures: " + json.dumps(bench_run["figures"]))
        jax_dirs = phase_jax_run_dirs(dev, root, data, kernel)
        launches.update(jax_dirs["launches"])
        log("JAX run-directory phase 40 figures: " + json.dumps(jax_dirs["figures"]))
        graphs = phase_graphs(dev, kernel)
        launches.update(graphs["launches"])
        log("graphs phase 41 figures: " + json.dumps(graphs["figures"]))
        graphed_training = phase_graphed_training(dev)
        launches.update(graphed_training["launches"])
        log("graphed training phase 42 figures: " + json.dumps(graphed_training["figures"]))
    maskrcnn = phase_maskrcnn(dev)
    log("phase seconds, largest first: " + json.dumps(
        {k: round(v, 1) for k, v in sorted(PHASE_SECONDS.items(), key=lambda kv: -kv[1])}))
    log(card_line())  # again, so that a tail of the output keeps it beside the figures
    print(json.dumps({"kernels": [{
        "name": "raster_fused",
        "route": "cuda",
        "source": "happypose_tpu_torch/csrc/raster_fused.cu",
        "replaces": "happypose_tpu/ops/rasterizer_pallas.py:308",
        "also_replaces": "happypose_tpu/ops/rasterizer_pallas.py:257",
        "launches": sum(launches.values()),
        "launches_by_path": launches,
        # a CUDA graph's replay runs no Python: its launches are the
        # rasterizing kernels of one replay's device trace (phases 41, 42)
        "replay_launches_traced": {**graphs["traced"], **graphed_training["traced"]},
        "max_abs_err": kernel["max_abs_err"],
        # at the refiner's shape (debug mesh, B = 16, 240x320); every shape under "shapes"
        "ms": kernel["ms"],
        "plain_ms": kernel["plain_ms"],
        "bound_ms": kernel["bound_ms"],
        "bound_by": kernel["bound_by"],
        "share_of_bound": kernel["share_of_bound"],
        "library_ms": None,  # no single PyTorch call computes this function
        "shapes": kernel["shapes"],
    }, *maskrcnn]}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
