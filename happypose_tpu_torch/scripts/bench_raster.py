"""Development tool: time the rasterizer kernels on the card, at the four
shapes of `chip_smoke.py` (debug mesh and 16k-face sphere, B = 16 and
B = 288, 240x320), beside their bound.

    python3 -m happypose_tpu_torch.scripts.bench_raster kernel \
        [--old-source FILE.cu] [--steps [WORD ...]] [--batches B ...] [--runs 10]
    python3 -m happypose_tpu_torch.scripts.bench_raster frame
    python3 -m happypose_tpu_torch.scripts.bench_raster plain [--runs 10]
    python3 happypose_tpu_torch/scripts/bench_raster.py frame --root DIR

`kernel`: the committed kernels; with `--old-source`, also an earlier
single-kernel `raster_fused.cu` (the interface `raster_fused_launch(A,
chunk_bbox, out, B, n_chunks, H, W, device, stream)`), timed in turns
old, new, new, old on the same inputs; with `--steps`, variants of the
kernels with one design step taken out or changed each, each held to the
committed kernels' output and timed whole and binning alone, and the split
of the time over the three kernels under `torch.profiler`. A variant is
the committed `csrc/raster_fused.cu` with a few lines replaced (`STEPS`),
built beside the port's own build; a replacement whose lines are no longer
in the source stops the run, so the variants follow the source or fail.

`frame`: warm s/image of `megapose-RGB` and `cosypose-RGB` at full width
on `chip_smoke.py`'s synthetic frame, and the number of device kernels of
one frame of each under `torch.profiler`. `--root DIR` takes the package
from another tree inside this checkout (a parent commit unpacked into an
ignored directory), so two trees can be compared in turns on one card;
run the file itself then (with `-m` the package is already imported).

`plain`: the plain PyTorch version (`raster_fused_reference`) on the whole
batch, one call each, at the shapes where `chip_smoke.py` holds it to the
kernel on the first images only (the whole batch takes up to a minute),
beside the kernel's time on the same inputs.

Scenes, timing, the profiler helper and the bound are those of this
checkout's `chip_smoke.py`, loaded from its file. Results go to stdout
and, as JSON, to `<out-dir>/bench_raster_<mode><tag>.json` (`--out-dir`,
default `bench_out/` in the checkout). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import hashlib
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]

_LAUNCH_ELSE = "  else\n    RF_RASTER(4);\n"
_CULL32 = """    for (int k0 = 0; k0 < n; k0 += 32) {
      const int kk = k0 + lane;
      const bool hit = (kk < n) && !misses_strip(st.rec[4][kk], strip_box);
      unsigned m = __ballot_sync(FULL, hit);
      while (m) {
        const int k = k0 + __ffs(m) - 1;
        m &= m - 1;
        test_face<PIX>(st, k, g * GROUP + k, pu, pv0, gu, gv0, best, won);
      }
    }
"""
_CULL1 = """    for (int k = 0; k < n; ++k) {
      if (misses_strip(st.rec[4][k], strip_box)) continue;  // warp-uniform
      test_face<PIX>(st, k, g * GROUP + k, pu, pv0, gu, gv0, best, won);
    }
"""
_STAGE_HEAD = """    Stage& st = s_ring[g & 1];
    cp_async_wait_all();
"""
_STAGE_HEAD_SYNC = """    Stage& st = s_ring[0];
    __syncthreads();  // every thread has left the loop over the stage
    load_indices<SLOTS, THREADS>(list, count, g, face);
    start_copies<SLOTS, THREADS>(st, Ab, face);
    cp_async_wait_all();
"""

# variant -> replacements (old, new) in csrc/raster_fused.cu; each `old`
# must occur exactly once
STEPS = {
    "per-tile lists off (lists hold whole chunks)": [
        ("        visit(cc[i], __ballot_sync(FULL, reaches(lo[i], tu0, tv0)),\n"
         "              __ballot_sync(FULL, reaches(hi[i], tu0, tv0)));\n",
         "        visit(cc[i], FULL, FULL);\n"),
    ],
    "queue by list length off": [
        ("    int bucket = min(N_BUCKETS - 1, (count + BUCKET_STEP - 1) / BUCKET_STEP);\n"
         "    if (offset < 0) bucket = N_BUCKETS - 1;  // walks every face: the longest\n",
         "    int bucket = 0;\n"),
    ],
    "asynchronous staging off": [
        ("  start_copies<SLOTS, THREADS>(s_ring[0], Ab, face);\n", ""),
        (_STAGE_HEAD, _STAGE_HEAD_SYNC),
        ("    if (g + 1 < n_groups) {\n", "    if (false) {\n"),
    ],
    "row skip off": [("    if (PIX == 1 || in_v) {\n", "    {\n")],
    "row skip in 1-row strips too": [("    if (PIX == 1 || in_v) {\n", "    if (in_v) {\n")],
    "32-wide cull off": [(_CULL32, _CULL1)],
    "bin staging off (two walks)": [("constexpr int BIN_STAGE = 512;", "constexpr int BIN_STAGE = 1;")],
    "bin look-ahead off": [("constexpr int BIN_AHEAD = 4;", "constexpr int BIN_AHEAD = 1;")],
    "groups of 128": [("constexpr int GROUP = 64;", "constexpr int GROUP = 128;")],
    "1 pixel a thread": [("  if (n_items < FEW_ITEMS)\n", "  if (true)\n")],
    "2 pixels a thread": [("  if (n_items < FEW_ITEMS)\n", "  if (false)\n"),
                          (_LAUNCH_ELSE, _LAUNCH_ELSE.replace("(4)", "(2)"))],
    "4 pixels a thread": [("  if (n_items < FEW_ITEMS)\n", "  if (false)\n")],
    "8 pixels a thread": [("  if (n_items < FEW_ITEMS)\n", "  if (false)\n"),
                          (_LAUNCH_ELSE, _LAUNCH_ELSE.replace("(4)", "(8)"))],
}


def _nvcc_build(source: Path, lib_path: Path) -> ctypes.CDLL:
    from happypose_tpu_torch import csrc

    flags = [f for f in csrc.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([csrc._nvcc(), *flags, "-o", str(lib_path), str(source)], check=True)
    return ctypes.CDLL(str(lib_path))


def variant_source(step: str) -> str:
    """The committed kernel source with `STEPS[step]` applied."""
    from happypose_tpu_torch import csrc

    text = (Path(csrc.__file__).parent / "raster_fused.cu").read_text()
    for old, new in STEPS[step]:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {step!r}: {text.count(old)} places hold\n{old}")
        text = text.replace(old, new)
    return text


def _variant_library(step: str) -> ctypes.CDLL:
    from happypose_tpu_torch import csrc
    from happypose_tpu_torch.ops import rasterizer_fused as rf

    text = variant_source(step)
    csrc.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = csrc.BUILD_DIR / f"variant_{hashlib.sha256(text.encode()).hexdigest()[:16]}"
    stem.with_suffix(".cu").write_text(text)
    return rf._bind(_nvcc_build(stem.with_suffix(".cu"), stem.with_suffix(".so")))


@contextlib.contextmanager
def _kernels_from(lib: ctypes.CDLL):
    """The wrapper launches the kernels of `lib` inside this block."""
    from happypose_tpu_torch.ops import rasterizer_fused as rf

    committed = rf._kernel_library
    rf._kernel_library = lambda: lib
    try:
        yield
    finally:
        rf._kernel_library = committed


def _old_kernel(source: Path):
    """`raster(A, chunk_bbox, resolution)` of an earlier single-kernel
    source, built beside the port's own builds."""
    from happypose_tpu_torch import csrc
    from happypose_tpu_torch.ops import rasterizer_fused as rf

    csrc.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = _nvcc_build(source, csrc.BUILD_DIR / "libraster_fused_old.so")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.raster_fused_launch.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci, vp]
    lib.raster_fused_launch.restype = ci

    def raster(A, chunk_bbox, resolution):
        H, W = resolution
        out = torch.empty(A.shape[0], rf.N_OUT, H, W, dtype=torch.float32, device=A.device)
        err = lib.raster_fused_launch(
            A.data_ptr(), chunk_bbox.data_ptr(), out.data_ptr(), A.shape[0],
            A.shape[1] // rf.CHUNK, H, W, A.device.index,
            torch.cuda.current_stream(A.device).cuda_stream,
        )
        assert err == 0, err
        return out

    return raster


def _kernel_split(cs, fn) -> dict:
    """Mean device ms of each kernel (and memset) that a call of `fn`
    launches once, over five calls: the profiler can miss the first events
    of a window, so one call alone is not enough."""
    fn()
    torch.cuda.synchronize()
    split = {}
    for e in cs.profile_device(lambda: [fn() for _ in range(5)])[0]:
        name = next((n for n in cs.RASTER_KERNELS if n in e.key), e.key[:40])
        split[name] = e.device_time_total / e.count / 1e3
    return split


def bench_kernel(cs, args) -> dict:
    from happypose_tpu_torch.ops import rasterizer_fused as rf

    dev = torch.device("cuda", 0)
    old = _old_kernel(Path(args.old_source)) if args.old_source else None
    steps = {}
    if args.steps is not None:
        steps = {k: _variant_library(k) for k in STEPS if any(w in k for w in args.steps or [""])}
    results = {}
    for mesh in cs.KERNEL_MESHES:
        for B in args.batches or cs.BATCHES:
            A, bbox = cs.kernel_inputs(mesh, B, dev)

            def new():
                return rf.raster_fused(A, bbox, cs.RES)

            def bins_only():
                return rf._launch(A, bbox, cs.RES, None, None)

            out = new()
            row = dict(cs.raster_bound(A, bbox, out))
            turns = [("old", lambda: old(A, bbox, cs.RES))] if old else []
            turns = turns + [("new", new), ("new", new)] + turns
            for name, fn in turns:
                row.setdefault(f"{name}_ms", []).append(cs.cuda_ms(fn, args.runs, n_warmup=3))
            if old:
                diff = (old(A, bbox, cs.RES) != out).any(1).float().mean().item()
                row["pixels_differing_from_old"] = diff
            if args.steps is not None:
                row["split_ms"] = _kernel_split(cs, new)
                row["steps_ms"], row["steps_bins_only_ms"] = {}, {}
                for step, lib in (*steps.items(), ("the design", rf._kernel_library())):
                    with _kernels_from(lib):
                        assert torch.equal(new(), out), f"{step}: output differs"
                        row["steps_ms"][step] = cs.cuda_ms(new, args.runs, n_warmup=3)
                        row["steps_bins_only_ms"][step] = cs.cuda_ms(bins_only, args.runs, n_warmup=3)
            row["share_of_bound"] = row["bound_ms"] / statistics.median(row["new_ms"])
            results[f"{mesh}_B{B}"] = row
            cs.log(f"{mesh} B={B}: " + json.dumps(row))
    return results


def bench_frame(cs, args) -> dict:
    from happypose_tpu_torch.meshes import io
    from happypose_tpu_torch.meshes.database import MeshDataBase

    dev = torch.device("cuda", 0)
    db = cs.debug_mesh_db(MeshDataBase, io)
    obs, det = cs._synthetic_frame(db, dev)
    results = {}
    for name in ("megapose-RGB", "cosypose-RGB"):
        est = cs._load(name, db, dev)

        def run():
            return est.run_inference_pipeline(obs, det)

        run()
        times = [cs._timed(run)[1] for _ in range(3)]
        events, raster = cs.profile_device(run)
        results[name] = {
            "s_per_image": times,
            "device_kernels": sum(e.count for e in events),
            "rasterizer_kernels": sum(e.count for e in raster),
            "rasterizer_device_ms": sum(e.device_time_total for e in raster) / 1e3,
            "device_ms": sum(e.device_time_total for e in events) / 1e3,
        }
        cs.log(f"{name}: " + json.dumps(results[name]))
    return results


def bench_plain(cs, args) -> dict:
    from happypose_tpu_torch.ops import rasterizer_fused as rf

    dev = torch.device("cuda", 0)
    results = {}
    for mesh, B, res, f, n_plain in cs.KERNEL_SHAPES:
        if n_plain is None:
            continue
        A, bbox = cs.kernel_inputs(mesh, B, dev, res, f)
        out = rf.raster_fused(A, bbox, res)
        row = dict(cs.raster_bound(A, bbox, out))
        row["ms"] = cs.cuda_ms(lambda: rf.raster_fused(A, bbox, res), args.runs, n_warmup=3)
        row["plain_ms_one_call"] = cs.cuda_ms(
            lambda: rf.raster_fused_reference(A, bbox, res), 1, n_warmup=0)
        results[cs.shape_name(mesh, B, res)] = row
        cs.log(f"{cs.shape_name(mesh, B, res)}: " + json.dumps(row))
    return results


MODES = {"kernel": bench_kernel, "frame": bench_frame, "plain": bench_plain}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("mode", choices=tuple(MODES))
    parser.add_argument("--old-source")
    parser.add_argument("--steps", nargs="*", metavar="WORD",
                        help="time the variants (those whose name holds a WORD; all if none given)")
    parser.add_argument("--batches", nargs="*", type=int, help="batch sizes (default: chip_smoke.py's)")
    parser.add_argument("--runs", type=int, default=10)
    parser.add_argument("--root", default=str(ROOT),
                        help="tree inside this checkout to take the package from")
    parser.add_argument("--tag", default="")
    parser.add_argument("--out-dir", default=str(ROOT / "bench_out"))
    args = parser.parse_args()
    root = Path(args.root).resolve()
    if root != ROOT and ROOT not in root.parents:
        parser.error(f"--root must lie inside {ROOT}")
    if root != ROOT and "happypose_tpu_torch" in sys.modules:
        parser.error("--root: run this file itself, not with -m")
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    device = cs.phase_device()
    torch.cuda.set_device(0)
    results = {"device": device, "root": str(root.relative_to(ROOT)),
               "results": MODES[args.mode](cs, args)}
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"bench_raster_{args.mode}{args.tag}.json").write_text(json.dumps(results, indent=1))


if __name__ == "__main__":
    main()
