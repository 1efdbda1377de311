"""Run one cell of the benchmark once and print its result.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result: `correct`, `attempted`, `failed`, `metrics`, `device`, with
`--trace 1` also `breakdown`, and last `checks`, each compared number
beside its limit; the same numbers are the last lines of standard error.
Earlier lines on standard error give the card, its power limit, the
precision flags and the graph keys warmed. Without a CUDA card, with fewer
cards than the cell asks for, or with JAX, Flax or the JAX package loaded
once the window has closed, it prints no result and exits with 2.

`--control 1` (not part of a benchmark run) computes, beside the
program's numbers, the control's (the reference in TF32 at the program's
positions) and those of the faults the runner plants in the reference put
in the program's place: the readings the limits are set from.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "benchmark" / ".cache"


def _environment():
    """Set before anything imports torch or triton: the compile caches at
    fixed paths inside the checkout, and one host thread for PyTorch's and
    OpenMP's CPU work, so that the load comes from one process with few
    threads (on an H100 host of 8 cores, three megapose-track runs of one
    seed read 313-365 poses/s with the default threads, 325-339 with one)."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["OMP_NUM_THREADS"] = "1"


def _card_lines(torch, chips: int):
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"nvidia-smi unavailable ({e})"
    print(f"benchmark: cards {torch.cuda.device_count()} (cell uses {chips}); {smi}",
          file=sys.stderr)
    print(f"benchmark: torch {torch.__version__} cuda {torch.version.cuda}; tf32 matmul "
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn {torch.backends.cudnn.allow_tf32}; "
          f"cudnn.benchmark {torch.backends.cudnn.benchmark}", file=sys.stderr)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _environment()

    import torch

    torch.set_num_threads(1)

    from benchmark import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: cell {args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              T_PROCESS, device="cuda", control=bool(args.control))
    _card_lines(torch, cell["chips"])
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 2
    for name, seconds in result.get("breakdown", {}).get("device_ops", [])[:5]:
        print(f"benchmark: traced stretch, top device op {seconds:.6f} s: {name[:120]}",
              file=sys.stderr)
    checks = result["checks"]
    for name, c in (checks.items() if not args.control else []):
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
