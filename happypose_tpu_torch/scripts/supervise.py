"""Stall watchdog for long device jobs.

PyTorch port of `happypose_tpu/scripts/supervise.py`. A job can wedge on
the device and block forever with no exception to catch. This supervisor
watches the job's progress file (anything the job appends to, e.g. its
JSON-lines log); if the file stops growing for --stall-seconds it kills
the child's process group, waits until the card answers a tiny CUDA
operation in a child process again, and relaunches the command. The
command must be resumable (e.g. run_pose_training --resume --save-every N).
The child is polled every min(15 s, a third of either stall limit).

Usage:
  python -m happypose_tpu_torch.scripts.supervise \
      --watch <run_dir>/log.txt --stall-seconds 300 --max-restarts 8 -- \
      python -m happypose_tpu_torch.scripts.run_pose_training --resume ...
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

from happypose_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def _size(path: Path) -> int:
    try:
        return path.stat().st_size
    except OSError:
        return -1


def _device_alive(timeout_s: float = 75.0) -> bool:
    """Probe the card with a tiny CUDA operation in a throwaway process (a
    wedged runtime blocks forever, so the probe must be killable)."""
    code = "import torch; print(torch.ones(2, 2, device='cuda').sum().item())"
    try:
        r = subprocess.run(
            [sys.executable, "-c", code],
            timeout=timeout_s,
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
        )
        return r.returncode == 0
    except subprocess.TimeoutExpired:
        return False


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--watch", type=Path, required=True,
                   help="file the job appends progress to")
    p.add_argument("--stall-seconds", type=float, default=300.0)
    p.add_argument("--startup-grace-seconds", type=float, default=1500.0,
                   help="stall threshold used until the watch file first "
                        "changes: set-up (data, kernel builds) may write "
                        "nothing for minutes")
    p.add_argument("--max-restarts", type=int, default=8)
    p.add_argument("--probe-wait-seconds", type=float, default=1800.0,
                   help="max time to wait for the card to answer, per restart")
    p.add_argument("cmd", nargs=argparse.REMAINDER,
                   help="-- followed by the job command")
    args = p.parse_args(argv)
    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        p.error("no command given (put it after --)")

    poll = min(15.0, args.stall_seconds / 3, args.startup_grace_seconds / 3)
    for attempt in range(args.max_restarts + 1):
        logger.info(f"launch attempt {attempt}: {' '.join(cmd)}")
        # own process group so a stalled child (and its threads) can be
        # killed exactly, never by pattern
        child = subprocess.Popen(cmd, start_new_session=True)
        last_size = _size(args.watch)
        last_change = time.time()
        progressed = False  # watch file changed at least once this attempt
        stalled = False
        while True:
            try:
                rc = child.wait(timeout=poll)
                if rc == 0:
                    logger.info("job completed")
                    return 0
                logger.warning(f"job exited rc={rc}")
                break
            except subprocess.TimeoutExpired:
                pass
            size = _size(args.watch)
            limit = (
                args.stall_seconds if progressed
                else args.startup_grace_seconds
            )
            if size != last_size:
                last_size = size
                last_change = time.time()
                progressed = True
            elif time.time() - last_change > limit:
                logger.warning(
                    f"no progress on {args.watch} for "
                    f"{limit:.0f}s - killing pgid {child.pid}"
                )
                stalled = True
                os.killpg(child.pid, signal.SIGKILL)
                child.wait()
                break
        if attempt == args.max_restarts:
            break
        if stalled:
            t0 = time.time()
            while time.time() - t0 < args.probe_wait_seconds:
                if _device_alive():
                    logger.info("device answers again; relaunching")
                    break
                time.sleep(30.0)
            else:
                logger.error("device never recovered")
                return 2
    logger.error("max restarts exhausted")
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
