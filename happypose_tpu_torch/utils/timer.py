"""Timers with pause/resume + a device-sync variant.

Parity targets: happypose/toolbox/utils/timer.py:20-55
(`Timer`) and megapose/training/utils.py:218-266 (`CudaTimer`/`SimpleTimer`).
Port of `happypose_tpu/utils/timer.py`: `DeviceTimer` waits for the card
with `torch.cuda.synchronize()` where the JAX package blocks on the result."""

from __future__ import annotations

import datetime
import time
from typing import Optional

import torch


class Timer:
    def __init__(self):
        self.reset()

    def reset(self):
        self.start_time: Optional[float] = None
        self.elapsed = 0.0
        self.is_running = False

    def start(self):
        self.elapsed = 0.0
        self.start_time = time.time()
        self.is_running = True
        return self

    def pause(self):
        if self.is_running:
            self.elapsed += time.time() - self.start_time
            self.is_running = False
        return datetime.timedelta(seconds=self.elapsed)

    def resume(self):
        if not self.is_running:
            self.start_time = time.time()
            self.is_running = True
        return self

    def stop(self):
        self.pause()
        return datetime.timedelta(seconds=self.elapsed)


class DeviceTimer:
    """Times device work: the clock is read after the card has finished
    (`device` on the card: `torch.cuda.synchronize()` before each reading;
    on the CPU PyTorch has finished when the call returns)."""

    def __init__(self, enabled: bool = True, device="cuda"):
        self.enabled = enabled
        self.device = torch.device(device)
        self.elapsed = 0.0

    def synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def time(self, fn, *args, **kwargs):
        if not self.enabled:
            return fn(*args, **kwargs)
        self.synchronize()
        t0 = time.time()
        out = fn(*args, **kwargs)
        self.synchronize()
        self.elapsed += time.time() - t0
        return out
