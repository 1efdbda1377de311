"""CUDA sources of the port and their build.

Each `<stem>.cu` file here exports a plain C interface. `load_library`
compiles it with `nvcc` for Hopper (`sm_90a`) into `csrc/build/` at first
use, keyed by a hash of the source and the flags so an edited source is
rebuilt, and loads the shared library with `ctypes`. What the compiler
printed (`-Xptxas -v`: registers, shared memory and spills of each kernel)
is kept beside the library (`build_log`). The build runs on the machine
with the card; nothing here is imported or compiled at package import
time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(stem: str) -> Path:
    """Where the build of `<stem>.cu` for the current source lives."""
    src = (_DIR / f"{stem}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{stem}_{digest}.so"


def build(stem: str) -> Path:
    """Compile `<stem>.cu` unless the build for this source exists.

    The library is written to a temporary name and renamed into place, so a
    concurrent or interrupted build never leaves a partial file behind."""
    out = library_path(stem)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(_DIR / f"{stem}.cu")]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {stem}.cu (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def build_log(stem: str) -> str:
    """What nvcc and ptxas printed when the current build was made."""
    return build(stem).with_suffix(".log").read_text()


def load_library(stem: str) -> ctypes.CDLL:
    """Build (if needed) and load `<stem>.cu`'s shared library, once per
    process."""
    lib = _LOADED.get(stem)
    if lib is None:
        lib = ctypes.CDLL(str(build(stem)))
        _LOADED[stem] = lib
    return lib
