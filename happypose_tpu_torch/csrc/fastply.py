"""The native binary-PLY decoder `fastply.cpp`, built with `g++` at first
use into `csrc/build/` (keyed by a hash of the source) and bound with
ctypes (the port's own copy of `happypose_tpu/csrc/__init__.py`).

The decoder is host-side IO, so a machine without `g++` reads PLY files with
the Python parser of `meshes/io.py` instead (`load_ply_native` returns None).
With `g++` present, a build that fails raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

from happypose_tpu_torch.csrc import BUILD_DIR

_SRC = Path(__file__).resolve().parent / "fastply.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def library_path() -> Path:
    digest = hashlib.sha256(
        _SRC.read_bytes() + " ".join(GXX_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"libfastply_{digest}.so"


def build() -> Optional[Path]:
    """Compile `fastply.cpp` unless the build for this source exists; None
    when there is no `g++`."""
    out = library_path()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [gxx, *GXX_FLAGS, str(_SRC), "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(
                f"g++ failed for fastply.cpp (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def get_fastply() -> Optional[ctypes.CDLL]:
    """The compiled library, or None where there is no `g++`."""
    global _LIB, _TRIED
    if _LIB is None and not _TRIED:
        _TRIED = True
        path = build()
        if path is not None:
            lib = ctypes.CDLL(str(path))
            lib.fastply_parse.restype = ctypes.c_void_p
            lib.fastply_parse.argtypes = [ctypes.c_char_p]
            lib.fastply_counts.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_long),
                ctypes.POINTER(ctypes.c_long),
                ctypes.POINTER(ctypes.c_int),
            ]
            lib.fastply_copy.argtypes = [
                ctypes.c_void_p,
                np.ctypeslib.ndpointer(np.float32),
                np.ctypeslib.ndpointer(np.int32),
                ctypes.c_void_p,
            ]
            lib.fastply_free.argtypes = [ctypes.c_void_p]
            _LIB = lib
    return _LIB


def load_ply_native(path) -> Optional[dict]:
    """Parse a binary PLY natively; None if the decoder does not support
    the file (or there is no `g++`): the caller then parses it in Python."""
    lib = get_fastply()
    if lib is None:
        return None
    handle = lib.fastply_parse(str(path).encode())
    if not handle:
        return None
    try:
        nv = ctypes.c_long()
        nf = ctypes.c_long()
        hc = ctypes.c_int()
        lib.fastply_counts(handle, ctypes.byref(nv), ctypes.byref(nf),
                           ctypes.byref(hc))
        vertices = np.empty((nv.value, 3), np.float32)
        faces = np.empty((max(nf.value, 1), 3), np.int32)
        colors = np.empty((nv.value, 3), np.uint8) if hc.value else None
        lib.fastply_copy(
            handle, vertices, faces,
            colors.ctypes.data_as(ctypes.c_void_p) if hc.value else None,
        )
        return {
            "vertices": vertices,
            "faces": faces[: nf.value],
            "colors": colors,
        }
    finally:
        lib.fastply_free(handle)
