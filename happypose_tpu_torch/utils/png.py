"""A small PNG codec on `zlib` and `struct` from the standard library.

The JAX package reads and writes its PNG files (BOP frames, depth maps,
masks, mesh textures, overlays) through PIL; it has no module like this
one. The port keeps its own codec so that a dataset reads the same on a
machine without Pillow. Supported, on read and on write: non-interlaced
8-bit grey, RGB and RGBA, and 16-bit grey (BOP depth). On read every one of
the five row filters is undone. Any other file (palette, interlaced, other
bit depths, a damaged stream) raises `ValueError` naming the file.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Union

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# (bit depth, colour type) -> (channels, bytes per channel)
_LAYOUTS = {(8, 0): (1, 1), (8, 2): (3, 1), (8, 6): (4, 1), (16, 0): (1, 2)}


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The Paeth predictor on int arrays (a = left, b = up, c = up-left)."""
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(ft: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Undo the row filters. `ft` [H] filter types, `data` [H, W, bpp] uint8
    filtered bytes grouped by pixel; returns the raw bytes, same shape."""
    if not ft.any():
        return data
    H, W, bpp = data.shape
    if ft.max() <= 2:
        # None / Sub / Up need no earlier byte of their own row but the one
        # `bpp` to the left: a running sum modulo 256 along the row
        out = np.empty_like(data)
        prev = np.zeros((W, bpp), np.uint8)
        for y in range(H):
            row = data[y]
            if ft[y] == 1:
                row = np.cumsum(row, axis=0, dtype=np.uint8)
            elif ft[y] == 2:
                row = row + prev
            out[y] = row
            prev = row
        return out
    # Average and Paeth read the decoded left, up and up-left bytes: every
    # pixel of an anti-diagonal x + y = d depends only on diagonals d - 1
    # and d - 2, so the image is decoded one diagonal at a time
    out = np.zeros((H + 1, W + 1, bpp), np.int32)
    src = data.astype(np.int32)
    ftc = ft.astype(np.int32)[:, None]
    for d in range(H + W - 1):
        ys = np.arange(max(0, d - W + 1), min(H - 1, d) + 1)
        xs = d - ys
        a = out[ys + 1, xs]
        b = out[ys, xs + 1]
        c = out[ys, xs]
        f = ftc[ys]
        pred = np.where(
            f == 1, a,
            np.where(f == 2, b,
                     np.where(f == 3, (a + b) >> 1,
                              np.where(f == 4, _paeth(a, b, c), 0))),
        )
        out[ys + 1, xs + 1] = (src[ys, xs] + pred) & 255
    return out[1:, 1:].astype(np.uint8)


def decode_png(buf: bytes, name: str = "<bytes>") -> np.ndarray:
    """PNG bytes -> `[H, W]` (grey) or `[H, W, C]` array, uint8 or uint16."""
    if buf[:8] != _SIGNATURE:
        raise ValueError(f"not a PNG file: {name}")
    pos = 8
    header = None
    idat = []
    while pos + 8 <= len(buf):
        (length,), kind = struct.unpack(">I", buf[pos:pos + 4]), buf[pos + 4:pos + 8]
        body = buf[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"PNG without IHDR or IDAT: {name}")
    W, H, depth, ctype, _, _, interlace = header
    if (depth, ctype) not in _LAYOUTS or interlace != 0:
        raise ValueError(
            f"unsupported PNG (bit depth {depth}, colour type {ctype}, "
            f"interlace {interlace}): {name}"
        )
    channels, width = _LAYOUTS[(depth, ctype)]
    bpp = channels * width
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"damaged PNG stream ({e}): {name}") from e
    if len(raw) != H * (1 + W * bpp):
        raise ValueError(f"PNG stream has the wrong length: {name}")
    rows = np.frombuffer(raw, np.uint8).reshape(H, 1 + W * bpp)
    ft = rows[:, 0]
    if ft.size and ft.max() > 4:
        raise ValueError(f"PNG row filter {int(ft.max())} does not exist: {name}")
    data = _unfilter(ft, rows[:, 1:].reshape(H, W, bpp))
    if width == 2:
        img = np.ascontiguousarray(data).view(">u2").astype(np.uint16)
        return img.reshape(H, W)
    data = np.ascontiguousarray(data)
    return data.reshape(H, W) if channels == 1 else data


def read_png(path: Union[str, Path]) -> np.ndarray:
    """Read a PNG file (see `decode_png`)."""
    path = Path(path)
    return decode_png(path.read_bytes(), str(path))


def _chunk(kind: bytes, body: bytes) -> bytes:
    crc = zlib.crc32(kind + body) & 0xFFFFFFFF
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", crc)


def encode_png(img: np.ndarray, row_filter: int = 0) -> bytes:
    """`[H, W]` or `[H, W, 1|3|4]` uint8, or `[H, W]` uint16 -> PNG bytes.

    `row_filter` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth) is applied to
    every row; it changes the file's size, never its pixels."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.dtype == np.uint16 and img.ndim == 2:
        depth, ctype = 16, 0
        data = img.astype(">u2").view(np.uint8).reshape(img.shape[0], -1, 2)
    elif img.dtype == np.uint8 and (
        img.ndim == 2 or (img.ndim == 3 and img.shape[2] in (3, 4))
    ):
        depth = 8
        ctype = {1: 0, 3: 2, 4: 6}[1 if img.ndim == 2 else img.shape[2]]
        data = img.reshape(img.shape[0], img.shape[1], -1)
    else:
        raise ValueError(
            f"cannot write a {img.dtype} array of shape {img.shape} as PNG"
        )
    H, W = img.shape[:2]
    if row_filter not in (0, 1, 2, 3, 4):
        raise ValueError(f"PNG row filter {row_filter} does not exist")
    if row_filter:
        x = np.zeros((H + 1, W + 1, data.shape[2]), np.int32)
        x[1:, 1:] = data
        a, b, c = x[1:, :-1], x[:-1, 1:], x[:-1, :-1]
        pred = (a, b, (a + b) >> 1, _paeth(a, b, c))[row_filter - 1]
        data = ((x[1:, 1:] - pred) & 255).astype(np.uint8)
    rows = np.empty((H, 1 + W * data.shape[2]), np.uint8)
    rows[:, 0] = row_filter
    rows[:, 1:] = data.reshape(H, -1)
    return (
        _SIGNATURE
        + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype, 0, 0, 0))
        + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
        + _chunk(b"IEND", b"")
    )


def write_png(path: Union[str, Path], img: np.ndarray, row_filter: int = 0) -> None:
    """Write an array as a PNG file (see `encode_png`)."""
    Path(path).write_bytes(encode_png(img, row_filter))
