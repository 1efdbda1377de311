"""Flax's msgpack checkpoint format, read and written without msgpack or Flax.

The JAX package writes its run directories' `checkpoint.msgpack` with
`flax.serialization.to_bytes`: a msgpack map of maps whose leaves are
arrays packed as msgpack extension types. This module decodes and encodes
the subset of msgpack that format uses:

- nil, bool, ints and floats of every width, str, bin, arrays, maps;
- ext type 1, an ndarray: the msgpack array `[shape, dtype name, raw
  bytes]` (C order, the writer's byte order: little-endian on every
  machine the package runs on); ext type 2, a Python complex `[re, im]`;
  ext type 3, a numpy scalar (an ndarray of shape `()`);
- Flax's chunked arrays: an array over `MAX_CHUNK_SIZE` bytes is written as
  a map `{"__msgpack_chunked_array__": True, "shape": {"0": d0, ...},
  "chunks": {"0": flat0, ...}}` and put back together on reading.

Arrays come back as numpy arrays that view the decoded buffer (no copy;
`read_file` reads into a `bytearray`, so they are writable). The dtypes
numpy lacks come back as torch tensors of the same bits: `bfloat16` and
the float8 types torch has are read as 8- or 16-bit integers and viewed as
the torch dtype, never converted through float32. A dtype with neither a
numpy nor a torch counterpart (`int4`, `float8_e3m4`, ...) raises.

`msgpack_serialize` writes the bytes of
`flax.serialization.msgpack_serialize(tree, in_place=True)` for the same
tree of dicts, lists and numpy arrays (torch tensors are written as the
numpy array of their bits and their dtype's name): for a tree of dicts,
the bytes `flax.serialization.to_bytes` writes. Keys are written in the
tree's own order; Flax's `msgpack_serialize` without `in_place` sorts them
first, as any JAX tree map does, and a jitted JAX tree is already sorted.

Every malformed input (truncated, corrupt, trailing bytes, an unknown
dtype) raises `FlaxMsgpackError`.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, Dict, List, NamedTuple, Union

import numpy as np
import torch

MAX_CHUNK_SIZE = 2**30  # flax.serialization.MAX_CHUNK_SIZE: bytes of one array leaf
CHUNKED = "__msgpack_chunked_array__"

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3

# dtypes JAX writes that numpy lacks and torch has: their bits travel as
# same-width ints (numpy's, torch's)
_TORCH_ONLY = {
    name: (getattr(torch, name), *((np.int16, torch.int16) if name == "bfloat16"
                                   else (np.uint8, torch.uint8)))
    for name in ("bfloat16", "float8_e4m3fn", "float8_e5m2", "float8_e4m3fnuz",
                 "float8_e5m2fnuz", "float8_e8m0fnu")
    if hasattr(torch, name)
}
_TORCH_NAMES = {t: name for name, (t, _, _) in _TORCH_ONLY.items()}


class FlaxMsgpackError(ValueError):
    """A file or buffer that is not a complete Flax msgpack checkpoint."""


class ExtType(NamedTuple):
    """An extension type this format does not define, kept as it came."""

    code: int
    data: bytes


Buffer = Union[bytes, bytearray, memoryview]


# ------------------------------------------------------------------ decoding


class _Decoder:
    def __init__(self, data: Buffer, raw: bool = False):
        self.mv = memoryview(data).cast("B")
        self.pos = 0
        self.raw = raw  # str and bin as bytes and views: an ndarray's payload

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.mv):
            raise FlaxMsgpackError(f"truncated: {n} bytes wanted at offset {self.pos}, "
                                   f"{len(self.mv) - self.pos} left")
        out = self.mv[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def bin_(self, n: int):
        b = self.take(n)
        return b if self.raw else bytes(b)  # an array's payload stays a view

    def str_(self, n: int):
        b = self.take(n)
        return bytes(b) if self.raw else str(b, "utf-8")

    def ext(self, n: int):
        code = self.unpack(">b")
        return _ext(code, self.take(n))

    def map_(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            if not isinstance(k, (str, bytes)):
                raise FlaxMsgpackError(f"map key of type {type(k).__name__}")
            out[k] = self.obj()
        return out

    def obj(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b <= 0x8F:
            return self.map_(b & 0x0F)
        if b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if b <= 0xBF:
            return self.str_(b & 0x1F)
        op = _OPS.get(b)
        if op is None:
            raise FlaxMsgpackError(f"byte 0x{b:02x} at offset {self.pos - 1} starts no object")
        return op(self)


_OPS = {
    0xC0: lambda d: None,
    0xC2: lambda d: False,
    0xC3: lambda d: True,
    0xC4: lambda d: d.bin_(d.unpack(">B")),
    0xC5: lambda d: d.bin_(d.unpack(">H")),
    0xC6: lambda d: d.bin_(d.unpack(">I")),
    0xC7: lambda d: d.ext(d.unpack(">B")),
    0xC8: lambda d: d.ext(d.unpack(">H")),
    0xC9: lambda d: d.ext(d.unpack(">I")),
    0xCA: lambda d: d.unpack(">f"),
    0xCB: lambda d: d.unpack(">d"),
    0xCC: lambda d: d.unpack(">B"),
    0xCD: lambda d: d.unpack(">H"),
    0xCE: lambda d: d.unpack(">I"),
    0xCF: lambda d: d.unpack(">Q"),
    0xD0: lambda d: d.unpack(">b"),
    0xD1: lambda d: d.unpack(">h"),
    0xD2: lambda d: d.unpack(">i"),
    0xD3: lambda d: d.unpack(">q"),
    0xD4: lambda d: d.ext(1),
    0xD5: lambda d: d.ext(2),
    0xD6: lambda d: d.ext(4),
    0xD7: lambda d: d.ext(8),
    0xD8: lambda d: d.ext(16),
    0xD9: lambda d: d.str_(d.unpack(">B")),
    0xDA: lambda d: d.str_(d.unpack(">H")),
    0xDB: lambda d: d.str_(d.unpack(">I")),
    0xDC: lambda d: [d.obj() for _ in range(d.unpack(">H"))],
    0xDD: lambda d: [d.obj() for _ in range(d.unpack(">I"))],
    0xDE: lambda d: d.map_(d.unpack(">H")),
    0xDF: lambda d: d.map_(d.unpack(">I")),
}


def _decode_all(data: Buffer, raw: bool = False) -> Any:
    d = _Decoder(data, raw)
    out = d.obj()
    if d.pos != len(d.mv):
        raise FlaxMsgpackError(f"{len(d.mv) - d.pos} bytes after the object")
    return out


def _array(payload: memoryview) -> Union[np.ndarray, torch.Tensor]:
    """An ndarray extension's payload: `[shape, dtype name, raw bytes]`."""
    parts = _decode_all(payload, raw=True)
    if not (isinstance(parts, list) and len(parts) == 3 and isinstance(parts[0], list)
            and isinstance(parts[1], bytes)):
        raise FlaxMsgpackError("an ndarray is not [shape, dtype name, bytes]")
    shape, name, buf = tuple(parts[0]), parts[1].decode("ascii"), parts[2]
    if name in _TORCH_ONLY:
        torch_dtype, raw_dtype, _ = _TORCH_ONLY[name]
        a = np.frombuffer(buf, raw_dtype).reshape(shape)
        return torch.from_numpy(a if a.flags.writeable else a.copy()).view(torch_dtype)
    try:
        dtype = np.dtype(name)
    except TypeError:
        dtype = None
    # numpy's own types only: a name `ml_dtypes` registers resolves only where it is imported
    if dtype is None or dtype.type.__module__ != "numpy":
        raise FlaxMsgpackError(f"dtype {name!r} has no numpy or torch counterpart")
    if dtype.hasobject:
        raise FlaxMsgpackError(f"dtype {name!r} holds Python objects")
    try:
        return np.frombuffer(buf, dtype).reshape(shape)
    except ValueError as e:
        raise FlaxMsgpackError(f"array of {name} {shape}: {e}") from e


def _ext(code: int, payload: memoryview) -> Any:
    if code == EXT_NDARRAY:
        return _array(payload)
    if code == EXT_COMPLEX:
        re, im = _decode_all(payload)
        return complex(re, im)
    if code == EXT_NPSCALAR:
        return _array(payload)[()]
    return ExtType(code, bytes(payload))


def _unchunk(d: Dict) -> Union[np.ndarray, torch.Tensor]:
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    cat = torch.cat if isinstance(chunks[0], torch.Tensor) else np.concatenate
    return cat(chunks).reshape(shape)


def _unchunk_tree(d: Any) -> Any:
    """Flax's `_unchunk_array_leaves_in_place`: the tree's root and the
    values of its maps."""
    if isinstance(d, dict):
        if CHUNKED in d:
            return _unchunk(d)
        for k, v in d.items():
            if isinstance(v, dict):
                d[k] = _unchunk_tree(v)
    return d


def msgpack_restore(data: Buffer) -> Any:
    """The tree of `flax.serialization.msgpack_restore(data)`: dicts, lists,
    Python scalars, numpy arrays and scalars, and torch tensors for the
    dtypes numpy lacks."""
    try:
        return _unchunk_tree(_decode_all(data))
    except FlaxMsgpackError:
        raise
    except (KeyError, TypeError, ValueError, UnicodeDecodeError, struct.error,
            RuntimeError) as e:
        raise FlaxMsgpackError(f"corrupt Flax msgpack: {type(e).__name__}: {e}") from e


def read_file(path: Union[str, Path]) -> Any:
    """`msgpack_restore` of a file, read into one writable buffer that the
    arrays view."""
    path = Path(path)
    buf = bytearray(path.stat().st_size)
    with open(path, "rb") as f:
        n = f.readinto(buf)
    return msgpack_restore(memoryview(buf)[:n])


# ------------------------------------------------------------------ encoding


def _head(out: List[bytes], n: int, small: int, small_max: int, fmts) -> None:
    """A length-prefixed header: fix form under `small_max`, else the
    smallest of `fmts` ((marker, struct format, limit), ...)."""
    if n < small_max:
        out.append(bytes([small | n]))
        return
    for marker, fmt, limit in fmts:
        if n < limit:
            out.append(bytes([marker]) + struct.pack(fmt, n))
            return
    raise FlaxMsgpackError(f"length {n} does not fit msgpack")


_STR = ((0xD9, ">B", 1 << 8), (0xDA, ">H", 1 << 16), (0xDB, ">I", 1 << 32))
_BIN = ((0xC4, ">B", 1 << 8), (0xC5, ">H", 1 << 16), (0xC6, ">I", 1 << 32))
_ARR = ((0xDC, ">H", 1 << 16), (0xDD, ">I", 1 << 32))
_MAP = ((0xDE, ">H", 1 << 16), (0xDF, ">I", 1 << 32))
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _int(out: List[bytes], x: int) -> None:
    """msgpack-python's choice: the smallest form, unsigned for x > 0."""
    if -32 <= x < 128:
        out.append(struct.pack(">b", x) if x < 0 else bytes([x]))
    elif x > 0:
        for marker, fmt, limit in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                   (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if x < limit:
                out.append(bytes([marker]) + struct.pack(fmt, x))
                return
        raise FlaxMsgpackError(f"int {x} does not fit msgpack")
    else:
        for marker, fmt, limit in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                                   (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
            if x >= -limit:
                out.append(bytes([marker]) + struct.pack(fmt, x))
                return
        raise FlaxMsgpackError(f"int {x} does not fit msgpack")


def _str(out: List[bytes], s: str) -> None:
    b = s.encode("utf-8")
    _head(out, len(b), 0xA0, 32, _STR)
    out.append(b)


def _bin(out: List[bytes], b) -> None:
    _head(out, len(b), 0, 0, _BIN)
    out.append(b)


def _ext_head(out: List[bytes], code: int, n: int) -> None:
    if n in _FIXEXT:
        out.append(bytes([_FIXEXT[n], code]))
        return
    for marker, fmt, limit in ((0xC7, ">B", 1 << 8), (0xC8, ">H", 1 << 16),
                               (0xC9, ">I", 1 << 32)):
        if n < limit:
            out.append(bytes([marker]) + struct.pack(fmt, n) + bytes([code]))
            return
    raise FlaxMsgpackError(f"extension of {n} bytes does not fit msgpack")


def _as_numpy(x) -> tuple:
    """(dtype name, C-contiguous numpy array of the bits) of an array leaf."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype in _TORCH_NAMES:
            name = _TORCH_NAMES[x.dtype]
            return name, x.view(_TORCH_ONLY[name][2]).numpy()
        x = x.numpy()
    x = np.asarray(x)
    if not x.flags.c_contiguous:
        x = np.array(x, order="C")
    if x.dtype.hasobject or x.dtype.isalignedstruct:
        raise FlaxMsgpackError("object and structured dtypes are not serializable")
    return x.dtype.name, x


def _ndarray(out: List[bytes], code: int, x) -> None:
    """Flax's `_ndarray_to_bytes` inside an extension of type `code`."""
    name, a = _as_numpy(x)
    inner: List[bytes] = [b"\x93"]
    _head(inner, len(a.shape), 0x90, 16, _ARR)
    for n in a.shape:
        _int(inner, int(n))
    _str(inner, name)
    data = memoryview(a.reshape(-1).view(np.uint8))
    _head(inner, len(data), 0, 0, _BIN)
    n = sum(len(p) for p in inner) + len(data)
    _ext_head(out, code, n)
    out.extend(inner)
    out.append(data)


def _is_array(x) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor))


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else x.nbytes


def _chunk(x) -> Dict:
    """Flax's `_chunk`: the flat array in pieces of `MAX_CHUNK_SIZE` bytes."""
    itemsize = x.element_size() if isinstance(x, torch.Tensor) else x.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = x.reshape(-1)
    n = flat.numel() if isinstance(flat, torch.Tensor) else flat.size
    return {CHUNKED: True, "shape": {str(i): d for i, d in enumerate(x.shape)},
            "chunks": {str(i): flat[j:j + size] for i, j in enumerate(range(0, n, size))}}


def _maybe_chunk(x):
    return _chunk(x) if _is_array(x) and _nbytes(x) > MAX_CHUNK_SIZE else x


def _pack(out: List[bytes], x: Any) -> None:
    if x is None:
        out.append(b"\xc0")
    elif x is True or x is False:
        out.append(b"\xc3" if x else b"\xc2")
    elif type(x) is int:
        _int(out, x)
    elif type(x) is float:
        out.append(b"\xcb" + struct.pack(">d", x))
    elif type(x) is str:
        _str(out, x)
    elif type(x) is bytes:
        _bin(out, x)
    elif type(x) is dict:
        _head(out, len(x), 0x80, 16, _MAP)
        for k, v in x.items():
            _pack(out, k)
            _pack(out, _maybe_chunk(v))
    elif type(x) is list:
        _head(out, len(x), 0x90, 16, _ARR)
        for v in x:
            _pack(out, v)
    elif _is_array(x):
        _ndarray(out, EXT_NDARRAY, x)
    elif isinstance(x, np.generic):
        _ndarray(out, EXT_NPSCALAR, np.asarray(x))
    elif type(x) is complex:
        inner: List[bytes] = [b"\x92"]
        _pack(inner, x.real)
        _pack(inner, x.imag)
        payload = b"".join(inner)
        _ext_head(out, EXT_COMPLEX, len(payload))
        out.append(payload)
    else:  # msgpack's strict types: no tuple, no subclass
        raise FlaxMsgpackError(f"can not serialize {type(x).__name__!r} object")


def msgpack_serialize(tree: Any) -> bytes:
    """The bytes of `flax.serialization.msgpack_serialize(tree,
    in_place=True)` for a tree of dicts (str keys), lists, Python scalars,
    complex numbers, numpy arrays and scalars, and torch tensors."""
    out: List[bytes] = []
    _pack(out, _maybe_chunk(tree))
    return b"".join(out)


def write_file(path: Union[str, Path], tree: Any) -> Path:
    path = Path(path)
    path.write_bytes(msgpack_serialize(tree))
    return path
