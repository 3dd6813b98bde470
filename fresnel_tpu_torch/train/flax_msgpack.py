"""Reader of Flax msgpack checkpoints, in pure Python and numpy.

Counterpart of `flax.serialization.msgpack_restore` (as the JAX package's
`Trainer.load_checkpoint` uses it) with no `msgpack` and no `ml_dtypes`:
the port must read the committed checkpoints on machines that have
neither.  The format is msgpack (nil, bool, int and uint of every width,
float32 / float64, str, bin, array and map in every width, fixext and
ext 8 / 16 / 32) with Flax's three ext codes:
  1  ndarray:  msgpack (shape, dtype name, C-order bytes);
  2  complex:  msgpack (real, imag);
  3  numpy scalar, encoded as a 0-d ndarray.
Arrays larger than 2^30 bytes are written by Flax as
{"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}} and
joined back here.  `bfloat16` arrays are widened to float32 exactly (the
bf16 bits are the high half of the float32's).  An unknown ext code or
dtype name raises ValueError.

    read_flat(path) -> {"params/model/params/MLP_0/Dense_0/kernel": array, ...}
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"

# Fixed-width scalars: first byte -> (struct format, size).
_SCALARS = {
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
# Length-prefixed types: first byte -> (kind, width of the length).
_SIZED = {
    0xC4: ("bin", 1), 0xC5: ("bin", 2), 0xC6: ("bin", 4),
    0xC7: ("ext", 1), 0xC8: ("ext", 2), 0xC9: ("ext", 4),
    0xD9: ("str", 1), 0xDA: ("str", 2), 0xDB: ("str", 4),
    0xDC: ("array", 2), 0xDD: ("array", 4),
    0xDE: ("map", 2), 0xDF: ("map", 4),
}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_LEN_FMT = {1: ">B", 2: ">H", 4: ">I"}


def _dtype(name) -> np.dtype:
    """A Flax dtype name -> numpy dtype; bfloat16 -> uint16 bits (widened
    by the caller)."""
    if isinstance(name, bytes):
        name = name.decode("utf-8")
    if name == "bfloat16":
        return np.dtype("<u2")
    try:
        dt = np.dtype(name)
    except TypeError as e:
        raise ValueError(f"unknown dtype name {name!r}") from e
    if dt.kind not in "biufc" or dt.name != name:
        raise ValueError(f"unknown dtype name {name!r}")
    return dt


def _ndarray(data: bytes) -> np.ndarray:
    shape, name, buf = unpackb(data)
    dt = _dtype(name)
    arr = np.frombuffer(buf, dtype=dt).copy()
    if name in ("bfloat16", b"bfloat16"):
        arr = (arr.astype(np.uint32) << 16).view(np.float32)
    return arr.reshape(shape)


def _ext(code: int, data: bytes):
    if code == EXT_NDARRAY:
        return _ndarray(data)
    if code == EXT_COMPLEX:
        real, imag = unpackb(data)
        return complex(real, imag)
    if code == EXT_NPSCALAR:
        return _ndarray(data)[()]
    raise ValueError(f"unknown msgpack ext code {code}")


def _decode(buf: memoryview, pos: int) -> Tuple[Any, int]:
    _need(buf, pos, 1)
    b = buf[pos]
    pos += 1
    if b <= 0x7F:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if 0x80 <= b <= 0x8F:
        return _map(buf, pos, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return _array(buf, pos, b & 0x0F)
    if 0xA0 <= b <= 0xBF:
        n = b & 0x1F
        _need(buf, pos, n)
        return str(buf[pos:pos + n], "utf-8"), pos + n
    if b == 0xC0:
        return None, pos
    if b == 0xC2:
        return False, pos
    if b == 0xC3:
        return True, pos
    if b in _SCALARS:
        fmt, size = _SCALARS[b]
        _need(buf, pos, size)
        return struct.unpack_from(fmt, buf, pos)[0], pos + size
    if b in _FIXEXT:
        n = _FIXEXT[b]
        _need(buf, pos, 1 + n)
        code = struct.unpack_from(">b", buf, pos)[0]
        return _ext(code, bytes(buf[pos + 1:pos + 1 + n])), pos + 1 + n
    if b in _SIZED:
        kind, width = _SIZED[b]
        _need(buf, pos, width)
        n = struct.unpack_from(_LEN_FMT[width], buf, pos)[0]
        pos += width
        if kind == "array":
            return _array(buf, pos, n)
        if kind == "map":
            return _map(buf, pos, n)
        if kind == "ext":
            _need(buf, pos, 1 + n)
            code = struct.unpack_from(">b", buf, pos)[0]
            return _ext(code, bytes(buf[pos + 1:pos + 1 + n])), pos + 1 + n
        _need(buf, pos, n)
        raw = bytes(buf[pos:pos + n])
        return (raw if kind == "bin" else raw.decode("utf-8")), pos + n
    raise ValueError(f"invalid msgpack first byte 0x{b:02x} at {pos - 1}")


def _need(buf: memoryview, pos: int, n: int) -> None:
    if pos + n > len(buf):
        raise ValueError("truncated msgpack data")


def _array(buf: memoryview, pos: int, n: int):
    out = []
    for _ in range(n):
        item, pos = _decode(buf, pos)
        out.append(item)
    return out, pos


def _map(buf: memoryview, pos: int, n: int):
    out = {}
    for _ in range(n):
        key, pos = _decode(buf, pos)
        if not isinstance(key, (str, bytes)):
            raise ValueError(f"msgpack map key of type {type(key).__name__}")
        out[key], pos = _decode(buf, pos)
    return out, pos


def _unchunk(tree):
    """Join Flax's chunked array leaves back into arrays."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def unpackb(data) -> Any:
    """One msgpack object from `data` (bytes), as `msgpack.unpackb(data,
    raw=False)` gives it with Flax's ext hook; trailing bytes raise."""
    buf = memoryview(data).cast("B")
    obj, pos = _decode(buf, 0)
    if pos != len(buf):
        raise ValueError(f"{len(buf) - pos} bytes after the msgpack object")
    return obj


def restore(data) -> Any:
    """`flax.serialization.msgpack_restore`: the nested tree of a Flax
    msgpack file's bytes (bfloat16 leaves widened to float32)."""
    return _unchunk(unpackb(data))


def flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """Nested dicts -> {"a/b/c": leaf}; empty dicts give no leaf."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, path + "/"))
        else:
            out[path] = v
    return out


def read_flat(path) -> Dict[str, Any]:
    """The leaves of the Flax msgpack file at `path`, flat with "/"."""
    tree = restore(Path(path).read_bytes())
    if not isinstance(tree, dict):
        raise ValueError(f"{path}: not a Flax state dict")
    return flatten(tree)
