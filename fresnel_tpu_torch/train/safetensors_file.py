"""Reader of `.safetensors` files, with torch alone.

The port reads DINOv2 and Depth-Anything weights in this format without
the `safetensors` package, which the card's machine may lack.  A file is
an 8-byte little-endian header length, a JSON header
{name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__":
{...}} of that length, then the tensors' raw little-endian bytes, the
offsets counted from the end of the header.  F32, F16, BF16 and F64 are
read through `torch.frombuffer` (numpy has no bfloat16); any other dtype
raises ValueError naming it.  `write_safetensors` writes the same
format.

    read_safetensors(path) -> {"embeddings.cls_token": tensor, ...}
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, Optional

import torch

DTYPES = {"F32": torch.float32, "F16": torch.float16,
          "BF16": torch.bfloat16, "F64": torch.float64}


def read_safetensors(path) -> Dict[str, torch.Tensor]:
    """Every tensor of the file at `path`, on the CPU, each owning its
    memory.  Raises ValueError for a malformed header, an offset range
    that does not match the shape, or an unsupported dtype."""
    size = os.path.getsize(path)
    buf = bytearray(size)
    with open(path, "rb") as f:
        if f.readinto(buf) != size:
            raise ValueError(f"{path}: short read")
    if size < 8:
        raise ValueError(f"{path}: not a safetensors file ({size} bytes)")
    n = int.from_bytes(buf[:8], "little")
    if 8 + n > size:
        raise ValueError(f"{path}: header of {n} bytes overruns the file")
    try:
        header = json.loads(bytes(buf[8:8 + n]).decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"{path}: unreadable header ({e})") from e
    base = 8 + n
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dt = DTYPES.get(info["dtype"])
        if dt is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype "
                             f"{info['dtype']}, not one of {sorted(DTYPES)}")
        shape = tuple(int(s) for s in info["shape"])
        begin, end = (int(o) for o in info["data_offsets"])
        numel = math.prod(shape)
        if end - begin != numel * dt.itemsize or base + end > size:
            raise ValueError(f"{path}: tensor {name!r} of shape {shape} "
                             f"has offsets {begin}..{end}")
        if numel == 0:
            out[name] = torch.empty(shape, dtype=dt)
            continue
        out[name] = torch.frombuffer(buf, dtype=dt, count=numel,
                                     offset=base + begin).reshape(
                                         shape).clone()
    return out


_NAMES = {v: k for k, v in DTYPES.items()}


def write_safetensors(path, tensors: Dict[str, torch.Tensor],
                      metadata: Optional[Dict[str, str]] = None) -> None:
    """Write {name: tensor} (F32, F16, BF16 or F64, any device) in the
    format above, the header padded with spaces to a multiple of 8
    bytes and the tensors laid out in name order."""
    header, blobs, offset = {}, [], 0
    for name in sorted(tensors):
        t = tensors[name].detach().cpu().contiguous()
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {name!r} has dtype {t.dtype}")
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    if metadata:
        header["__metadata__"] = dict(metadata)
    text = json.dumps(header, separators=(",", ":")).encode("utf-8")
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(len(text).to_bytes(8, "little"))
        f.write(text)
        for raw in blobs:
            f.write(raw)
