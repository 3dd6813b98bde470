"""Gaussian interchange I/O: 14-float binary and 3DGS PLY.

Counterpart of fresnel_tpu/core/io.py (its numpy writer; the JAX
package's native fast path writes the same bytes):
  * Binary: N x 14 little-endian float32 [pos3, scale3, quat_wxyz4, rgb3, op1].
  * PLY: binary_little_endian, properties x y z scale_0..2 rot_0..3
    f_dc_0..2 opacity; scales are log-space, colour is SH-DC
    f_dc = (c - 0.5) / C0 with C0 = 0.28209479177387814, opacity is a logit.
Host-side numpy; clouds load as CPU tensors.
"""

from __future__ import annotations

from pathlib import Path
from typing import Union

import numpy as np
import torch

from fresnel_tpu_torch.core.gaussians import GaussianCloud

SH_C0 = 0.28209479177387814

_PLY_PROPS = [
    "x", "y", "z",
    "scale_0", "scale_1", "scale_2",
    "rot_0", "rot_1", "rot_2", "rot_3",
    "f_dc_0", "f_dc_1", "f_dc_2",
    "opacity",
]


def _to_numpy_flat(cloud: GaussianCloud) -> np.ndarray:
    flat = cloud.to_flat().detach().cpu().numpy().astype(np.float32)
    if flat.ndim != 2:
        raise ValueError(f"expected unbatched cloud, got flat shape {flat.shape}")
    return flat


def _from_numpy_flat(flat: np.ndarray) -> GaussianCloud:
    return GaussianCloud.from_flat(torch.from_numpy(np.ascontiguousarray(flat)))


def save_binary(path: Union[str, Path], cloud: GaussianCloud) -> None:
    _to_numpy_flat(cloud).astype("<f4").tofile(str(path))


def load_binary(path: Union[str, Path]) -> GaussianCloud:
    data = np.fromfile(str(path), dtype="<f4").astype(np.float32)
    n = len(data) // 14
    return _from_numpy_flat(data[: n * 14].reshape(n, 14))


def save_ply(path: Union[str, Path], cloud: GaussianCloud) -> None:
    flat = _to_numpy_flat(cloud)
    n = flat.shape[0]
    out = flat.copy()
    out[:, 3:6] = np.log(np.maximum(flat[:, 3:6], 1e-7))           # log scales
    out[:, 10:13] = (flat[:, 10:13] - 0.5) / SH_C0                 # SH-DC color
    op = np.clip(flat[:, 13], 1e-7, 1.0 - 1e-7)
    out[:, 13] = np.log(op / (1.0 - op))                           # logit opacity

    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {p}" for p in _PLY_PROPS]
    header += ["end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(out.astype("<f4").tobytes())


def load_ply(path: Union[str, Path]) -> GaussianCloud:
    """Load a 3DGS PLY: this module's 14-property layout, or a standard
    3DGS export with extra float properties, by selecting the named
    fields."""
    with open(path, "rb") as f:
        raw = f.read()

    header_end = raw.find(b"end_header")
    if header_end < 0:
        raise ValueError("not a PLY file (no end_header)")
    header = raw[:header_end].decode("ascii", errors="replace")
    body = raw[header_end + len(b"end_header"):]
    if body[:2] == b"\r\n":
        body = body[2:]
    elif body[:1] in (b"\n", b"\r"):
        body = body[1:]

    n = 0
    props = []
    for line in header.splitlines():
        line = line.strip()
        if line.startswith("element vertex"):
            n = int(line.split()[-1])
        elif line.startswith("property float"):
            props.append(line.split()[-1])
        elif line.startswith("format") and "binary_little_endian" not in line:
            raise ValueError(f"unsupported PLY format: {line}")

    data = np.frombuffer(body, dtype="<f4", count=n * len(props)).reshape(
        n, len(props))
    col = {name: data[:, i] for i, name in enumerate(props)}

    def stack(names):
        return np.stack([col[nm] for nm in names], axis=-1)

    flat = np.concatenate([
        stack(["x", "y", "z"]),
        np.exp(stack(["scale_0", "scale_1", "scale_2"])),
        stack(["rot_0", "rot_1", "rot_2", "rot_3"]),
        np.clip(stack(["f_dc_0", "f_dc_1", "f_dc_2"]) * SH_C0 + 0.5, 0.0, 1.0),
        (1.0 / (1.0 + np.exp(-col["opacity"])))[:, None],
    ], axis=-1).astype(np.float32)
    return _from_numpy_flat(flat)
