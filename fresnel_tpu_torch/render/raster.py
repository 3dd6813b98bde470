"""Tile compositing: the hand-written CUDA kernel and its plain version.

Counterpart of fresnel_tpu/render/pallas_raster.py (forward only).  The
kernel source is csrc/raster_fwd.cu; it is compiled with nvcc for sm_90a
at first use into `build/` at the root of the checkout and bound through a
plain C function loaded with ctypes.

`composite_tiles_packed` launches the kernel for CUDA tensors and takes the
plain version only for CPU tensors; there is no fall back from one to the
other.  `launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

import torch

TS = 16
PIX = TS * TS
PACK = 12

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "raster_fwd.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

launches = 0
_lib = None


def _find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the compositing kernel")


def build() -> Tuple[Path, str]:
    """Compile the kernel into BUILD_DIR (once per source content).

    Returns (library path, compiler output: ptxas's registers and shared
    memory, empty when the library was already built).  The library name
    carries a hash of the source and flags, so an edited source is
    rebuilt."""
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"raster_fwd_{digest}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"raster_fwd_{digest}.{os.getpid()}.tmp.so"
    cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)
    return out, res.stdout + res.stderr


def _load():
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        lib.raster_fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        lib.raster_fwd.restype = ctypes.c_int
        _lib = lib
    return _lib


def composite_tiles_plain(pack: torch.Tensor, counts: torch.Tensor,
                          n_tiles_x: int, chunk: int = 32
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, on any device.

    Unpacks the (T, M, 12) pack and runs tile.py's `_composite_tiles`."""
    from fresnel_tpu_torch.render.tile import (
        TileRendererConfig, _composite_tiles, tile_pixel_coords)

    T, M, _ = pack.shape
    n_tiles_y = -(-T // n_tiles_x)
    px, py = tile_pixel_coords(n_tiles_x, n_tiles_y, TS, pack.device)
    valid = (torch.arange(M, device=pack.device)[None, :]
             < counts.to(pack.device)[:, None])
    return _composite_tiles(
        px[:T], py[:T], pack[..., 0:2], pack[..., 2:5], pack[..., 6:9],
        pack[..., 9], pack[..., 10], pack[..., 5], valid,
        TileRendererConfig(chunk=chunk))


def _check_inputs(pack: torch.Tensor, counts: torch.Tensor) -> None:
    if pack.dtype != torch.float32:
        raise TypeError(f"pack must be float32, got {pack.dtype}")
    if pack.dim() != 3 or pack.shape[2] != PACK:
        raise ValueError(f"pack must be (T, M, {PACK}), got {tuple(pack.shape)}")
    if not pack.is_contiguous():
        raise ValueError("pack must be contiguous")
    if counts.dtype != torch.int32 or counts.shape != (pack.shape[0],):
        raise ValueError("counts must be int32 of shape (T,), got "
                         f"{counts.dtype} {tuple(counts.shape)}")
    if not counts.is_contiguous():
        raise ValueError("counts must be contiguous")
    if counts.device != pack.device:
        raise ValueError("pack and counts must be on one device")


def composite_tiles_packed(pack: torch.Tensor, counts: torch.Tensor,
                           n_tiles_x: int, chunk: int = 32
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Composite binned, depth-ordered tiles.

    pack: (T, M, 12) float32 [mean 2, conic 3, radius, rgb 3, opacity,
    depth, pad], dead slots masked (opacity 0, radius -1); counts: (T,)
    int32 occupied slots.  Returns (color (T, 256, 3), depth (T, 256),
    transmittance (T, 256)), the contract of the JAX package's
    composite_tiles_pallas_packed.  `chunk` is the plain version's step
    and does not change the kernel."""
    if pack.device.type == "cpu":
        return composite_tiles_plain(pack, counts, n_tiles_x, chunk)
    if pack.device.type != "cuda":
        raise ValueError(f"unsupported device {pack.device}")
    _check_inputs(pack, counts)
    T, M, _ = pack.shape
    color = torch.empty((T, PIX, 3), dtype=torch.float32, device=pack.device)
    depth = torch.empty((T, PIX), dtype=torch.float32, device=pack.device)
    trans = torch.empty((T, PIX), dtype=torch.float32, device=pack.device)
    if T == 0:
        return color, depth, trans
    lib = _load()
    global launches
    with torch.cuda.device(pack.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.raster_fwd(pack.data_ptr(), counts.data_ptr(),
                             color.data_ptr(), depth.data_ptr(),
                             trans.data_ptr(), T, M, n_tiles_x, stream)
    if err != 0:
        raise RuntimeError(f"raster_fwd launch failed with CUDA error {err}")
    launches += 1
    return color, depth, trans
