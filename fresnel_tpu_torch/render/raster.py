"""Tile compositing: the hand-written CUDA kernels and their plain versions.

Counterpart of fresnel_tpu/render/pallas_raster.py.  The forward kernel
(K1) is csrc/raster_fwd.cu, the backward kernel (K2, the analytic VJP) is
csrc/raster_bwd.cu; both include csrc/raster_common.cuh.  Each is compiled
with nvcc for sm_90a at first use into `build/` at the root of the
checkout and bound through a plain C function loaded with ctypes.

`composite_tiles_packed` goes through the autograd Function `_Composite`
on both devices: for CUDA tensors its forward launches K1 and its backward
K2; for CPU tensors they run the plain versions `composite_tiles_plain` and
`composite_tiles_bwd_plain`.  There is no fall back from one to the other.
`launches` and `launches_bwd` count kernel launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

TS = 16
PIX = TS * TS
PACK = 12
ALPHA_MAX = 0.99

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
KERNELS = ("raster_fwd", "raster_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

launches = 0        # K1 launches
launches_bwd = 0    # K2 launches
_libs: Dict[str, ctypes.CDLL] = {}


def _find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the compositing kernels")


def _library(name: str) -> Path:
    """Library path for kernel `name`; its name hashes every source under
    csrc/ and the flags, so any edit is rebuilt."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode() + src.read_bytes())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"


def build(names: Sequence[str] = KERNELS) -> Dict[str, Tuple[Path, str]]:
    """Compile the kernels `names` into BUILD_DIR, one nvcc process each,
    all started together; a library already built is reused.

    Returns {name: (library path, compiler output: ptxas's registers,
    shared memory and spills, empty when the library was already built)}."""
    out: Dict[str, Tuple[Path, str]] = {}
    procs = {}
    for name in names:
        lib = _library(name)
        if lib.exists():
            out[name] = (lib, "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (lib, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu "
                               f"({proc.returncode}):\n{log}")
        os.replace(tmp, lib)
        out[name] = (lib, log)
    return out


def _load(name: str) -> ctypes.CDLL:
    if name not in _libs:
        path, _ = build([name])[name]
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, name)
        n_ptr = 5 if name == "raster_fwd" else 9
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _libs[name] = lib
    return _libs[name]


def _tile_grid(T: int, M: int, counts: torch.Tensor, n_tiles_x: int,
               device, dtype):
    """Pixel coordinates (T, P) and slot validity (T, M) of a pack."""
    from fresnel_tpu_torch.render.tile import tile_pixel_coords

    n_tiles_y = -(-T // n_tiles_x)
    px, py = tile_pixel_coords(n_tiles_x, n_tiles_y, TS, device)
    valid = (torch.arange(M, device=device)[None, :]
             < counts.to(device)[:, None])
    return px[:T].to(dtype), py[:T].to(dtype), valid


def composite_tiles_plain(pack: torch.Tensor, counts: torch.Tensor,
                          n_tiles_x: int, chunk: int = 32
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1, on any device and float dtype.

    Unpacks the (T, M, 12) pack and runs tile.py's `_composite_tiles`,
    which autograd can differentiate."""
    from fresnel_tpu_torch.render.tile import (
        TileRendererConfig, _composite_tiles)

    T, M, _ = pack.shape
    px, py, valid = _tile_grid(T, M, counts, n_tiles_x, pack.device,
                               pack.dtype)
    return _composite_tiles(
        px, py, pack[..., 0:2], pack[..., 2:5], pack[..., 6:9],
        pack[..., 9], pack[..., 10], pack[..., 5], valid,
        TileRendererConfig(chunk=chunk))


def composite_tiles_bwd_plain(pack, counts, n_tiles_x: int, color, depth,
                              trans, g_color, g_depth, g_trans,
                              chunk: int = 32) -> torch.Tensor:
    """Plain PyTorch version of K2, on any device and float dtype.

    The formulas of pallas_raster.py's _bwd_chunk_body over (T, C, P)
    chunks: the exclusive cumprod gives T_before, and the suffix sums after
    each slot are the running totals (starting at the forward's outputs,
    before any background) minus an inclusive cumsum of the contributions.
    Returns the gradient of the pack (T, M, 12), zero in the radius and
    pad columns and in slots >= count."""
    T, M, _ = pack.shape
    if M % chunk:
        raise ValueError(f"M={M} is not a multiple of chunk={chunk}")
    px, py, valid = _tile_grid(T, M, counts, n_tiles_x, pack.device,
                               pack.dtype)
    g4 = torch.cat([g_color, g_depth[..., None]], -1)           # (T, P, 4)
    S = torch.cat([color, depth[..., None]], -1)                # (T, P, 4)
    gT_fin = (g_trans * trans)[:, None, :]                      # (T, 1, P)
    Tr = torch.ones_like(trans)
    zero = torch.zeros_like(pack[:, :chunk, 0])
    grads = []
    for i in range(M // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        g = pack[:, sl]                                         # (T, C, 12)
        ca, cb, cc = (g[..., k, None] for k in (2, 3, 4))
        dx = px[:, None, :] - g[..., 0, None]                   # (T, C, P)
        dy = py[:, None, :] - g[..., 1, None]
        rr = g[..., 5, None]
        inside = ((torch.abs(dx) <= rr) & (torch.abs(dy) <= rr)
                  & valid[:, sl, None])
        m = ca * dx * dx + 2.0 * cb * dx * dy + cc * dy * dy
        e = torch.where(inside, torch.exp(-0.5 * m), 0.0)
        alpha_raw = e * g[..., 9, None]
        alpha = torch.clamp(alpha_raw, max=ALPHA_MAX)
        T_inc = torch.cumprod(1.0 - alpha, dim=1)
        T_excl = torch.cat([torch.ones_like(T_inc[:, :1]), T_inc[:, :-1]], 1)
        T_before = T_excl * Tr[:, None, :]
        w = alpha * T_before
        col4 = g[..., [6, 7, 8, 10]]                            # (T, C, 4)
        contrib = w[..., None] * col4[:, :, None, :]            # (T, C, P, 4)
        S_after = S[:, None] - torch.cumsum(contrib, dim=1)
        one_m = torch.clamp(1.0 - alpha, min=1e-6)
        dalpha = (g4[:, None] * (T_before[..., None] * col4[:, :, None, :]
                                 - S_after / one_m[..., None])).sum(-1)
        dalpha = dalpha - gT_fin / one_m
        dalpha = torch.where(alpha_raw < ALPHA_MAX, dalpha, 0.0)
        dm = dalpha * alpha_raw * (-0.5)
        wg = (w[..., None] * g4[:, None]).sum(2)                # (T, C, 4)
        grads.append(torch.stack([
            (dm * -(2.0 * ca * dx + 2.0 * cb * dy)).sum(-1),
            (dm * -(2.0 * cb * dx + 2.0 * cc * dy)).sum(-1),
            (dm * dx * dx).sum(-1),
            (dm * 2.0 * dx * dy).sum(-1),
            (dm * dy * dy).sum(-1),
            zero,
            wg[..., 0], wg[..., 1], wg[..., 2],
            (dalpha * e).sum(-1),
            wg[..., 3],
            zero], dim=-1))
        Tr = Tr * T_inc[:, -1]
        S = S_after[:, -1]
    grad = torch.cat(grads, dim=1)
    return torch.where(valid[..., None], grad, 0.0)


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


def _check_pixels(pack: torch.Tensor, **tensors: torch.Tensor) -> None:
    """Per-pixel tensors of K2: float32, contiguous, on the pack's device,
    (T, 256, 3) for colours and (T, 256) otherwise."""
    T = pack.shape[0]
    for name, t in tensors.items():
        shape = (T, PIX, 3) if name in ("color", "g_color") else (T, PIX)
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != pack.device:
            raise ValueError(f"{name} must be on {pack.device}")


def _stream(device) -> int:
    with torch.cuda.device(device):
        return torch.cuda.current_stream().cuda_stream


def _launch_fwd(pack: torch.Tensor, counts: torch.Tensor, n_tiles_x: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1 on CUDA tensors."""
    global launches
    _check_inputs(pack, counts)
    T, M, _ = pack.shape
    color = torch.empty((T, PIX, 3), dtype=torch.float32, device=pack.device)
    depth = torch.empty((T, PIX), dtype=torch.float32, device=pack.device)
    trans = torch.empty((T, PIX), dtype=torch.float32, device=pack.device)
    if T == 0:
        return color, depth, trans
    err = _load("raster_fwd").raster_fwd(
        pack.data_ptr(), counts.data_ptr(), color.data_ptr(),
        depth.data_ptr(), trans.data_ptr(), T, M, n_tiles_x,
        _stream(pack.device))
    if err != 0:
        raise RuntimeError(f"raster_fwd launch failed with CUDA error {err}")
    launches += 1
    return color, depth, trans


def _launch_bwd(pack, counts, n_tiles_x: int, color, depth, trans, g_color,
                g_depth, g_trans) -> torch.Tensor:
    """K2 on CUDA tensors."""
    global launches_bwd
    _check_inputs(pack, counts)
    _check_pixels(pack, color=color, depth=depth, trans=trans,
                  g_color=g_color, g_depth=g_depth, g_trans=g_trans)
    T, M, _ = pack.shape
    grad = torch.empty_like(pack)
    if T == 0:
        return grad
    err = _load("raster_bwd").raster_bwd(
        pack.data_ptr(), counts.data_ptr(), color.data_ptr(),
        depth.data_ptr(), trans.data_ptr(), g_color.data_ptr(),
        g_depth.data_ptr(), g_trans.data_ptr(), grad.data_ptr(), T, M,
        n_tiles_x, _stream(pack.device))
    if err != 0:
        raise RuntimeError(f"raster_bwd launch failed with CUDA error {err}")
    launches_bwd += 1
    return grad


def _device_of(pack: torch.Tensor) -> str:
    if pack.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {pack.device}")
    return pack.device.type


def composite_tiles_bwd(pack, counts, n_tiles_x: int, color, depth, trans,
                        g_color, g_depth, g_trans, chunk: int = 32
                        ) -> torch.Tensor:
    """Gradient of the pack (T, M, 12) from the forward's outputs (color,
    depth before the background, final transmittance) and their
    cotangents: K2 for CUDA tensors, the plain version for CPU tensors.
    `chunk` is the plain version's step and does not change the kernel."""
    if _device_of(pack) == "cuda":
        return _launch_bwd(pack, counts, n_tiles_x, color, depth, trans,
                           g_color, g_depth, g_trans)
    return composite_tiles_bwd_plain(pack, counts, n_tiles_x, color, depth,
                                     trans, g_color, g_depth, g_trans, chunk)


class _Composite(torch.autograd.Function):
    """K1 forward and K2 backward on CUDA tensors; the plain versions of
    both on CPU tensors.  Only the pack gets a gradient, and only once: K2
    has no derivative, so a second derivative raises on both devices."""

    @staticmethod
    def forward(ctx, pack, counts, n_tiles_x: int, chunk: int):
        if _device_of(pack) == "cuda":
            out = _launch_fwd(pack, counts, n_tiles_x)
        else:
            out = composite_tiles_plain(pack, counts, n_tiles_x, chunk)
        ctx.save_for_backward(pack, counts, *out)
        ctx.n_tiles_x, ctx.chunk = n_tiles_x, chunk
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g_color, g_depth, g_trans):
        # Autograd hands unused outputs' cotangents over as zeros (the
        # Function's default), so all three are tensors here.
        pack, counts, color, depth, trans = ctx.saved_tensors
        grad = composite_tiles_bwd(
            pack, counts, ctx.n_tiles_x, color, depth, trans,
            g_color.contiguous(), g_depth.contiguous(), g_trans.contiguous(),
            chunk=ctx.chunk)
        return grad, None, None, None


def composite_tiles_packed(pack: torch.Tensor, counts: torch.Tensor,
                           n_tiles_x: int, chunk: int = 32
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Composite binned, depth-ordered tiles, differentiably in the pack.

    pack: (T, M, 12) float32 [mean 2, conic 3, radius, rgb 3, opacity,
    depth, pad], dead slots masked (opacity 0, radius -1); counts: (T,)
    int32 occupied slots.  Returns (color (T, 256, 3), depth (T, 256),
    transmittance (T, 256)), the contract of the JAX package's
    composite_tiles_pallas_packed.  CUDA tensors launch K1 (and K2 on
    backward), CPU tensors run the plain versions.  `chunk` is the plain
    versions' step and does not change the kernels."""
    return _Composite.apply(pack, counts, n_tiles_x, chunk)
