"""Build and load the hand-written CUDA kernels under csrc/.

Every kernel is one `csrc/<name>.cu` with a plain C entry point `<name>`.
It is compiled with nvcc for sm_90a at first use into `build/` at the root
of the checkout and loaded with ctypes.  The library's name hashes every
source under csrc/ and the flags, so an edit is always rebuilt and a stale
library is never reused.  A failed build raises; nothing falls back.
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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
# K1, K2 (render/raster.py), K3 (render/binning.py), K4
# (render/stream_binning.py); K1-phi, K2-phi (render/raster.py, phase
# blending), K5, K6 (render/splat.py, the dense splat of the wave-field
# and Fourier renderers).
KERNELS = ("raster_fwd", "raster_bwd", "bin_table", "bin_stream",
           "raster_phase_fwd", "raster_phase_bwd", "dense_fwd", "dense_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}


def _find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the kernels")


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


def _library_of(name: str) -> ctypes.CDLL:
    """Kernel `name`'s library, built and loaded if need be."""
    if name not in _libs:
        path, _ = build([name])[name]
        _libs[name] = ctypes.CDLL(str(path))
    return _libs[name]


def load(name: str, n_pointers: int, n_ints: int, n_floats: int = 0):
    """The C entry point of kernel `name`, built if need be.  Its arguments
    are `n_pointers` device pointers, `n_ints` ints, `n_floats` floats and
    the stream; it returns cudaGetLastError() of its launches (0 on
    success)."""
    fn = getattr(_library_of(name), name)
    fn.argtypes = ([ctypes.c_void_p] * n_pointers
                   + [ctypes.c_int] * n_ints
                   + [ctypes.c_float] * n_floats + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


RESIDENCY_KEYS = ("registers", "shared_bytes", "local_bytes", "threads",
                  "blocks_per_sm")


def residency(name: str, device) -> Dict[str, int]:
    """Registers per thread, static shared and local (spill) bytes,
    threads per block and blocks per SM of kernel `name` on `device`, as
    the CUDA runtime reports them, for a kernel whose source exports
    `<name>_residency`.  Raises on a CUDA error."""
    fn = getattr(_library_of(name), f"{name}_residency")
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * len(RESIDENCY_KEYS))()
    with torch.cuda.device(device):
        err = fn(out)
    if err != 0:
        raise RuntimeError(f"{name}_residency failed with CUDA error {err}")
    return dict(zip(RESIDENCY_KEYS, out))


def launch(name: str, device, pointers: Sequence[int],
           ints: Sequence[int], floats: Sequence[float] = ()) -> None:
    """Launch kernel `name` on `device`, on that device's current stream,
    whichever device the process has current.  Raises if the build or the
    launch fails."""
    with torch.cuda.device(device):
        err = load(name, len(pointers), len(ints), len(floats))(
            *pointers, *ints, *floats,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
