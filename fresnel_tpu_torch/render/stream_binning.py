"""Streaming per-tile compaction: the CUDA kernel K4 and its plain version.

Counterpart of fresnel_tpu/render/pallas_stream_binning.py.
`bin_gaussians_stream` has the contract of `tile._bin_gaussians_search`
(identical tables): one pass over the depth-sorted stream gives every tile
the indices of its first M hitting Gaussians, in order, with no rank table
and no search.  For CUDA tensors it launches K4 (csrc/bin_stream.cu, built
by `_build` at first use) or raises; for CPU tensors it runs
`bin_gaussians_stream_plain`.  There is no fall back from one to the
other.  `launches` counts K4 launches.

Both are integer functions: the kernel's tables equal the plain version's
bit for bit, dead slots (index 0) included.
"""

from __future__ import annotations

from typing import Tuple

import torch

from fresnel_tpu_torch import _build
from fresnel_tpu_torch.render.binning import tile_intervals

launches = 0    # K4 launches


def stream_intervals(means2d, radii, visible, n_tiles_x: int, n_tiles_y: int,
                     tile_size) -> torch.Tensor:
    """(N, 4) int32 [xlo, xhi, ylo, yhi] for K4: the shared interval test,
    clamped to the tile grid, with invisible Gaussians folded into an empty
    x interval (xhi = -1)."""
    cxlo, cxhi, cylo, cyhi = tile_intervals(means2d, radii, tile_size)
    cxlo = torch.clamp(cxlo, min=0)
    cxhi = torch.clamp(cxhi, max=n_tiles_x - 1)
    cylo = torch.clamp(cylo, min=0)
    cyhi = torch.clamp(cyhi, max=n_tiles_y - 1)
    cxhi = torch.where(visible, cxhi, -1)
    return torch.stack([cxlo, cxhi, cylo, cyhi], dim=1).contiguous()


def _stream_from_intervals_plain(iv: torch.Tensor, n_tiles_x: int,
                                 n_tiles_y: int, max_per_tile: int
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tables from the (N, 4) intervals: the hit matrix, a running rank,
    the hits of rank <= M scattered to (tile, rank - 1).  One tile row at
    a time, so the int32 rank matrix stays at n_tiles_x * N."""
    dev = iv.device
    T = n_tiles_x * n_tiles_y
    M = max_per_tile
    out = torch.zeros((T, M), dtype=torch.int32, device=dev)
    counts = torch.zeros((T,), dtype=torch.int32, device=dev)
    cxlo, cxhi, cylo, cyhi = iv.unbind(dim=1)
    ax = torch.arange(n_tiles_x, dtype=torch.int32, device=dev)[:, None]
    hx = (ax >= cxlo[None]) & (ax <= cxhi[None])                 # (ntx, N)
    for y in range(n_tiles_y if iv.shape[0] else 0):
        hit = hx & ((cylo <= y) & (cyhi >= y))[None]
        rank = torch.cumsum(hit, dim=1, dtype=torch.int32)
        x_idx, j_idx = torch.nonzero(hit & (rank <= M), as_tuple=True)
        out[y * n_tiles_x + x_idx, (rank[x_idx, j_idx] - 1).long()] = \
            j_idx.to(torch.int32)
        counts[y * n_tiles_x:(y + 1) * n_tiles_x] = torch.clamp(
            rank[:, -1], max=M)
    valid = (torch.arange(M, dtype=torch.int32, device=dev)[None, :]
             < counts[:, None])
    return out, valid


def bin_gaussians_stream_plain(means2d, radii, visible, n_tiles_x: int,
                               n_tiles_y: int, tile_size, max_per_tile: int
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K4 with its interval preparation, on any
    device."""
    iv = stream_intervals(means2d, radii, visible, n_tiles_x, n_tiles_y,
                          tile_size)
    return _stream_from_intervals_plain(iv, n_tiles_x, n_tiles_y,
                                        max_per_tile)


def _launch(iv: torch.Tensor, n_tiles_x: int, n_tiles_y: int,
            max_per_tile: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4 on a CUDA tensor of intervals."""
    global launches
    if iv.dtype != torch.int32 or iv.dim() != 2 or iv.shape[1] != 4:
        raise ValueError("intervals must be (N, 4) int32, got "
                         f"{iv.dtype} {tuple(iv.shape)}")
    if not iv.is_contiguous():
        raise ValueError("intervals must be contiguous")
    if max_per_tile <= 0:
        raise ValueError(f"max_per_tile={max_per_tile} must be positive")
    dev = iv.device
    T = n_tiles_x * n_tiles_y
    out = torch.empty((T, max_per_tile), dtype=torch.int32, device=dev)
    valid = torch.empty((T, max_per_tile), dtype=torch.bool, device=dev)
    counts = torch.empty((T,), dtype=torch.int32, device=dev)
    if T == 0:
        return out, valid
    _build.launch("bin_stream", dev,
                  (iv.data_ptr(), out.data_ptr(), valid.data_ptr(),
                   counts.data_ptr()), (iv.shape[0], T, max_per_tile,
                                        n_tiles_x))
    launches += 1
    return out, valid


def bin_gaussians_stream(means2d: torch.Tensor, radii: torch.Tensor,
                         visible: torch.Tensor, n_tiles_x: int,
                         n_tiles_y: int, tile_size, max_per_tile: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tile compaction of depth-sorted Gaussian indices in one pass.

    means2d (N, 2) float32, radii (N,) float32, visible (N,) bool, all in
    depth order.  Returns (tile_indices (T, M) int32 into the sorted
    arrays, 0 in dead slots; tile_valid (T, M) bool).  Overflow beyond M
    drops the farthest Gaussians.  CUDA tensors launch K4, CPU tensors run
    the plain version."""
    if means2d.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {means2d.device}")
    iv = stream_intervals(means2d, radii, visible, n_tiles_x, n_tiles_y,
                          tile_size)
    if iv.device.type == "cuda":
        return _launch(iv, n_tiles_x, n_tiles_y, max_per_tile)
    return _stream_from_intervals_plain(iv, n_tiles_x, n_tiles_y,
                                        max_per_tile)
