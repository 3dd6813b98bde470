"""Rank table of the search binning: the CUDA kernel K3 and its plain version.

Counterpart of fresnel_tpu/render/pallas_binning.py.  `build_rank_table`
gives, for one tile-row group, the (tiles, Gaussians) table of in-chunk
inclusive hit counts and the cumulative chunk totals that
`tile._two_level_search` reads.  For CUDA tensors it launches K3
(csrc/bin_table.cu, built by `_build` at first use) or raises; for CPU
tensors it runs `build_rank_table_plain`.  There is no fall back from one
to the other.  `launches` counts K3 launches.

Both are integer functions: the kernel's outputs equal the plain version's
bit for bit.  The table is (T, n2): the Gaussian axis is not padded past
the chunk multiple n2, as the JAX package pads it for its grid (to a
multiple of 2048, with rank-flat columns that no valid slot can reach).
"""

from __future__ import annotations

from typing import Tuple

import torch

from fresnel_tpu_torch import _build

CHUNK = 256     # Gaussians per chunk: counts <= 256 are exact in bfloat16

launches = 0    # K3 launches


def tile_intervals(means2d: torch.Tensor, radii: torch.Tensor, tile_size):
    """Inclusive tile-index intervals [lo, hi] each Gaussian's box touches,
    four (N,) int32 tensors: the one interval test every binning shares.

    a*ts <= u+r  <=>  a <= floor((u+r)/ts);  u-r < (a+1)*ts  <=>
    a >= floor((u-r)/ts)."""
    ts = float(tile_size)
    u, v, r = means2d[:, 0], means2d[:, 1], radii
    cxlo = torch.floor((u - r) / ts).to(torch.int32)
    cxhi = torch.floor((u + r) / ts).to(torch.int32)
    cylo = torch.floor((v - r) / ts).to(torch.int32)
    cyhi = torch.floor((v + r) / ts).to(torch.int32)
    return cxlo, cxhi, cylo, cyhi


def _check_inputs(cxlo, cxhi, cylo, cyhi, n2: int) -> None:
    if n2 <= 0 or n2 % CHUNK:
        raise ValueError(f"n2={n2} must be a positive multiple of {CHUNK}")
    for name, t in (("cxlo", cxlo), ("cxhi", cxhi), ("cylo", cylo),
                    ("cyhi", cyhi)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if tuple(t.shape) != (n2,):
            raise ValueError(f"{name} must be ({n2},), got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != cxlo.device:
            raise ValueError("the four bounds must be on one device")


def build_rank_table_plain(cxlo, cxhi, cylo, cyhi, n_tiles_x: int,
                           n_tiles_y: int, n2: int, y_offset: int = 0
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K3, on any device: the hit matrix from the
    intervals, `torch.cumsum` within chunks, cast to bfloat16.  One tile
    row at a time, so the int32 intermediate stays at n_tiles_x * n2."""
    _check_inputs(cxlo, cxhi, cylo, cyhi, n2)
    dev = cxlo.device
    T = n_tiles_x * n_tiles_y
    n_chunks = n2 // CHUNK
    table = torch.empty((T, n2), dtype=torch.bfloat16, device=dev)
    totals = torch.empty((T, n_chunks), dtype=torch.int32, device=dev)
    ax = torch.arange(n_tiles_x, dtype=torch.int32, device=dev)[:, None]
    hx = (ax >= cxlo[None]) & (ax <= cxhi[None])                 # (ntx, n2)
    for y in range(n_tiles_y):
        ty = y + y_offset
        hit = hx & ((cylo <= ty) & (cyhi >= ty))[None]
        ranks = torch.cumsum(hit.reshape(n_tiles_x, n_chunks, CHUNK), dim=2,
                             dtype=torch.int32)
        rows = slice(y * n_tiles_x, (y + 1) * n_tiles_x)
        table[rows] = ranks.reshape(n_tiles_x, n2).to(torch.bfloat16)
        totals[rows] = ranks[:, :, -1]
    return table, torch.cumsum(totals, dim=1, dtype=torch.int32)


def _launch(cxlo, cxhi, cylo, cyhi, n_tiles_x: int, n_tiles_y: int, n2: int,
            y_offset: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 on CUDA tensors."""
    global launches
    _check_inputs(cxlo, cxhi, cylo, cyhi, n2)
    dev = cxlo.device
    T = n_tiles_x * n_tiles_y
    table = torch.empty((T, n2), dtype=torch.bfloat16, device=dev)
    cumtot = torch.empty((T, n2 // CHUNK), dtype=torch.int32, device=dev)
    if T == 0:
        return table, cumtot
    _build.launch("bin_table", dev,
                  (cxlo.data_ptr(), cxhi.data_ptr(), cylo.data_ptr(),
                   cyhi.data_ptr(), table.data_ptr(), cumtot.data_ptr()),
                  (n2, n_tiles_x, n_tiles_y, y_offset))
    launches += 1
    return table, cumtot


def build_rank_table(cxlo: torch.Tensor, cxhi: torch.Tensor,
                     cylo: torch.Tensor, cyhi: torch.Tensor, n_tiles_x: int,
                     n_tiles_y: int, n2: int, y_offset: int = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rank table of one tile-row group.

    cxlo, cxhi, cylo, cyhi: (n2,) int32 inclusive tile-index intervals in
    depth order, n2 a multiple of 256, invisible and padding entries as
    empty intervals (hi < lo).  Tile t = y * n_tiles_x + x is tested at
    (x, y + y_offset).  Returns (table (T, n2) bfloat16 of in-chunk
    inclusive hit counts, cumtot (T, n2 / 256) int32 of cumulative chunk
    totals).  CUDA tensors launch K3, CPU tensors run the plain version."""
    if cxlo.device.type == "cuda":
        return _launch(cxlo, cxhi, cylo, cyhi, n_tiles_x, n_tiles_y, n2,
                       int(y_offset))
    if cxlo.device.type != "cpu":
        raise ValueError(f"unsupported device {cxlo.device}")
    return build_rank_table_plain(cxlo, cxhi, cylo, cyhi, n_tiles_x,
                                  n_tiles_y, n2, int(y_offset))
