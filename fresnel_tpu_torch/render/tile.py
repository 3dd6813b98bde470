"""Tile-binned rasterizer: projection, depth sort, binning, compositing.

Counterpart of fresnel_tpu/render/tile.py:
  1. project every Gaussian and take its 3-sigma radius;
  2. stable front-to-back depth sort;
  3. binning: each 16x16 tile keeps up to M nearest intersecting Gaussians
     in depth order.  Five binnings build the same tables, bit for bit
     (and bit-identical to the JAX package's):
       "pairs"    `_bin_gaussians`: dense rank cumsum + one scatter of the
                  (Gaussian, tile-window) pairs; "auto" below 98 304
                  Gaussians;
       "search"   `_bin_gaussians_search`: rank table + two-level binary
                  search, no scatter; "auto" from 98 304 Gaussians.  The
                  table comes from `render.binning.build_rank_table` (the
                  CUDA kernel K3 for CUDA tensors) or, with
                  table_build="xla", from masks and a triangular matmul;
       "stream"   `render.stream_binning.bin_gaussians_stream`: one pass
                  over the sorted stream (the CUDA kernel K4 for CUDA
                  tensors); opt-in;
       "rows"     `_bin_gaussians_rows`: per tile row first, then per tile;
                  opt-in;
       "chunked"  `_bin_gaussians_chunked`: chunk totals + in-chunk ranks
                  on demand, no table; opt-in;
  4. one packed gather of a per-Gaussian (N + 1, 12) table through a
     sentinel row (opacity 0, radius -1) into (T, M, 12);
  5. front-to-back compositing of each tile, through
     `render.raster.composite_tiles_packed`: the hand-written CUDA kernels
     for CUDA tensors (K1 forward, K2 backward), their plain versions for
     CPU tensors.  The gradient of the pack flows back through the packed
     gather to projection; the radius and the binning carry none.

Options of the JAX renderer that are not ported raise NotImplementedError:
phase blending, depth sorts other than "exact", tile sizes other than 16
and hard_cutoff=False.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from fresnel_tpu_torch.core.camera import Camera
from fresnel_tpu_torch.render import raster
from fresnel_tpu_torch.render.binning import (
    CHUNK as RANK_CHUNK, build_rank_table, tile_intervals)
from fresnel_tpu_torch.render.projection import (
    depth_sort_indices,
    project_gaussians,
)
from fresnel_tpu_torch.render.stream_binning import bin_gaussians_stream

ALPHA_MAX = raster.ALPHA_MAX
# Sentinel-row radius: the inside-box test |d| <= -1 is false everywhere.
SENTINEL_RADIUS = -1.0
PACK = 12       # [mean 2, conic 3, radius, rgb 3, opacity, depth, pad]
_SEARCH_MIN_N = 98304   # binning="auto" switches to "search" from here
_MAX_SLAB = 1 << 30     # rank-table elements per tile-row group of "search"
BINNINGS = ("auto", "pairs", "search", "stream", "rows", "chunked")
TABLE_BUILDS = ("auto", "pallas", "xla")


@dataclasses.dataclass(frozen=True)
class TileRendererConfig:
    """Same fields, values and defaults as the JAX package's config.

    `backend` and `pallas_interpret` choose between the JAX package's
    compositors; here the tensor's device decides (the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors), so they are accepted
    and have no effect.

    `binning`: "auto" (pairs below 98 304 Gaussians, search from there),
    "pairs", "search", "stream", "rows", "chunked"; "auto" never picks
    the last three.  `row_capacity` is the per-row list size of "rows"
    (0 = auto).

    `table_build` chooses the rank table of "search".  "pallas" is
    `render.binning.build_rank_table`: the CUDA kernel K3 for CUDA tensors
    (or it raises), its plain version for CPU tensors.  "xla" is the mask
    and triangular-matmul build as torch ops on either device.  "auto"
    takes the "pallas" route here.  The JAX package resolves "auto" to
    "xla" on a measurement of its own hardware, which says nothing about
    this one; the two builds give bit-identical tables, so no output
    depends on the choice."""

    tile_size: int = 16
    max_per_tile: int = 256
    max_radius: float = 64.0
    chunk: int = 32              # Gaussians per step of the plain compositor
    use_phase_blending: bool = False
    phase_amplitude: float = 0.25
    hard_cutoff: bool = True
    backend: str = "auto"
    pallas_interpret: bool = False
    tile_window: int = 5
    binning: str = "auto"
    row_capacity: int = 0
    table_build: str = "auto"
    depth_sort: str = "auto"


@dataclasses.dataclass(frozen=True)
class TilePack:
    """Binned, depth-ordered per-tile Gaussians ready for compositing."""

    pack: torch.Tensor       # (T, M, 12) float32
    counts: torch.Tensor     # (T,) int32 occupied slots per tile
    means2d: torch.Tensor    # (N, 2) depth-sorted
    radii: torch.Tensor      # (N,) depth-sorted
    visible: torch.Tensor    # (N,) depth-sorted
    m_cap: int
    n_tiles_x: int
    n_tiles_y: int


def _bin_gaussians(means2d, radii, visible, n_tiles_x, n_tiles_y, tile_size,
                   max_per_tile, tile_window: int = 5):
    """Per-tile compaction of depth-sorted Gaussian indices (pair binning).

    Returns (tile_indices (T, M) int32, tile_valid (T, M) bool); entries
    index the depth-sorted arrays, in depth order.  Overflow beyond M drops
    the farthest Gaussians.  A dense (T, N) hit-mask cumsum gives every
    (Gaussian, tile-window) pair its slot; one scatter of the N * window^2
    pairs builds the table, with dead and overflowing pairs sent to a
    trash column M that is cut off.  Callers clamp radii to
    (tile_window // 2) * tile_size so the window covers every hit.
    """
    ts = float(tile_size)
    T = n_tiles_x * n_tiles_y
    n = means2d.shape[0]
    M = max_per_tile
    half = tile_window // 2
    dev = means2d.device
    i32 = torch.int32

    u = means2d[:, 0]
    v = means2d[:, 1]
    cxlo, cxhi, cylo, cyhi = tile_intervals(means2d, radii, tile_size)
    ax = torch.arange(n_tiles_x, dtype=i32, device=dev)
    ay = torch.arange(n_tiles_y, dtype=i32, device=dev)
    hx = (ax[:, None] >= cxlo[None]) & (ax[:, None] <= cxhi[None])  # (ntx, N)
    hy = ((ay[:, None] >= cylo[None]) & (ay[:, None] <= cyhi[None])
          & visible[None, :])                                        # (nty, N)
    hit = (hy[:, None, :] & hx[None, :, :]).reshape(T, n)            # (T, N)
    C = torch.cumsum(hit, dim=1, dtype=i32)

    offs = torch.arange(tile_window, dtype=i32, device=dev) - half
    offs_y, offs_x = torch.meshgrid(offs, offs, indexing="ij")
    offs_x = offs_x.reshape(-1)                                      # (K,)
    offs_y = offs_y.reshape(-1)
    cx = torch.clamp(torch.div(u, ts, rounding_mode="floor").to(i32),
                     0, n_tiles_x - 1)
    cy = torch.clamp(torch.div(v, ts, rounding_mode="floor").to(i32),
                     0, n_tiles_y - 1)
    txp = cx[:, None] + offs_x[None, :]                              # (N, K)
    typ = cy[:, None] + offs_y[None, :]
    inb = (txp >= 0) & (txp < n_tiles_x) & (typ >= 0) & (typ < n_tiles_y)
    t_lin = torch.where(inb, typ * n_tiles_x + txp, 0).long()

    # Same integer-interval test as hx/hy, so consistent with `hit`.
    ov = ((txp >= cxlo[:, None]) & (txp <= cxhi[:, None])
          & (typ >= cylo[:, None]) & (typ <= cyhi[:, None])
          & inb & visible[:, None])

    j_idx = torch.arange(n, dtype=i32, device=dev)[:, None].expand(
        n, offs_x.shape[0])
    slot = torch.where(ov, C[t_lin, j_idx.long()] - 1, M)
    slot = torch.clamp(slot, max=M).long()                           # trash
    tile_indices = torch.zeros((T, M + 1), dtype=i32, device=dev)
    # Every (tile, slot < M) target has one writer; only the trash column
    # sees duplicates, and it is cut off.
    tile_indices[t_lin.reshape(-1), slot.reshape(-1)] = j_idx.reshape(-1)
    tile_indices = tile_indices[:, :M]
    count = torch.clamp(C[:, -1], max=M)
    tile_valid = torch.arange(M, dtype=i32, device=dev)[None, :] < count[:, None]
    return tile_indices, tile_valid


def _pad1(t: torch.Tensor, pad: int, value) -> torch.Tensor:
    return torch.cat([t, t.new_full((pad,), value)]) if pad else t


def _padded_intervals(means2d, radii, visible, tile_size):
    """The interval vectors and `visible`, padded to a multiple of 256;
    padding entries are invisible empty intervals (hi = -1).  Returns
    (cxlo, cxhi, cylo, cyhi, visible, n2)."""
    cxlo, cxhi, cylo, cyhi = tile_intervals(means2d, radii, tile_size)
    n = means2d.shape[0]
    n2 = -(-n // RANK_CHUNK) * RANK_CHUNK
    pad = n2 - n
    return (_pad1(cxlo, pad, 0), _pad1(cxhi, pad, -1), _pad1(cylo, pad, 0),
            _pad1(cyhi, pad, -1), _pad1(visible, pad, False), n2)


def _inclusive_ranks(hit: torch.Tensor) -> torch.Tensor:
    """(..., c) bool -> (..., c) inclusive running count of hits, as one
    product with an upper-triangular ones matrix: ranks[..., k] =
    sum_{j <= k} hit[..., j].  Counts are at most c = 256 and every
    partial sum is such an integer, so the product is exact in bfloat16
    (on the card) and in float32 (on the CPU, where bfloat16 products are
    slow); the values are the same."""
    c = hit.shape[-1]
    dtype = torch.bfloat16 if hit.is_cuda else torch.float32
    U = torch.triu(torch.ones((c, c), dtype=dtype, device=hit.device))
    return torch.matmul(hit.to(dtype), U)


def _rank_table_from_hits(hit_t: torch.Tensor):
    """(..., n2) bool hits in (tiles, Gaussians) layout -> (table (..., n2)
    bfloat16 of in-chunk inclusive ranks, cumtot (..., n2 / 256) int32 of
    cumulative chunk totals): the contract of `build_rank_table`."""
    lead, n2 = hit_t.shape[:-1], hit_t.shape[-1]
    ranks = _inclusive_ranks(hit_t.reshape(*lead, n2 // RANK_CHUNK,
                                           RANK_CHUNK))
    cumtot = torch.cumsum(ranks[..., -1].to(torch.int32), dim=-1,
                          dtype=torch.int32)
    return ranks.to(torch.bfloat16).reshape(*lead, n2), cumtot


def _search_chunks(cumtot_t: torch.Tensor, M: int):
    """Level 1 of the search: for every slot m of every tile, the first
    chunk k whose cumulative total reaches m + 1, and the residual target
    within that chunk.  cumtot_t: (..., n_chunks) int32.  Returns
    (k (..., M) int64, target2 (..., M) int64)."""
    n_chunks = cumtot_t.shape[-1]
    shape = (*cumtot_t.shape[:-1], M)
    dev = cumtot_t.device
    target = torch.arange(M, dtype=torch.int64, device=dev) + 1
    # The search space is [0, n_chunks]: n_chunks + 1 candidates.
    lo = torch.zeros(shape, dtype=torch.int64, device=dev)
    hi = torch.full(shape, n_chunks, dtype=torch.int64, device=dev)
    for _ in range(max(1, n_chunks.bit_length())):
        mid = (lo + hi) >> 1
        val = torch.gather(cumtot_t, -1, torch.clamp(mid, max=n_chunks - 1))
        ge = val >= target
        hi = torch.where(ge, mid, hi)
        lo = torch.where(ge, lo, mid + 1)
    k = torch.clamp(hi, max=n_chunks - 1)
    base_k = torch.where(
        k > 0, torch.gather(cumtot_t, -1, torch.clamp(k - 1, min=0)), 0)
    return k, target - base_k


def _two_level_search(Cin_t: torch.Tensor, cumtot_t: torch.Tensor, M: int):
    """Find each (tile, slot)'s Gaussian in the rank table.

    Cin_t: (..., n2) bfloat16 in-chunk inclusive ranks; cumtot_t:
    (..., n_chunks) int32 cumulative chunk totals; leading dimensions are
    batched.  Returns (tile_indices (..., M) int32, tile_valid (..., M)
    bool)."""
    n2 = Cin_t.shape[-1]
    n_chunks = cumtot_t.shape[-1]
    c = n2 // n_chunks
    dev = Cin_t.device
    count = torch.clamp(cumtot_t[..., -1], max=M)
    k, target2 = _search_chunks(cumtot_t, M)

    # Level 2: within chunk k, the first j whose in-chunk rank reaches the
    # residual target.  For a chunk found right the last rank meets it, so
    # the answer lies in [0, c - 1].  The ranks are read as bfloat16 and
    # compared as integers.
    lo = torch.zeros_like(k)
    hi = torch.full_like(k, c - 1)
    kc = k * c
    for _ in range(max(1, (c - 1).bit_length())):
        mid = (lo + hi) >> 1
        val = torch.gather(Cin_t, -1, kc + mid).to(torch.int32)
        ge = val >= target2
        hi = torch.where(ge, mid, hi)
        lo = torch.where(ge, lo, mid + 1)

    tile_valid = (torch.arange(M, dtype=torch.int32, device=dev)
                  < count[..., None])
    tile_indices = torch.where(tile_valid, torch.clamp(kc + hi, max=n2 - 1), 0)
    return tile_indices.to(torch.int32), tile_valid


def _search_from_masks(hx, hy, n2: int, n_tiles_x: int, n_tiles_y: int,
                       M: int):
    """Rank table from the axis masks as torch ops (table_build="xla"),
    then the two-level search, for one tile-row group.  hx: (n2, ntx),
    hy: (n2, nty) bool.  The hits are formed in the (tiles, Gaussians)
    layout straight away, so the table needs no transpose."""
    T = n_tiles_x * n_tiles_y
    hit_t = (hy.T[:, None, :] & hx.T[None, :, :]).reshape(T, n2)
    return _two_level_search(*_rank_table_from_hits(hit_t), M)


def search_groups(n: int, n_tiles_x: int, n_tiles_y: int) -> int:
    """Tile-row groups of the search binning: the fewest (a power of two,
    at most n_tiles_y) that keep a group's rank table at 2^30 elements."""
    n2 = -(-n // RANK_CHUNK) * RANK_CHUNK
    groups = 1
    while (n2 * n_tiles_x * n_tiles_y) // groups > _MAX_SLAB \
            and groups < n_tiles_y:
        groups *= 2
    return groups


def _bin_gaussians_search(means2d, radii, visible, n_tiles_x, n_tiles_y,
                          tile_size, max_per_tile, tile_window: int = 5,
                          groups: int = 1, table: str = "auto"):
    """Scatter-free per-tile compaction: rank table + binary search.

    Same contract and tables as `_bin_gaussians`, built the other way
    around: each output slot (t, m) finds its Gaussian by searching the
    tile's hit counts for the (m + 1)-th hit, first among the cumulative
    totals of 256-Gaussian chunks, then within the chunk's inclusive
    ranks.  `table` chooses who builds those: "pallas" (and "auto") is
    `build_rank_table`, "xla" is `_search_from_masks`.  `groups` > 1
    handles the tile rows in that many passes, each with a rank table of
    1 / groups the size; the tables are the same.  `tile_window` is
    honoured by the caller's radius clamp."""
    M = max_per_tile
    T = n_tiles_x * n_tiles_y
    dev = means2d.device
    cxlo, cxhi, cylo, cyhi, visible, n2 = _padded_intervals(
        means2d, radii, visible, tile_size)
    if table not in TABLE_BUILDS:
        raise ValueError(f"unknown table_build {table!r}")
    groups = max(1, groups)
    # Tile rows are padded to a multiple of `groups`; the padding rows'
    # output rows are cut off below.
    nty_g = -(-n_tiles_y // groups)

    parts = []
    if table == "xla":
        ax = torch.arange(n_tiles_x, dtype=torch.int32, device=dev)
        ay = torch.arange(n_tiles_y, dtype=torch.int32, device=dev)
        hx = (ax[None, :] >= cxlo[:, None]) & (ax[None, :] <= cxhi[:, None])
        hy = ((ay[None, :] >= cylo[:, None]) & (ay[None, :] <= cyhi[:, None])
              & visible[:, None])                                # (n2, nty)
        pad_rows = groups * nty_g - n_tiles_y
        if pad_rows:
            hy = torch.cat([hy, hy.new_zeros((n2, pad_rows))], dim=1)
        for g in range(groups):
            parts.append(_search_from_masks(
                hx, hy[:, g * nty_g:(g + 1) * nty_g], n2, n_tiles_x, nty_g,
                M))
    else:
        # Visibility goes into the intervals (an empty interval hits
        # nothing); the mask build folds it into hy instead.
        xhi = torch.where(visible, cxhi, -1)
        yhi = torch.where(visible, cyhi, -1)
        for g in range(groups):
            tab, cumtot = build_rank_table(cxlo, xhi, cylo, yhi, n_tiles_x,
                                           nty_g, n2, y_offset=g * nty_g)
            parts.append(_two_level_search(tab, cumtot, M))
            del tab, cumtot
    if groups == 1:
        return parts[0]
    # Row-major tile order: stacking groups along y gives t = y * ntx + x.
    return (torch.cat([p[0] for p in parts])[:T],
            torch.cat([p[1] for p in parts])[:T])


def _bin_gaussians_rows(means2d, radii, visible, n_tiles_x, n_tiles_y,
                        tile_size, max_per_tile, row_capacity: int = 0):
    """Two-stage compaction: per tile row first, then per tile.

    Stage 1 compacts the Gaussians of each tile row (a rank table with one
    x-"tile", n_tiles_y rows) into a list of `row_capacity`; stage 2 bins
    each row's list over its n_tiles_x tiles.  Both searches keep index
    order, so the tables equal `_bin_gaussians_search`'s whenever no row
    overflows `row_capacity`; a row that does drops its deepest entries.
    row_capacity=0 takes max(2 * ntx * M, 4 * n2 / nty), rounded up to 256."""
    M = max_per_tile
    T = n_tiles_x * n_tiles_y
    dev = means2d.device
    c = RANK_CHUNK
    cxlo, cxhi, cylo, cyhi, visible, n2 = _padded_intervals(
        means2d, radii, visible, tile_size)

    Mr = (row_capacity if row_capacity > 0
          else max(2 * n_tiles_x * M, (4 * n2) // max(1, n_tiles_y)))
    Mr = min(Mr, n2)
    Mr = -(-Mr // c) * c

    # Stage 1: one x-"tile" spanning everything.
    ay = torch.arange(n_tiles_y, dtype=torch.int32, device=dev)
    hy_t = ((ay[:, None] >= cylo[None]) & (ay[:, None] <= cyhi[None])
            & visible[None])                                     # (nty, n2)
    row_idx, row_valid = _two_level_search(*_rank_table_from_hits(hy_t), Mr)

    # Stage 2: invalid slots get an empty interval and are never hit.
    ri = row_idx.long()
    xlo_r = torch.where(row_valid, cxlo[ri], 0)                  # (nty, Mr)
    xhi_r = torch.where(row_valid, cxhi[ri], -1)
    ax = torch.arange(n_tiles_x, dtype=torch.int32, device=dev)[None, :, None]
    hx_t = (ax >= xlo_r[:, None, :]) & (ax <= xhi_r[:, None, :])  # (nty,ntx,Mr)
    in_row, tv = _two_level_search(*_rank_table_from_hits(hx_t), M)

    gi = torch.gather(row_idx, 1, in_row.reshape(n_tiles_y, -1).long())
    tile_indices = torch.where(tv, gi.reshape(n_tiles_y, n_tiles_x, M), 0)
    return tile_indices.reshape(T, M), tv.reshape(T, M)


def _bin_gaussians_chunked(means2d, radii, visible, n_tiles_x, n_tiles_y,
                           tile_size, max_per_tile):
    """Table-free compaction: chunk totals + in-chunk ranks on demand.

    Same tables as `_bin_gaussians_search` without the (tiles, Gaussians)
    rank table: per-chunk tile totals from one small product per chunk,
    level 1 of the search over their running sum, then for every slot the
    256 intervals of its chunk (packed into one word per Gaussian) are
    gathered, tested against the slot's tile and ranked.  Tile grids of at
    most 254 per side (byte packing)."""
    M = max_per_tile
    T = n_tiles_x * n_tiles_y
    dev = means2d.device
    c = RANK_CHUNK
    if n_tiles_x >= 255 or n_tiles_y >= 255:
        raise ValueError("chunked binning packs tile coordinates into bytes: "
                         "at most 254 tiles per side")
    n = means2d.shape[0]
    n2 = -(-n // c) * c
    pad = n2 - n
    cxlo, cxhi, cylo, cyhi = tile_intervals(means2d, radii, tile_size)
    # Clamp into byte range; visibility becomes an empty interval.
    cxlo = _pad1(torch.clamp(cxlo, 0, 254), pad, 0)
    cylo = _pad1(torch.clamp(cylo, 0, 254), pad, 0)
    cxhi = _pad1(torch.clamp(torch.where(visible, cxhi, -1), -1,
                             n_tiles_x - 1), pad, -1)
    cyhi = _pad1(torch.clamp(torch.where(visible, cyhi, -1), -1,
                             n_tiles_y - 1), pad, -1)
    n_chunks = n2 // c

    # Per-chunk tile totals: totals[k, y, x] = sum_j hy[kc + j, y] *
    # hx[kc + j, x]; 0/1 products of at most 256 terms, exact in float32.
    ax = torch.arange(n_tiles_x, dtype=torch.int32, device=dev)
    ay = torch.arange(n_tiles_y, dtype=torch.int32, device=dev)
    hx = ((ax[None, :] >= cxlo[:, None]) & (ax[None, :] <= cxhi[:, None])
          ).to(torch.float32)                                    # (n2, ntx)
    hy = ((ay[None, :] >= cylo[:, None]) & (ay[None, :] <= cyhi[:, None])
          ).to(torch.float32)                                    # (n2, nty)
    totals = torch.matmul(hy.reshape(n_chunks, c, n_tiles_y).transpose(1, 2),
                          hx.reshape(n_chunks, c, n_tiles_x))    # (nch,nty,ntx)
    cumtot_t = torch.cumsum(totals.reshape(n_chunks, T).to(torch.int32),
                            dim=0, dtype=torch.int32).T.contiguous()

    count = torch.clamp(cumtot_t[:, -1], max=M)
    k, target2 = _search_chunks(cumtot_t, M)                     # (T, M)

    # Intervals packed one word per Gaussian, biased by 1 so the empty
    # interval's -1 packs as 0; int64 keeps the top byte clear of the sign.
    iv = ((cxlo + 1).long() | ((cxhi + 1).long() << 8)
          | ((cylo + 1).long() << 16) | ((cyhi + 1).long() << 24))
    gidx = k[..., None] * c + torch.arange(c, dtype=torch.int64, device=dev)
    ivk = iv[gidx]                                               # (T, M, c)
    t_ids = torch.arange(T, dtype=torch.int64, device=dev)
    tx1 = (t_ids % n_tiles_x + 1)[:, None, None]
    ty1 = (t_ids // n_tiles_x + 1)[:, None, None]
    hit = ((tx1 >= (ivk & 0xFF)) & (tx1 <= ((ivk >> 8) & 0xFF))
           & (ty1 >= ((ivk >> 16) & 0xFF)) & (ty1 <= (ivk >> 24)))
    # The target-th hit is the first index whose inclusive rank reaches it.
    idx_in = (_inclusive_ranks(hit).to(torch.int32)
              < target2[..., None]).sum(dim=-1)                  # (T, M)

    tile_valid = (torch.arange(M, dtype=torch.int32, device=dev)[None, :]
                  < count[:, None])
    tile_indices = torch.where(tile_valid,
                               torch.clamp(k * c + idx_in, max=n2 - 1), 0)
    return tile_indices.to(torch.int32), tile_valid


def bin_tiles(means2d, radii, visible, n_tiles_x: int, n_tiles_y: int,
              m_cap: int, cfg: "TileRendererConfig"):
    """(tile_indices (T, M) int32, tile_valid (T, M) bool) of depth-sorted
    Gaussians by the binning `cfg` names; every binning gives the same
    tables."""
    n = means2d.shape[0]
    ts = cfg.tile_size
    binning = cfg.binning
    if binning == "auto":
        binning = "search" if n >= _SEARCH_MIN_N else "pairs"
    if binning == "stream":
        return bin_gaussians_stream(means2d, radii, visible, n_tiles_x,
                                    n_tiles_y, ts, m_cap)
    if binning == "chunked":
        return _bin_gaussians_chunked(means2d, radii, visible, n_tiles_x,
                                      n_tiles_y, ts, m_cap)
    if binning == "rows":
        return _bin_gaussians_rows(means2d, radii, visible, n_tiles_x,
                                   n_tiles_y, ts, m_cap,
                                   row_capacity=cfg.row_capacity)
    if binning == "search":
        return _bin_gaussians_search(
            means2d, radii, visible, n_tiles_x, n_tiles_y, ts, m_cap,
            tile_window=cfg.tile_window,
            groups=search_groups(n, n_tiles_x, n_tiles_y),
            table=cfg.table_build)
    return _bin_gaussians(means2d, radii, visible, n_tiles_x, n_tiles_y, ts,
                          m_cap, tile_window=cfg.tile_window)


def _tile_totals(means2d, radii, visible, n_tiles_x, n_tiles_y, tile_size):
    """Unclamped per-tile hit counts (T,) int32: overflow telemetry.

    0/1 products accumulate exactly in float32 below 2^24 hits per tile."""
    dev = means2d.device
    cxlo, cxhi, cylo, cyhi = tile_intervals(means2d, radii, tile_size)
    ax = torch.arange(n_tiles_x, dtype=torch.int32, device=dev)
    ay = torch.arange(n_tiles_y, dtype=torch.int32, device=dev)
    hx = ((ax[None, :] >= cxlo[:, None]) & (ax[None, :] <= cxhi[:, None])
          ).to(torch.float32)                                        # (N, ntx)
    hy = (((ay[None, :] >= cylo[:, None]) & (ay[None, :] <= cyhi[:, None]))
          & visible[:, None]).to(torch.float32)                      # (N, nty)
    tot = hy.T @ hx                                                  # (nty, ntx)
    return tot.reshape(n_tiles_x * n_tiles_y).to(torch.int32)


def tile_pixel_coords(n_tiles_x: int, n_tiles_y: int, tile_size: int,
                      device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Integer pixel coordinates (T, P) of every tile's pixels, as floats:
    px = tx * ts + lx with no half-pixel offset."""
    ts = tile_size
    f32 = torch.float32
    tx = torch.arange(n_tiles_x, dtype=f32, device=device) * ts
    ty = torch.arange(n_tiles_y, dtype=f32, device=device) * ts
    x0 = tx.repeat(n_tiles_y)[:, None]
    y0 = ty.repeat_interleave(n_tiles_x)[:, None]
    lx = torch.arange(ts, dtype=f32, device=device).repeat(ts)[None, :]
    ly = torch.arange(ts, dtype=f32, device=device).repeat_interleave(ts)[None, :]
    return x0 + lx, y0 + ly


def _composite_tiles(px, py, g_mean, g_conic, g_color, g_op, g_depth,
                     g_radius, valid, cfg: TileRendererConfig):
    """Front-to-back compositing of binned Gaussians over tile pixels: the
    plain PyTorch version of the compositing kernel.

    px, py: (T, P); g_*: (T, M, ...).  Chunks of `cfg.chunk` Gaussians use
    the exclusive-cumprod transmittance identity, as the JAX package's
    scan compositor does.  Returns (color (T, P, 3), depth (T, P),
    transmittance (T, P))."""
    T_tiles, M = valid.shape
    P = px.shape[1]
    chunk = cfg.chunk
    if M % chunk:
        raise ValueError(f"M={M} is not a multiple of chunk={chunk}")
    acc_c = torch.zeros((T_tiles, P, 3), dtype=px.dtype, device=px.device)
    acc_d = torch.zeros((T_tiles, P), dtype=px.dtype, device=px.device)
    Tr = torch.ones((T_tiles, P), dtype=px.dtype, device=px.device)
    for i in range(M // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        mean, conic = g_mean[:, sl], g_conic[:, sl]
        dx = px[:, None, :] - mean[..., 0, None]                     # (T, C, P)
        dy = py[:, None, :] - mean[..., 1, None]
        mahal = (conic[..., 0, None] * dx * dx
                 + 2.0 * conic[..., 1, None] * dx * dy
                 + conic[..., 2, None] * dy * dy)
        alpha = torch.exp(-0.5 * mahal) * g_op[:, sl, None]
        if cfg.hard_cutoff:
            rr = g_radius[:, sl, None]
            inside = (torch.abs(dx) <= rr) & (torch.abs(dy) <= rr)
            alpha = torch.where(inside, alpha, 0.0)
        alpha = torch.where(valid[:, sl, None], alpha, 0.0)
        alpha = torch.clamp(alpha, 0.0, ALPHA_MAX)
        T_inc = torch.cumprod(1.0 - alpha, dim=1)
        T_excl = torch.cat([torch.ones_like(T_inc[:, :1]), T_inc[:, :-1]], 1)
        w = alpha * T_excl * Tr[:, None, :]
        acc_c = acc_c + torch.einsum("tcp,tcd->tpd", w, g_color[:, sl])
        acc_d = acc_d + torch.einsum("tcp,tc->tp", w, g_depth[:, sl])
        Tr = Tr * T_inc[:, -1]
    return acc_c, acc_d, Tr


def _check_supported(cfg: TileRendererConfig, phases) -> None:
    if cfg.tile_size != raster.TS:
        raise NotImplementedError(
            f"tile_size {cfg.tile_size} is not ported (only {raster.TS})")
    if not cfg.hard_cutoff:
        raise NotImplementedError("hard_cutoff=False is not ported")
    if cfg.use_phase_blending and phases is not None:
        raise NotImplementedError("phase blending is not ported")
    if cfg.binning not in BINNINGS:
        raise ValueError(f"unknown binning {cfg.binning!r}")
    if cfg.table_build not in TABLE_BUILDS:
        raise ValueError(f"unknown table_build {cfg.table_build!r}")
    if cfg.depth_sort not in ("auto", "exact"):
        raise NotImplementedError(
            f"depth_sort {cfg.depth_sort!r} is not ported (only 'exact')")


@dataclasses.dataclass(frozen=True)
class SortedProjection:
    """A projected cloud in front-to-back order (all shapes lead with N)."""

    means2d: torch.Tensor
    conic: torch.Tensor
    depths: torch.Tensor
    radii: torch.Tensor
    visible: torch.Tensor
    colors: torch.Tensor
    opacities: torch.Tensor   # 0 where invisible


def project_sorted(positions, scales, rotations, colors, opacities,
                   camera: Camera, cfg: TileRendererConfig
                   ) -> SortedProjection:
    """Projection and the stable depth sort: what binning is fed."""
    # The pair window only covers tiles within tile_window // 2 of a
    # Gaussian's center tile: clamp radii to match, for every binning, so
    # that they stay interchangeable.
    eff_max_radius = min(cfg.max_radius,
                         (cfg.tile_window // 2) * cfg.tile_size)
    proj = project_gaussians(positions, scales, rotations, camera,
                             max_radius=eff_max_radius)
    # Zero-opacity Gaussians take no per-tile capacity.
    proj = proj.replace(visible=proj.visible & (opacities > 0.0))
    order = depth_sort_indices(proj, method="exact")
    visible = proj.visible[order]
    return SortedProjection(
        means2d=proj.means2d[order], conic=proj.conic[order],
        depths=proj.depths[order], radii=proj.radii[order], visible=visible,
        colors=colors[order],
        opacities=torch.where(visible, opacities[order], 0.0))


def gather_pack(sp: SortedProjection, tile_idx: torch.Tensor,
                tile_valid: torch.Tensor):
    """One gather from a per-Gaussian packed table into (pack (T, M, 12),
    counts (T,) int32); invalid slots index the sentinel row N (opacity 0,
    radius -1).  The radius only gates the inside-box test, so it carries
    no gradient."""
    n = sp.means2d.shape[0]
    fields = torch.cat(
        [sp.means2d, sp.conic, sp.radii.detach()[:, None], sp.colors,
         sp.opacities[:, None], sp.depths[:, None],
         torch.zeros_like(sp.opacities)[:, None]], dim=-1)       # (N, 12)
    sentinel = torch.zeros((1, PACK), dtype=fields.dtype, device=fields.device)
    sentinel[0, 5] = SENTINEL_RADIUS
    fields = torch.cat([fields, sentinel], dim=0)                # (N+1, 12)
    idx_safe = torch.where(tile_valid, tile_idx, n).long()
    pack = fields[idx_safe].contiguous()                         # (T, M, 12)
    return pack, tile_valid.sum(dim=1, dtype=torch.int32)


def pack_tiles(positions, scales, rotations, colors, opacities,
               camera: Camera, config: TileRendererConfig = TileRendererConfig(),
               phases: Optional[torch.Tensor] = None) -> TilePack:
    """Projection, depth sort, binning and the packed gather: everything
    of `render_tiled` before compositing."""
    cfg = config
    n = positions.shape[0]
    _check_supported(cfg, phases)
    ts = cfg.tile_size
    n_tiles_x = -(-camera.width // ts)
    n_tiles_y = -(-camera.height // ts)
    sp = project_sorted(positions, scales, rotations, colors, opacities,
                        camera, cfg)
    # Per-tile capacity: a multiple of the chunk, at most one rounding
    # above N itself.
    m_cap = min(cfg.max_per_tile, n)
    m_cap = -(-m_cap // cfg.chunk) * cfg.chunk
    tile_idx, tile_valid = bin_tiles(sp.means2d, sp.radii, sp.visible,
                                     n_tiles_x, n_tiles_y, m_cap, cfg)
    pack, counts = gather_pack(sp, tile_idx, tile_valid)
    return TilePack(pack=pack, counts=counts, means2d=sp.means2d,
                    radii=sp.radii, visible=sp.visible, m_cap=m_cap,
                    n_tiles_x=n_tiles_x, n_tiles_y=n_tiles_y)


def render_tiled(positions: torch.Tensor, scales: torch.Tensor,
                 rotations: torch.Tensor, colors: torch.Tensor,
                 opacities: torch.Tensor, camera: Camera,
                 phases: Optional[torch.Tensor] = None,
                 background: Tuple[float, float, float] = (0.0, 0.0, 0.0),
                 return_depth: bool = False,
                 return_transmittance: bool = False,
                 return_overflow: bool = False,
                 config: TileRendererConfig = TileRendererConfig()):
    """Render a Gaussian cloud to a (3, H, W) image in [0, 1].

    Runs on the device of `positions`: on CUDA the compositing goes
    through the hand-written kernels (forward and backward), on the CPU
    through their plain versions; the image is differentiable on both.
    Output order: img[, depth (H, W)][, transmittance (H, W)][, overflow
    (4,) int32 = [dropped_pairs, total_pairs, overflow_tiles,
    max_tile_hits]].
    """
    cfg = config
    H, W = camera.height, camera.width
    ts = cfg.tile_size
    tp = pack_tiles(positions, scales, rotations, colors, opacities, camera,
                    cfg, phases=phases)
    ntx, nty = tp.n_tiles_x, tp.n_tiles_y
    acc_c, acc_d, Tr = raster.composite_tiles_packed(
        tp.pack, tp.counts, ntx, chunk=cfg.chunk)

    bg = torch.tensor(background, dtype=torch.float32, device=acc_c.device)
    acc_c = acc_c + Tr[..., None] * bg

    img = acc_c.reshape(nty, ntx, ts, ts, 3).permute(0, 2, 1, 3, 4)
    img = img.reshape(nty * ts, ntx * ts, 3)
    img = torch.clamp(img[:H, :W], 0.0, 1.0).permute(2, 0, 1)

    def _untile(x):
        x = x.reshape(nty, ntx, ts, ts).permute(0, 2, 1, 3)
        return x.reshape(nty * ts, ntx * ts)[:H, :W]

    out = (img,)
    if return_depth:
        out += (_untile(acc_d),)
    if return_transmittance:
        out += (_untile(Tr),)
    if return_overflow:
        totals = _tile_totals(tp.means2d, tp.radii, tp.visible, ntx, nty, ts)
        m_cap = tp.m_cap
        out += (torch.stack([
            torch.clamp(totals - m_cap, min=0).sum(dtype=torch.int32),
            totals.sum(dtype=torch.int32),
            (totals > m_cap).sum(dtype=torch.int32),
            totals.max()]),)
    return out if len(out) > 1 else img
