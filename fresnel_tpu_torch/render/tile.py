"""Tile-binned rasterizer: projection, depth sort, binning, compositing.

Counterpart of fresnel_tpu/render/tile.py:
  1. project every Gaussian and take its 3-sigma radius;
  2. stable front-to-back depth sort ("exact"; `depth_sort` "counting"
     or "packed" sort quantised depths, as the JAX package's do);
  3. binning: each tile (16 x 16 pixels by default, `tile_size` any size
     >= 1) keeps up to M nearest intersecting Gaussians in depth order.
     Five binnings build the same tables, bit for bit
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
  4. one packed gather of the occupied slots' per-Gaussian rows into
     (T, M, 12), empty slots holding a sentinel row (opacity 0, radius
     -1);
  5. front-to-back compositing of each tile, through
     `render.raster.composite_tiles_packed`: the hand-written CUDA kernels
     for CUDA tensors (K1 forward, K2 backward), their plain versions for
     CPU tensors.  The gradient of the pack flows back through the packed
     gather to projection; the radius and the binning carry none.

With `use_phase_blending` and phases (N,) or (N, 3) (the first channel is
taken, as the JAX package takes it), each Gaussian's phase rides in the
pack's column 11 and the tiles composite through
`render.raster.composite_tiles_phase` (K1-phi and K2-phi on the card);
given no phases, phase blending is off, as in the JAX package.
`hard_cutoff=False` drops the 3-sigma box test, as the JAX package's XLA
scan does (its TPU kernel keeps the box whatever the option says).

Every tile size >= 1 renders, on both devices: the kernels take it
(`render.raster`), as the JAX package's XLA scan takes it; a tile size
below 1 raises ValueError.
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
    batch_cameras,
    depth_sort_indices,
    project_gaussians,
)
from fresnel_tpu_torch.render.stream_binning import bin_gaussians_stream

ALPHA_MAX = raster.ALPHA_MAX
TWO_PI = 6.283185307179586
# Sentinel-row radius: the inside-box test |d| <= -1 is false everywhere.
SENTINEL_RADIUS = -1.0
PACK = 12       # [mean 2, conic 3, radius, rgb 3, opacity, depth, phase]
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
                     g_radius, valid, cfg: TileRendererConfig, g_phase=None):
    """Front-to-back compositing of binned Gaussians over tile pixels: the
    plain PyTorch version of the compositing kernels.

    px, py: (T, P); g_*: (T, M, ...).  Chunks of `cfg.chunk` Gaussians use
    the exclusive-cumprod transmittance identity, as the JAX package's
    scan compositor does; with `g_phase` (T, M) it runs the phase-blending
    recurrence one slot at a time, as the JAX package does.  Returns
    (color (T, P, 3), depth (T, P), transmittance (T, P))."""
    if g_phase is not None:
        return _composite_tiles_phase(px, py, g_mean, g_conic, g_color,
                                      g_op, g_depth, g_radius, valid, cfg,
                                      g_phase)
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


def _composite_tiles_phase(px, py, g_mean, g_conic, g_color, g_op, g_depth,
                           g_radius, valid, cfg: TileRendererConfig,
                           g_phase):
    """The phase-blending path of `_composite_tiles`: strictly sequential
    per slot, each alpha scaled by the interference of the slot's phase
    with the pixel's running weighted phase (unit-interval phases,
    wrap-around distance), clipped to ALPHA_MAX after the interference."""
    T_tiles, M = valid.shape
    P = px.shape[1]
    A = cfg.phase_amplitude
    acc_c = torch.zeros((T_tiles, P, 3), dtype=px.dtype, device=px.device)
    acc_d = torch.zeros((T_tiles, P), dtype=px.dtype, device=px.device)
    Tr = torch.ones((T_tiles, P), dtype=px.dtype, device=px.device)
    acc_phase = torch.zeros((T_tiles, P), dtype=px.dtype, device=px.device)
    for i in range(M):
        mean, conic = g_mean[:, i], g_conic[:, i]
        dx = px - mean[:, 0:1]
        dy = py - mean[:, 1:2]
        mahal = (conic[:, 0:1] * dx * dx + 2.0 * conic[:, 1:2] * dx * dy
                 + conic[:, 2:3] * dy * dy)
        alpha = torch.exp(-0.5 * mahal) * g_op[:, i, None]
        if cfg.hard_cutoff:
            rr = g_radius[:, i, None]
            alpha = torch.where((torch.abs(dx) <= rr) & (torch.abs(dy) <= rr),
                                alpha, 0.0)
        alpha = torch.where(valid[:, i, None], alpha, 0.0)
        phase = g_phase[:, i, None]
        diff = torch.abs(phase - acc_phase)
        diff = torch.minimum(diff, 1.0 - diff)
        interference = (1.0 - A) + A * torch.cos(diff * TWO_PI)
        alpha = torch.clamp(alpha * interference, 0.0, ALPHA_MAX)
        w = alpha * Tr
        acc_c = acc_c + w[..., None] * g_color[:, i, None, :]
        acc_d = acc_d + w * g_depth[:, i, None]
        new_acc_alpha = (1.0 - Tr) + w
        Tr = Tr * (1.0 - alpha)
        contrib = w / torch.clamp(new_acc_alpha, min=1e-6)
        acc_phase = acc_phase * (1.0 - contrib) + phase * contrib
    return acc_c, acc_d, Tr


def _check_supported(cfg: TileRendererConfig) -> None:
    if cfg.tile_size < 1:
        raise ValueError(f"tile_size must be at least 1, got {cfg.tile_size}")
    if cfg.binning not in BINNINGS:
        raise ValueError(f"unknown binning {cfg.binning!r}")
    if cfg.table_build not in TABLE_BUILDS:
        raise ValueError(f"unknown table_build {cfg.table_build!r}")


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
    phases: Optional[torch.Tensor] = None   # (N,), when blended


def blend_phases(cfg: TileRendererConfig, phases, batched: bool = False):
    """The per-Gaussian phase the compositor blends, (N,) (or (B, N) when
    `batched`), or None: only with `use_phase_blending` and phases given;
    of per-RGB phases (N, 3) the first channel."""
    if not cfg.use_phase_blending or phases is None:
        return None
    return phases[..., 0] if phases.dim() > 1 + batched else phases


def project_sorted(positions, scales, rotations, colors, opacities,
                   camera: Camera, cfg: TileRendererConfig,
                   phases: Optional[torch.Tensor] = None
                   ) -> SortedProjection:
    """Projection and the stable depth sort: what binning is fed.
    `phases` (N,) are the blended phases, if any."""
    # The pair window only covers tiles within tile_window // 2 of a
    # Gaussian's center tile: clamp radii to match, for every binning, so
    # that they stay interchangeable.
    eff_max_radius = min(cfg.max_radius,
                         (cfg.tile_window // 2) * cfg.tile_size)
    proj = project_gaussians(positions, scales, rotations, camera,
                             max_radius=eff_max_radius)
    # Zero-opacity Gaussians take no per-tile capacity.
    proj = proj.replace(visible=proj.visible & (opacities > 0.0))
    # "auto" is "exact" (the JAX package measured both quantised sorts
    # no faster, fresnel_tpu/render/tile.py:778-784).
    order = depth_sort_indices(
        proj, method="exact" if cfg.depth_sort == "auto" else cfg.depth_sort)
    visible = proj.visible[order]
    return SortedProjection(
        means2d=proj.means2d[order], conic=proj.conic[order],
        depths=proj.depths[order], radii=proj.radii[order], visible=visible,
        colors=colors[order],
        opacities=torch.where(visible, opacities[order], 0.0),
        phases=None if phases is None else phases[order])


def _pack_fields(sp: SortedProjection) -> torch.Tensor:
    """The per-Gaussian packed rows (N, 12), the blended phase (or 0) in
    the last column.  The radius only gates the inside-box test, so it
    carries no gradient."""
    phase = (torch.zeros_like(sp.opacities) if sp.phases is None
             else sp.phases)
    return torch.cat(
        [sp.means2d, sp.conic, sp.radii.detach()[:, None], sp.colors,
         sp.opacities[:, None], sp.depths[:, None], phase[:, None]], dim=-1)


def _gather_rows(fields: torch.Tensor, tile_idx: torch.Tensor,
                 tile_valid: torch.Tensor) -> torch.Tensor:
    """(T, M, 12) pack of `fields` rows: occupied slots hold their
    Gaussian's row, the rest the sentinel row (opacity 0, radius -1).

    Only the occupied slots are gathered, so the backward scatters into
    `fields` from those alone (at most the tile window's 25 slots per
    Gaussian), where gathering every slot through a sentinel row summed
    every empty slot's zero into that one row, serially.  The scatter is
    the index backward with accumulate=True, which sums in slot order
    (bit-repeatable; a plain index_add_ sums with atomics on the card)."""
    pack = torch.zeros(tuple(tile_idx.shape) + (PACK,), dtype=fields.dtype,
                       device=fields.device)
    pack[..., 5] = SENTINEL_RADIUS
    pack[tile_valid] = fields[tile_idx[tile_valid].long()]
    return pack


def gather_pack(sp: SortedProjection, tile_idx: torch.Tensor,
                tile_valid: torch.Tensor):
    """(pack (T, M, 12), counts (T,) int32): one gather of the occupied
    slots' per-Gaussian rows; empty slots hold the sentinel row (opacity 0,
    radius -1)."""
    pack = _gather_rows(_pack_fields(sp), tile_idx, tile_valid)
    return pack, tile_valid.sum(dim=1, dtype=torch.int32)


def _layout(cfg: TileRendererConfig, camera: Camera, n: int):
    """(n_tiles_x, n_tiles_y, m_cap) of N Gaussians under `camera`.  The
    per-tile capacity is a multiple of the chunk, at most one rounding
    above N itself."""
    ts = cfg.tile_size
    m_cap = min(cfg.max_per_tile, n)
    m_cap = -(-m_cap // cfg.chunk) * cfg.chunk
    return -(-camera.width // ts), -(-camera.height // ts), m_cap


def _project_and_bin(positions, scales, rotations, colors, opacities,
                     camera: Camera, cfg: TileRendererConfig, n_tiles_x: int,
                     n_tiles_y: int, m_cap: int, phases=None):
    """(SortedProjection, tile_idx (T, M), tile_valid (T, M)) of one
    cloud; `phases` (N,) the blended phases, if any."""
    sp = project_sorted(positions, scales, rotations, colors, opacities,
                        camera, cfg, phases)
    tile_idx, tile_valid = bin_tiles(sp.means2d, sp.radii, sp.visible,
                                     n_tiles_x, n_tiles_y, m_cap, cfg)
    return sp, tile_idx, tile_valid


def _untile(x: torch.Tensor, n_tiles_x: int, n_tiles_y: int, tile_size: int,
            height: int, width: int) -> torch.Tensor:
    """(B * T, ts * ts[, C]) tile-major pixels -> (B, H, W[, C])."""
    tail = tuple(x.shape[2:])
    ts = tile_size
    x = x.reshape((-1, n_tiles_y, n_tiles_x, ts, ts) + tail).transpose(2, 3)
    x = x.reshape((x.shape[0], n_tiles_y * ts, n_tiles_x * ts) + tail)
    return x[:, :height, :width]


def pack_tiles(positions, scales, rotations, colors, opacities,
               camera: Camera, config: TileRendererConfig = TileRendererConfig(),
               phases: Optional[torch.Tensor] = None) -> TilePack:
    """Projection, depth sort, binning and the packed gather: everything
    of `render_tiled` before compositing (the blended phases, if any, in
    column 11)."""
    cfg = config
    _check_supported(cfg)
    ntx, nty, m_cap = _layout(cfg, camera, positions.shape[0])
    sp, tile_idx, tile_valid = _project_and_bin(
        positions, scales, rotations, colors, opacities, camera, cfg, ntx,
        nty, m_cap, blend_phases(cfg, phases))
    pack, counts = gather_pack(sp, tile_idx, tile_valid)
    return TilePack(pack=pack, counts=counts, means2d=sp.means2d,
                    radii=sp.radii, visible=sp.visible, m_cap=m_cap,
                    n_tiles_x=ntx, n_tiles_y=nty)


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
    `phases` (N,) or (N, 3), with config.use_phase_blending, blend by
    interference.  Output order: img[, depth (H, W)][, transmittance (H,
    W)][, overflow (4,) int32 = [dropped_pairs, total_pairs,
    overflow_tiles, max_tile_hits]].
    """
    cfg = config
    H, W = camera.height, camera.width
    ts = cfg.tile_size
    tp = pack_tiles(positions, scales, rotations, colors, opacities, camera,
                    cfg, phases=phases)
    ntx, nty = tp.n_tiles_x, tp.n_tiles_y
    acc_c, acc_d, Tr = _composite(cfg, tp.pack, tp.counts, ntx,
                                  blend_phases(cfg, phases) is not None)

    bg = torch.tensor(background, dtype=torch.float32, device=acc_c.device)
    acc_c = acc_c + Tr[..., None] * bg

    def untile(x):
        return _untile(x, ntx, nty, ts, H, W)[0]

    img = torch.clamp(untile(acc_c), 0.0, 1.0).permute(2, 0, 1)
    out = (img,)
    if return_depth:
        out += (untile(acc_d),)
    if return_transmittance:
        out += (untile(Tr),)
    if return_overflow:
        out += (_overflow(tp.means2d, tp.radii, tp.visible, ntx, nty, ts,
                          tp.m_cap),)
    return out if len(out) > 1 else img


def _composite(cfg: TileRendererConfig, pack, counts, n_tiles_x: int,
               blended: bool, tiles_per_image=None):
    """The pack's compositing: phase-blended (K1-phi / K2-phi) when
    `blended`, else K1 / K2; the box test per cfg.hard_cutoff, at
    cfg.tile_size."""
    if blended:
        return raster.composite_tiles_phase(
            pack, counts, n_tiles_x, cfg.phase_amplitude,
            tiles_per_image=tiles_per_image, box=cfg.hard_cutoff,
            tile_size=cfg.tile_size)
    return raster.composite_tiles_packed(
        pack, counts, n_tiles_x, chunk=cfg.chunk,
        tiles_per_image=tiles_per_image, box=cfg.hard_cutoff,
        tile_size=cfg.tile_size)


def _overflow(means2d, radii, visible, n_tiles_x, n_tiles_y, tile_size,
              m_cap) -> torch.Tensor:
    """(4,) int32 [dropped_pairs, total_pairs, overflow_tiles,
    max_tile_hits] of one image."""
    totals = _tile_totals(means2d, radii, visible, n_tiles_x, n_tiles_y,
                          tile_size)
    return torch.stack([
        torch.clamp(totals - m_cap, min=0).sum(dtype=torch.int32),
        totals.sum(dtype=torch.int32),
        (totals > m_cap).sum(dtype=torch.int32),
        totals.max()])


@dataclasses.dataclass(frozen=True)
class BatchPack:
    """B images' binned tiles in one (B * T, M, 12) pack, image b's T
    tiles at rows [b * T, (b + 1) * T)."""

    pack: torch.Tensor        # (B * T, M, 12) float32
    counts: torch.Tensor      # (B * T,) int32
    overflow: torch.Tensor    # (B, 4) int32
    tiles_per_image: int
    n_tiles_x: int
    n_tiles_y: int


def pack_tiles_batched(positions, scales, rotations, colors, opacities,
                       cameras, config: TileRendererConfig = TileRendererConfig(),
                       phases: Optional[torch.Tensor] = None) -> BatchPack:
    """Projection, sort and binning of each of B clouds (B, N, ...) under
    its camera (one Camera for all or a sequence of B), then one gather of
    every image's occupied slots into one pack; `phases` (B, N[, 3]) with
    use_phase_blending ride in column 11."""
    cfg = config
    B, n = positions.shape[:2]
    _check_supported(cfg)
    blended = blend_phases(cfg, phases, batched=True)
    cams = batch_cameras(cameras, B)
    ntx, nty, m_cap = _layout(cfg, cams[0], n)
    fields, idx, valid, ovf = [], [], [], []
    for b in range(B):
        sp, tile_idx, tile_valid = _project_and_bin(
            positions[b], scales[b], rotations[b], colors[b], opacities[b],
            cams[b], cfg, ntx, nty, m_cap,
            None if blended is None else blended[b])
        fields.append(_pack_fields(sp))
        idx.append(tile_idx.long() + b * n)
        valid.append(tile_valid)
        ovf.append(_overflow(sp.means2d, sp.radii, sp.visible, ntx, nty,
                             cfg.tile_size, m_cap))
    valid = torch.cat(valid)
    pack = _gather_rows(torch.cat(fields), torch.cat(idx), valid)
    return BatchPack(pack=pack, counts=valid.sum(dim=1, dtype=torch.int32),
                     overflow=torch.stack(ovf), tiles_per_image=ntx * nty,
                     n_tiles_x=ntx, n_tiles_y=nty)


def render_tiled_batched(positions: torch.Tensor, scales: torch.Tensor,
                         rotations: torch.Tensor, colors: torch.Tensor,
                         opacities: torch.Tensor, cameras,
                         config: TileRendererConfig = TileRendererConfig(),
                         phases: Optional[torch.Tensor] = None):
    """Render B clouds (B, N, ...) to (images (B, 3, H, W), depth (B, H, W),
    overflow (B, 4) int32), what `jax.vmap` of `render_tiled(...,
    return_depth=True, return_overflow=True)` returns; `phases` (B, N[,
    3]) blend by interference under use_phase_blending (K1-phi / K2-phi,
    one launch each for the batch).

    `cameras` is one Camera for every image or a sequence of B.  Each
    image is projected, sorted and binned alone; the B packs are one
    (B * T, M, 12) pack from a single gather, composited by one launch of
    K1 (and K2 on backward) for CUDA tensors.  On the CPU every image
    equals its own `render_tiled` bit for bit."""
    cfg = config
    cam = cameras[0] if isinstance(cameras, (list, tuple)) else cameras
    bp = pack_tiles_batched(positions, scales, rotations, colors, opacities,
                            cameras, cfg, phases)
    ntx, nty = bp.n_tiles_x, bp.n_tiles_y
    acc_c, acc_d, _ = _composite(cfg, bp.pack, bp.counts, ntx,
                                 blend_phases(cfg, phases, True) is not None,
                                 tiles_per_image=bp.tiles_per_image)

    def untile(x):
        return _untile(x, ntx, nty, cfg.tile_size, cam.height, cam.width)

    img = torch.clamp(untile(acc_c), 0.0, 1.0).permute(0, 3, 1, 2)
    return img, untile(acc_d), bp.overflow
