"""Tile-binned rasterizer: the render step of the image->3DGS path.

Counterpart of fresnel_tpu/render/tile.py for the path bench.py runs:
  1. project every Gaussian and take its 3-sigma radius;
  2. stable front-to-back depth sort;
  3. pair binning: each 16x16 tile keeps up to M nearest intersecting
     Gaussians in depth order (`_bin_gaussians`, tables bit-identical to
     the JAX package's);
  4. one packed gather of a per-Gaussian (N + 1, 12) table through a
     sentinel row (opacity 0, radius -1) into (T, M, 12);
  5. front-to-back compositing of each tile, through
     `render.raster.composite_tiles_packed`: the hand-written CUDA kernels
     for CUDA tensors (K1 forward, K2 backward), their plain versions for
     CPU tensors.  The gradient of the pack flows back through the packed
     gather to projection; the radius carries none.

Options of the JAX renderer that this path does not run raise
NotImplementedError: the "search", "stream", "rows" and "chunked" binnings
(and "auto" at N >= 98 304, where it picks "search"), phase blending,
depth sorts other than "exact", tile sizes other than 16 and
hard_cutoff=False.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from fresnel_tpu_torch.core.camera import Camera
from fresnel_tpu_torch.render import raster
from fresnel_tpu_torch.render.projection import (
    depth_sort_indices,
    project_gaussians,
)

ALPHA_MAX = raster.ALPHA_MAX
# Sentinel-row radius: the inside-box test |d| <= -1 is false everywhere.
SENTINEL_RADIUS = -1.0
PACK = 12       # [mean 2, conic 3, radius, rgb 3, opacity, depth, pad]
_SEARCH_MIN_N = 98304   # binning="auto" switches to "search" from here


@dataclasses.dataclass(frozen=True)
class TileRendererConfig:
    """Same fields and defaults as the JAX package's config.

    `backend` and `pallas_interpret` choose between the JAX package's
    compositors; here the tensor's device decides (the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors), so they are accepted
    and have no effect.  `row_capacity` and `table_build` belong to
    binnings that are not ported."""

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


def _tile_intervals(means2d, radii, tile_size):
    """Inclusive tile-index intervals [lo, hi] each Gaussian's box touches.

    a*ts <= u+r  <=>  a <= floor((u+r)/ts);  u-r < (a+1)*ts  <=>
    a >= floor((u-r)/ts)."""
    ts = float(tile_size)
    u, v, r = means2d[:, 0], means2d[:, 1], radii
    cxlo = torch.floor((u - r) / ts).to(torch.int32)
    cxhi = torch.floor((u + r) / ts).to(torch.int32)
    cylo = torch.floor((v - r) / ts).to(torch.int32)
    cyhi = torch.floor((v + r) / ts).to(torch.int32)
    return cxlo, cxhi, cylo, cyhi


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
    cxlo, cxhi, cylo, cyhi = _tile_intervals(means2d, radii, tile_size)
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


def _tile_totals(means2d, radii, visible, n_tiles_x, n_tiles_y, tile_size):
    """Unclamped per-tile hit counts (T,) int32: overflow telemetry.

    0/1 products accumulate exactly in float32 below 2^24 hits per tile."""
    dev = means2d.device
    cxlo, cxhi, cylo, cyhi = _tile_intervals(means2d, radii, tile_size)
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


def _check_supported(cfg: TileRendererConfig, n: int, phases) -> None:
    if cfg.tile_size != raster.TS:
        raise NotImplementedError(
            f"tile_size {cfg.tile_size} is not ported (only {raster.TS})")
    if not cfg.hard_cutoff:
        raise NotImplementedError("hard_cutoff=False is not ported")
    if cfg.use_phase_blending and phases is not None:
        raise NotImplementedError("phase blending is not ported")
    if cfg.binning not in ("auto", "pairs"):
        raise NotImplementedError(
            f"binning {cfg.binning!r} is not ported (only 'pairs')")
    if cfg.binning == "auto" and n >= _SEARCH_MIN_N:
        raise NotImplementedError(
            f"binning='auto' at N={n} >= {_SEARCH_MIN_N} picks 'search', "
            "which is not ported")
    if cfg.depth_sort not in ("auto", "exact"):
        raise NotImplementedError(
            f"depth_sort {cfg.depth_sort!r} is not ported (only 'exact')")


def pack_tiles(positions, scales, rotations, colors, opacities,
               camera: Camera, config: TileRendererConfig = TileRendererConfig(),
               phases: Optional[torch.Tensor] = None) -> TilePack:
    """Projection, depth sort, pair binning and the packed gather:
    everything of `render_tiled` before compositing."""
    cfg = config
    n = positions.shape[0]
    _check_supported(cfg, n, phases)
    H, W = camera.height, camera.width
    ts = cfg.tile_size
    n_tiles_x = -(-W // ts)
    n_tiles_y = -(-H // ts)

    # The pair window only covers tiles within tile_window // 2 of a
    # Gaussian's center tile: clamp radii to match.
    eff_max_radius = min(cfg.max_radius, (cfg.tile_window // 2) * ts)
    proj = project_gaussians(positions, scales, rotations, camera,
                             max_radius=eff_max_radius)
    # Zero-opacity Gaussians take no per-tile capacity.
    proj = proj.replace(visible=proj.visible & (opacities > 0.0))
    order = depth_sort_indices(proj, method="exact")

    means2d = proj.means2d[order]
    conic = proj.conic[order]
    depths = proj.depths[order]
    radii = proj.radii[order]
    visible = proj.visible[order]
    colors_s = colors[order]
    opac_s = torch.where(visible, opacities[order], 0.0)

    m_cap = min(cfg.max_per_tile, n)
    m_cap = -(-m_cap // cfg.chunk) * cfg.chunk
    tile_idx, tile_valid = _bin_gaussians(
        means2d, radii, visible, n_tiles_x, n_tiles_y, ts, m_cap,
        tile_window=cfg.tile_window)

    # One gather from a per-Gaussian packed table; invalid slots index the
    # sentinel row N (opacity 0, radius -1).  The radius only gates the
    # inside-box test, so it carries no gradient.
    fields = torch.cat(
        [means2d, conic, radii.detach()[:, None], colors_s,
         opac_s[:, None], depths[:, None], torch.zeros_like(opac_s)[:, None]],
        dim=-1)                                                      # (N, 12)
    sentinel = torch.zeros((1, PACK), dtype=fields.dtype, device=fields.device)
    sentinel[0, 5] = SENTINEL_RADIUS
    fields = torch.cat([fields, sentinel], dim=0)                    # (N+1, 12)
    idx_safe = torch.where(tile_valid, tile_idx, n).long()
    pack = fields[idx_safe].contiguous()                             # (T, M, 12)
    counts = tile_valid.sum(dim=1, dtype=torch.int32)
    return TilePack(pack=pack, counts=counts, means2d=means2d, radii=radii,
                    visible=visible, m_cap=m_cap, n_tiles_x=n_tiles_x,
                    n_tiles_y=n_tiles_y)


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
