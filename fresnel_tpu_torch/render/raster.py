"""Tile compositing: the hand-written CUDA kernels and their plain versions.

Counterpart of fresnel_tpu/render/pallas_raster.py.  The forward kernel
(K1) is csrc/raster_fwd.cu, the backward kernel (K2, the analytic VJP) is
csrc/raster_bwd.cu; both include csrc/raster_common.cuh.  `_build` compiles
each with nvcc for sm_90a at first use and binds its plain C function with
ctypes.

`composite_tiles_packed` goes through the autograd Function `_Composite`
on both devices: for CUDA tensors its forward launches K1 and its backward
K2; for CPU tensors they run the plain versions `composite_tiles_plain` and
`composite_tiles_bwd_plain`.  There is no fall back from one to the other.
`launches` and `launches_bwd` count calls of each kernel's C entry point
(K2's also launches K1's kernel as its pre-pass when it is not handed K1's
segment prefixes).

Both kernels split a tile's list into segments that run as separate
blocks, the segment length set on the card from the pack's work, at least
SEG slots (csrc/raster_common.cuh).  When the pack needs a gradient, the
forward leaves each segment's prefix in a scratch tensor, which
`_Composite` saves for the backward; `composite_tiles_bwd`, called alone,
has K2 recompute them.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

from fresnel_tpu_torch import _build

TS = 16
PIX = TS * TS
PACK = 12
ALPHA_MAX = 0.99

SEG = 64            # the shortest segment of K1 and K2 (raster_common.cuh)
NPART = 5           # floats per pixel and segment in the scratch
BLOCKS_PER_SM = 8   # of K1's kernel, by its launch bounds

launches = 0        # K1 launches
launches_bwd = 0    # K2 launches


def _tile_grid(T: int, M: int, counts: torch.Tensor, n_tiles_x: int,
               device, dtype, tiles_per_image=None):
    """Pixel coordinates (T, P) and slot validity (T, M) of a pack; tile
    t lies at t % tiles_per_image of its image (default T: one image)."""
    from fresnel_tpu_torch.render.tile import tile_pixel_coords

    ti = T if tiles_per_image is None else tiles_per_image
    n_tiles_y = -(-ti // n_tiles_x)
    px, py = tile_pixel_coords(n_tiles_x, n_tiles_y, TS, device)
    valid = (torch.arange(M, device=device)[None, :]
             < counts.to(device)[:, None])
    px, py = px[:ti].to(dtype), py[:ti].to(dtype)
    if ti != T:
        local = torch.arange(T, device=device) % ti
        px, py = px[local], py[local]
    return px, py, valid


def composite_tiles_plain(pack: torch.Tensor, counts: torch.Tensor,
                          n_tiles_x: int, chunk: int = 32,
                          tiles_per_image=None
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1, on any device and float dtype.

    Unpacks the (T, M, 12) pack and runs tile.py's `_composite_tiles`,
    which autograd can differentiate."""
    from fresnel_tpu_torch.render.tile import (
        TileRendererConfig, _composite_tiles)

    T, M, _ = pack.shape
    px, py, valid = _tile_grid(T, M, counts, n_tiles_x, pack.device,
                               pack.dtype, tiles_per_image)
    return _composite_tiles(
        px, py, pack[..., 0:2], pack[..., 2:5], pack[..., 6:9],
        pack[..., 9], pack[..., 10], pack[..., 5], valid,
        TileRendererConfig(chunk=chunk))


def composite_tiles_bwd_plain(pack, counts, n_tiles_x: int, color, depth,
                              trans, g_color, g_depth, g_trans,
                              chunk: int = 32, tiles_per_image=None
                              ) -> torch.Tensor:
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
                               pack.dtype, tiles_per_image)
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


def scratch_shape(T: int, M: int) -> Tuple[int, ...]:
    """Shape of the kernels' per-segment scratch: (ceil(M / SEG), T, 5,
    256), with no rows when no tile can have two segments."""
    n_seg = -(-M // SEG)
    return (n_seg if n_seg > 1 else 0, T, NPART, PIX)


@functools.lru_cache(maxsize=None)
def resident_blocks(index: int) -> int:
    """Blocks of K1's kernel that CUDA device `index` holds at once; it
    sets the segment length, so K1 and K2 are given the same."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return sms * BLOCKS_PER_SM


def segment_length(counts: torch.Tensor, M: int, resident: int) -> int:
    """The segment length L the kernels choose for a pack, on the host:
    the card's share of the occupied slots, sum(count) / resident, rounded
    up to a multiple of SEG, within [SEG, max(SEG, M)]."""
    total = int(counts.clamp(0, M).sum().item())
    share = -(-total // resident)
    return SEG * min(max(1, -(-M // SEG)), max(1, -(-share // SEG)))


# Per (device, stream): the per-tile arrival counters of K1's fold, zero
# between launches (the unit that folds a tile sets its counter back).
_tickets = {}


def _tile_tickets(T: int, device) -> torch.Tensor:
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    buf = _tickets.get(key)
    if buf is None or buf.numel() < T:
        buf = torch.zeros(T, dtype=torch.int32, device=device)
        _tickets[key] = buf
    return buf


def _per_image(T: int, tiles_per_image) -> int:
    ti = T if tiles_per_image is None else int(tiles_per_image)
    if T and (ti < 1 or T % ti):
        raise ValueError(f"{T} tiles are not whole images of {ti}")
    return max(ti, 1)


def _launch_fwd(pack: torch.Tensor, counts: torch.Tensor, n_tiles_x: int,
                keep_prefix: bool = False, tiles_per_image=None
                ) -> Tuple[torch.Tensor, ...]:
    """K1 on CUDA tensors: (color, depth, trans, prefix), prefix the
    segment prefixes for K2 when `keep_prefix`, else None."""
    global launches
    _check_inputs(pack, counts)
    T, M, _ = pack.shape
    ti = _per_image(T, tiles_per_image)
    part = torch.empty(scratch_shape(T, M), dtype=torch.float32,
                       device=pack.device)
    color = torch.empty((T, PIX, 3), dtype=torch.float32, device=pack.device)
    depth = torch.empty((T, PIX), dtype=torch.float32, device=pack.device)
    trans = torch.empty((T, PIX), dtype=torch.float32, device=pack.device)
    prefix = part if keep_prefix else None
    if T == 0:
        return color, depth, trans, prefix
    _build.launch("raster_fwd", pack.device,
                  (pack.data_ptr(), counts.data_ptr(), color.data_ptr(),
                   depth.data_ptr(), trans.data_ptr(), part.data_ptr(),
                   _tile_tickets(T, pack.device).data_ptr()),
                  (T, M, n_tiles_x, ti,
                   resident_blocks(pack.device.index or 0),
                   int(keep_prefix)))
    launches += 1
    return color, depth, trans, prefix


def _launch_bwd(pack, counts, n_tiles_x: int, color, depth, trans, g_color,
                g_depth, g_trans, prefix=None, tiles_per_image=None
                ) -> torch.Tensor:
    """K2 on CUDA tensors.  `prefix` is K1's for the same pack and counts;
    without it K2 recomputes it first."""
    global launches_bwd
    _check_inputs(pack, counts)
    _check_pixels(pack, color=color, depth=depth, trans=trans,
                  g_color=g_color, g_depth=g_depth, g_trans=g_trans)
    T, M, _ = pack.shape
    ti = _per_image(T, tiles_per_image)
    if prefix is None:
        part = torch.empty(scratch_shape(T, M), dtype=torch.float32,
                           device=pack.device)
    elif (tuple(prefix.shape) != scratch_shape(T, M)
          or prefix.dtype != torch.float32 or prefix.device != pack.device
          or not prefix.is_contiguous()):
        raise ValueError("prefix must be K1's for this pack")
    else:
        part = prefix
    grad = torch.empty_like(pack)
    if T == 0:
        return grad
    _build.launch("raster_bwd", pack.device,
                  (pack.data_ptr(), counts.data_ptr(), color.data_ptr(),
                   depth.data_ptr(), trans.data_ptr(), g_color.data_ptr(),
                   g_depth.data_ptr(), g_trans.data_ptr(), part.data_ptr(),
                   _tile_tickets(T, pack.device).data_ptr(), grad.data_ptr()),
                  (T, M, n_tiles_x, ti,
                   resident_blocks(pack.device.index or 0),
                   int(prefix is not None)))
    launches_bwd += 1
    return grad


def _device_of(pack: torch.Tensor) -> str:
    if pack.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {pack.device}")
    return pack.device.type


def composite_tiles_bwd(pack, counts, n_tiles_x: int, color, depth, trans,
                        g_color, g_depth, g_trans, chunk: int = 32,
                        tiles_per_image=None) -> torch.Tensor:
    """Gradient of the pack (T, M, 12) from the forward's outputs (color,
    depth before the background, final transmittance) and their
    cotangents: K2 for CUDA tensors, the plain version for CPU tensors.
    `chunk` is the plain version's step and does not change the kernel."""
    if _device_of(pack) == "cuda":
        return _launch_bwd(pack, counts, n_tiles_x, color, depth, trans,
                           g_color, g_depth, g_trans,
                           tiles_per_image=tiles_per_image)
    return composite_tiles_bwd_plain(pack, counts, n_tiles_x, color, depth,
                                     trans, g_color, g_depth, g_trans, chunk,
                                     tiles_per_image)


class _Composite(torch.autograd.Function):
    """K1 forward and K2 backward on CUDA tensors, K2 taking the segment
    prefixes K1 left; the plain versions of both on CPU tensors.  Only the
    pack gets a gradient, and only once: K2 has no derivative, so a second
    derivative raises on both devices."""

    @staticmethod
    def forward(ctx, pack, counts, n_tiles_x: int, chunk: int,
                tiles_per_image):
        if _device_of(pack) == "cuda":
            *out, prefix = _launch_fwd(pack, counts, n_tiles_x,
                                       keep_prefix=ctx.needs_input_grad[0],
                                       tiles_per_image=tiles_per_image)
        else:
            out = composite_tiles_plain(pack, counts, n_tiles_x, chunk,
                                        tiles_per_image)
            prefix = None
        ctx.save_for_backward(pack, counts, *out, prefix)
        ctx.n_tiles_x, ctx.chunk = n_tiles_x, chunk
        ctx.tiles_per_image = tiles_per_image
        return tuple(out)

    @staticmethod
    @once_differentiable
    def backward(ctx, g_color, g_depth, g_trans):
        # Autograd hands unused outputs' cotangents over as zeros (the
        # Function's default), so all three are tensors here.
        pack, counts, color, depth, trans, prefix = ctx.saved_tensors
        cots = (g_color.contiguous(), g_depth.contiguous(),
                g_trans.contiguous())
        if _device_of(pack) == "cuda":
            grad = _launch_bwd(pack, counts, ctx.n_tiles_x, color, depth,
                               trans, *cots, prefix=prefix,
                               tiles_per_image=ctx.tiles_per_image)
        else:
            grad = composite_tiles_bwd_plain(
                pack, counts, ctx.n_tiles_x, color, depth, trans, *cots,
                chunk=ctx.chunk, tiles_per_image=ctx.tiles_per_image)
        return grad, None, None, None, None


def composite_tiles_packed(pack: torch.Tensor, counts: torch.Tensor,
                           n_tiles_x: int, chunk: int = 32,
                           tiles_per_image=None
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Composite binned, depth-ordered tiles, differentiably in the pack.

    pack: (T, M, 12) float32 [mean 2, conic 3, radius, rgb 3, opacity,
    depth, pad], dead slots masked (opacity 0, radius -1); counts: (T,)
    int32 occupied slots.  Returns (color (T, 256, 3), depth (T, 256),
    transmittance (T, 256)), the contract of the JAX package's
    composite_tiles_pallas_packed.  CUDA tensors launch K1 (and K2 on
    backward), CPU tensors run the plain versions.  `chunk` is the plain
    versions' step and does not change the kernels.  A pack of B images
    holds each one's `tiles_per_image` tiles in turn (default T: one
    image), so a batch takes one launch of each kernel."""
    return _Composite.apply(pack, counts, n_tiles_x, chunk, tiles_per_image)
