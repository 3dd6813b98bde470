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
segment prefixes).  `box=False` (the tiled renderer's hard_cutoff=False)
drops the 3-sigma box test in both kernels and both plain versions, as the
JAX package's XLA scan does.

Phase blending (`composite_tiles_phase`): each slot's alpha is scaled by
an interference factor against the pixel's running weighted phase
(fresnel_tpu/render/tile.py:672-716), the slot's phase riding in pack
column 11.  The kernels are K1-phi (csrc/raster_phase_fwd.cu) and K2-phi
(csrc/raster_phase_bwd.cu), counted by `launches_phase` and
`launches_phase_bwd`; the plain version of K1-phi is tile.py's sequential
`_composite_tiles` phase path, and of K2-phi autograd through it.  The
recurrence is not associative, so a tile's list runs whole in one block
(two pixels per thread, each warp walking only the slots whose box
reaches its strip of the tile); when the pack needs a gradient K1-phi
leaves (T, acc_phase) per pixel every CKPT slots, which K2-phi recomputes
each segment from.  Both take cosf, sinf and the division by exact fast
paths (csrc/raster_common.cuh), which `phase_fastpath_check` holds
against the library on the card; `phase_residency` reads both kernels'
registers and blocks per SM from the CUDA runtime.

Both kernels split a tile's list into segments that run as separate
blocks, the segment length set on the card from the pack's work, at least
SEG slots (csrc/raster_common.cuh).  When the pack needs a gradient, the
forward leaves each segment's prefix in a scratch tensor, which
`_Composite` saves for the backward; `composite_tiles_bwd`, called alone,
has K2 recompute them.

Every function takes the tile size (`tile_size`, default TS = 16; any
size >= 1): a tile holds P = tile_size^2 pixels, and the per-pixel
outputs, cotangents, scratch and checkpoints are (..., P).  The kernels
compile the 16-pixel tile in and take any other size in one runtime
instantiation, in pixel groups of at most GROUP pixels a block; there K1
and K2 are handed an int32 scratch for their launch's plan
(`_plan_buffer`; csrc/raster_common.cuh, plan_units).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

from fresnel_tpu_torch import _build

TS = 16
PIX = TS * TS
GROUP = 256         # the most pixels a block of K1 / K2 takes at a time
PACK = 12
ALPHA_MAX = 0.99

SEG = 64            # the shortest segment of K1 and K2 (raster_common.cuh)
NPART = 5           # floats per pixel and segment in the scratch
BLOCKS_PER_SM = 8   # of K1's 16-pixel kernel, by its launch bounds
CKPT = 16           # slots between K1-phi's checkpoints (raster_common.cuh)

launches = 0        # K1 launches
launches_bwd = 0    # K2 launches
launches_phase = 0      # K1-phi launches
launches_phase_bwd = 0  # K2-phi launches


def _tile_size(tile_size) -> int:
    ts = int(tile_size)
    if ts < 1:
        raise ValueError(f"tile_size must be at least 1, got {tile_size}")
    return ts


def _tile_grid(T: int, M: int, counts: torch.Tensor, n_tiles_x: int,
               device, dtype, tiles_per_image=None, tile_size: int = TS):
    """Pixel coordinates (T, P) and slot validity (T, M) of a pack; tile
    t lies at t % tiles_per_image of its image (default T: one image)."""
    from fresnel_tpu_torch.render.tile import tile_pixel_coords

    ti = T if tiles_per_image is None else tiles_per_image
    n_tiles_y = -(-ti // n_tiles_x)
    px, py = tile_pixel_coords(n_tiles_x, n_tiles_y, _tile_size(tile_size),
                               device)
    valid = (torch.arange(M, device=device)[None, :]
             < counts.to(device)[:, None])
    px, py = px[:ti].to(dtype), py[:ti].to(dtype)
    if ti != T:
        local = torch.arange(T, device=device) % ti
        px, py = px[local], py[local]
    return px, py, valid


def composite_tiles_plain(pack: torch.Tensor, counts: torch.Tensor,
                          n_tiles_x: int, chunk: int = 32,
                          tiles_per_image=None, box: bool = True,
                          phase_amplitude=None, tile_size: int = TS
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1 (or, with a `phase_amplitude`, of
    K1-phi: the phases from pack column 11), on any device and float
    dtype.

    Unpacks the (T, M, 12) pack and runs tile.py's `_composite_tiles`,
    which autograd can differentiate."""
    from fresnel_tpu_torch.render.tile import (
        TileRendererConfig, _composite_tiles)

    T, M, _ = pack.shape
    px, py, valid = _tile_grid(T, M, counts, n_tiles_x, pack.device,
                               pack.dtype, tiles_per_image, tile_size)
    cfg = TileRendererConfig(chunk=chunk, hard_cutoff=box)
    g_phase = None
    if phase_amplitude is not None:
        cfg = dataclasses.replace(cfg, use_phase_blending=True,
                                  phase_amplitude=phase_amplitude)
        g_phase = pack[..., 11]
    return _composite_tiles(
        px, py, pack[..., 0:2], pack[..., 2:5], pack[..., 6:9],
        pack[..., 9], pack[..., 10], pack[..., 5], valid, cfg,
        g_phase=g_phase)


def composite_tiles_phase_bwd_plain(pack, counts, n_tiles_x: int,
                                    phase_amplitude: float, g_color,
                                    g_depth, g_trans, box: bool = True,
                                    tiles_per_image=None,
                                    tile_size: int = TS) -> torch.Tensor:
    """Plain PyTorch version of K2-phi, on any device: the gradient of the
    pack (T, M, 12) by autograd through the plain K1-phi (the radius
    column and slots >= count are 0)."""
    with torch.enable_grad():
        p = pack.detach().requires_grad_()
        out = composite_tiles_plain(p, counts, n_tiles_x,
                                    tiles_per_image=tiles_per_image, box=box,
                                    phase_amplitude=phase_amplitude,
                                    tile_size=tile_size)
        (grad,) = torch.autograd.grad(out, p, (g_color, g_depth, g_trans),
                                      allow_unused=True)
    return torch.zeros_like(pack) if grad is None else grad


def composite_tiles_bwd_plain(pack, counts, n_tiles_x: int, color, depth,
                              trans, g_color, g_depth, g_trans,
                              chunk: int = 32, tiles_per_image=None,
                              box: bool = True, tile_size: int = TS
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
                               pack.dtype, tiles_per_image, tile_size)
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
        inside = valid[:, sl, None]
        if box:
            inside = inside & (torch.abs(dx) <= rr) & (torch.abs(dy) <= rr)
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


def _check_pixels(pack: torch.Tensor, tile_size: int,
                  **tensors: torch.Tensor) -> None:
    """Per-pixel tensors of K2 and K2-phi: float32, contiguous, on the
    pack's device, (T, P, 3) for colours and (T, P) otherwise, P =
    tile_size^2."""
    T, P = pack.shape[0], tile_size * tile_size
    for name, t in tensors.items():
        shape = (T, P, 3) if name in ("color", "g_color") else (T, P)
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != pack.device:
            raise ValueError(f"{name} must be on {pack.device}")


def scratch_shape(T: int, M: int, tile_size: int = TS) -> Tuple[int, ...]:
    """Shape of the kernels' per-segment scratch: (ceil(M / SEG), T, 5,
    P), with no rows when no tile can have two segments."""
    n_seg = -(-M // SEG)
    return (n_seg if n_seg > 1 else 0, T, NPART, tile_size * tile_size)


def block_threads(tile_size: int = TS) -> int:
    """Threads of a K1 / K2 block: one pixel group (at most GROUP
    pixels) in whole warps."""
    return -(-min(tile_size * tile_size, GROUP) // 32) * 32


@functools.lru_cache(maxsize=None)
def resident_blocks(index: int, tile_size: int = TS) -> int:
    """Blocks of K1's kernel that CUDA device `index` holds at once (for
    a size other than 16, the blocks whose threads fill the SM as the
    16-pixel kernel's do, at most 32); it sets the segment length, so K1
    and K2 are given the same."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return sms * min(32, BLOCKS_PER_SM * PIX // block_threads(tile_size))


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


def _plan_buffer(T: int, resident: int, tile_size: int, device):
    """The int32 scratch in which K1 / K2 at a tile size other than 16
    write their launch's plan (csrc/raster_common.cuh, plan_units), or
    None at 16."""
    if tile_size == TS:
        return None
    return torch.empty(3 + 2 * (resident + T), dtype=torch.int32,
                       device=device)


def _per_image(T: int, tiles_per_image) -> int:
    ti = T if tiles_per_image is None else int(tiles_per_image)
    if T and (ti < 1 or T % ti):
        raise ValueError(f"{T} tiles are not whole images of {ti}")
    return max(ti, 1)


def _launch_fwd(pack: torch.Tensor, counts: torch.Tensor, n_tiles_x: int,
                keep_prefix: bool = False, tiles_per_image=None,
                box: bool = True, tile_size: int = TS
                ) -> Tuple[torch.Tensor, ...]:
    """K1 on CUDA tensors: (color, depth, trans, prefix), prefix the
    segment prefixes for K2 when `keep_prefix`, else None."""
    global launches
    _check_inputs(pack, counts)
    ts = _tile_size(tile_size)
    T, M, _ = pack.shape
    P = ts * ts
    ti = _per_image(T, tiles_per_image)
    part = torch.empty(scratch_shape(T, M, ts), dtype=torch.float32,
                       device=pack.device)
    color = torch.empty((T, P, 3), dtype=torch.float32, device=pack.device)
    depth = torch.empty((T, P), dtype=torch.float32, device=pack.device)
    trans = torch.empty((T, P), dtype=torch.float32, device=pack.device)
    prefix = part if keep_prefix else None
    if T == 0:
        return color, depth, trans, prefix
    resident = resident_blocks(pack.device.index or 0, ts)
    plan = _plan_buffer(T, resident, ts, pack.device)
    _build.launch("raster_fwd", pack.device,
                  (pack.data_ptr(), counts.data_ptr(), color.data_ptr(),
                   depth.data_ptr(), trans.data_ptr(), part.data_ptr(),
                   _tile_tickets(T, pack.device).data_ptr(),
                   0 if plan is None else plan.data_ptr()),
                  (T, M, n_tiles_x, ti, resident, int(keep_prefix), int(box),
                   ts))
    launches += 1
    return color, depth, trans, prefix


def _launch_bwd(pack, counts, n_tiles_x: int, color, depth, trans, g_color,
                g_depth, g_trans, prefix=None, tiles_per_image=None,
                box: bool = True, tile_size: int = TS) -> torch.Tensor:
    """K2 on CUDA tensors.  `prefix` is K1's for the same pack and counts;
    without it K2 recomputes it first."""
    global launches_bwd
    _check_inputs(pack, counts)
    ts = _tile_size(tile_size)
    _check_pixels(pack, ts, color=color, depth=depth, trans=trans,
                  g_color=g_color, g_depth=g_depth, g_trans=g_trans)
    T, M, _ = pack.shape
    ti = _per_image(T, tiles_per_image)
    if prefix is None:
        part = torch.empty(scratch_shape(T, M, ts), dtype=torch.float32,
                           device=pack.device)
    elif (tuple(prefix.shape) != scratch_shape(T, M, ts)
          or prefix.dtype != torch.float32 or prefix.device != pack.device
          or not prefix.is_contiguous()):
        raise ValueError("prefix must be K1's for this pack")
    else:
        part = prefix
    grad = torch.empty_like(pack)
    if T == 0:
        return grad
    resident = resident_blocks(pack.device.index or 0, ts)
    plan = _plan_buffer(T, resident, ts, pack.device)
    _build.launch("raster_bwd", pack.device,
                  (pack.data_ptr(), counts.data_ptr(), color.data_ptr(),
                   depth.data_ptr(), trans.data_ptr(), g_color.data_ptr(),
                   g_depth.data_ptr(), g_trans.data_ptr(), part.data_ptr(),
                   _tile_tickets(T, pack.device).data_ptr(),
                   0 if plan is None else plan.data_ptr(), grad.data_ptr()),
                  (T, M, n_tiles_x, ti, resident, int(prefix is not None),
                   int(box), ts))
    launches_bwd += 1
    return grad


def _amplitude(phase_amplitude: float) -> Tuple[float, float]:
    """The kernels' (A, 1 - A): 1 - A computed in double and rounded to
    float32 once, as the plain version's Python scalar is."""
    a = float(phase_amplitude)
    return a, 1.0 - a


def checkpoint_shape(T: int, M: int, tile_size: int = TS
                     ) -> Tuple[int, ...]:
    """Shape of K1-phi's checkpoints: (T, ceil(M / CKPT), 2, P)."""
    return (T, max(1, -(-M // CKPT)), 2, tile_size * tile_size)


def _launch_fwd_phase(pack: torch.Tensor, counts: torch.Tensor,
                      n_tiles_x: int, phase_amplitude: float,
                      keep_ckpt: bool = False, tiles_per_image=None,
                      box: bool = True, tile_size: int = TS
                      ) -> Tuple[torch.Tensor, ...]:
    """K1-phi on CUDA tensors: (color, depth, trans, ckpt), ckpt the
    per-pixel (T, acc_phase) checkpoints for K2-phi when `keep_ckpt`,
    else None."""
    global launches_phase
    _check_inputs(pack, counts)
    ts = _tile_size(tile_size)
    T, M, _ = pack.shape
    P = ts * ts
    ti = _per_image(T, tiles_per_image)
    color = torch.empty((T, P, 3), dtype=torch.float32, device=pack.device)
    depth = torch.empty((T, P), dtype=torch.float32, device=pack.device)
    trans = torch.empty((T, P), dtype=torch.float32, device=pack.device)
    ckpt = (torch.empty(checkpoint_shape(T, M, ts), dtype=torch.float32,
                        device=pack.device) if keep_ckpt else None)
    if T == 0:
        return color, depth, trans, ckpt
    _build.launch("raster_phase_fwd", pack.device,
                  (pack.data_ptr(), counts.data_ptr(), color.data_ptr(),
                   depth.data_ptr(), trans.data_ptr(),
                   0 if ckpt is None else ckpt.data_ptr()),
                  (T, M, n_tiles_x, ti, int(box), ts),
                  _amplitude(phase_amplitude))
    launches_phase += 1
    return color, depth, trans, ckpt


def _launch_bwd_phase(pack, counts, n_tiles_x: int, phase_amplitude: float,
                      g_color, g_depth, g_trans, ckpt: torch.Tensor,
                      tiles_per_image=None, box: bool = True,
                      tile_size: int = TS) -> torch.Tensor:
    """K2-phi on CUDA tensors.  `ckpt` is the checkpoints K1-phi left for
    the same pack (`keep_ckpt=True`)."""
    global launches_phase_bwd
    _check_inputs(pack, counts)
    ts = _tile_size(tile_size)
    T, M, _ = pack.shape
    _check_pixels(pack, ts, g_color=g_color, g_depth=g_depth,
                  g_trans=g_trans)
    if (ckpt is None or tuple(ckpt.shape) != checkpoint_shape(T, M, ts)
            or ckpt.dtype != torch.float32 or ckpt.device != pack.device
            or not ckpt.is_contiguous()):
        raise ValueError("ckpt must be K1-phi's for this pack")
    ti = _per_image(T, tiles_per_image)
    grad = torch.empty_like(pack)
    if T == 0:
        return grad
    _build.launch("raster_phase_bwd", pack.device,
                  (pack.data_ptr(), counts.data_ptr(), g_color.data_ptr(),
                   g_depth.data_ptr(), g_trans.data_ptr(), ckpt.data_ptr(),
                   grad.data_ptr()),
                  (T, M, n_tiles_x, ti, int(box), ts),
                  _amplitude(phase_amplitude))
    launches_phase_bwd += 1
    return grad


def phase_residency(device, tile_size: int = TS) -> dict:
    """Registers, shared and local bytes, threads and blocks per SM of
    K1-phi and K2-phi (their box-test kernels at `tile_size`) on a CUDA
    `device`."""
    return {key: _build.residency(name, device, _tile_size(tile_size))
            for key, name in (("k1phi", "raster_phase_fwd"),
                              ("k2phi", "raster_phase_bwd"))}


def phase_fastpath_check(device) -> dict:
    """On a CUDA `device`, the fast paths K1-phi and K2-phi take against
    the library (csrc/phase_fastpath_check.cu): sin_quadrant against cosf
    and sinf at every float of its range and its negative, div_fast
    against __fdiv_rn on 2^30 pairs across its range.  Counts of the
    arguments checked and of the bitwise mismatches."""
    out = torch.zeros(5, dtype=torch.int64, device=device)
    _build.launch("phase_fastpath_check", device, (out.data_ptr(),), ())
    return dict(zip(("trig_checked", "cos_mismatches", "sin_mismatches",
                     "div_checked", "div_mismatches"), out.tolist()))


def _device_of(pack: torch.Tensor) -> str:
    if pack.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {pack.device}")
    return pack.device.type


def composite_tiles_bwd(pack, counts, n_tiles_x: int, color, depth, trans,
                        g_color, g_depth, g_trans, chunk: int = 32,
                        tiles_per_image=None, box: bool = True,
                        tile_size: int = TS) -> torch.Tensor:
    """Gradient of the pack (T, M, 12) from the forward's outputs (color,
    depth before the background, final transmittance) and their
    cotangents: K2 for CUDA tensors, the plain version for CPU tensors.
    `chunk` is the plain version's step and does not change the kernel."""
    if _device_of(pack) == "cuda":
        return _launch_bwd(pack, counts, n_tiles_x, color, depth, trans,
                           g_color, g_depth, g_trans,
                           tiles_per_image=tiles_per_image, box=box,
                           tile_size=tile_size)
    return composite_tiles_bwd_plain(pack, counts, n_tiles_x, color, depth,
                                     trans, g_color, g_depth, g_trans, chunk,
                                     tiles_per_image, box=box,
                                     tile_size=tile_size)


class _Composite(torch.autograd.Function):
    """K1 forward and K2 backward on CUDA tensors, K2 taking the segment
    prefixes K1 left; the plain versions of both on CPU tensors.  Only the
    pack gets a gradient, and only once: K2 has no derivative, so a second
    derivative raises on both devices."""

    @staticmethod
    def forward(ctx, pack, counts, n_tiles_x: int, chunk: int,
                tiles_per_image, box: bool, tile_size: int):
        if _device_of(pack) == "cuda":
            *out, prefix = _launch_fwd(pack, counts, n_tiles_x,
                                       keep_prefix=ctx.needs_input_grad[0],
                                       tiles_per_image=tiles_per_image,
                                       box=box, tile_size=tile_size)
        else:
            out = composite_tiles_plain(pack, counts, n_tiles_x, chunk,
                                        tiles_per_image, box=box,
                                        tile_size=tile_size)
            prefix = None
        ctx.save_for_backward(pack, counts, *out, prefix)
        ctx.n_tiles_x, ctx.chunk = n_tiles_x, chunk
        ctx.tiles_per_image, ctx.box = tiles_per_image, box
        ctx.tile_size = tile_size
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
                               tiles_per_image=ctx.tiles_per_image,
                               box=ctx.box, tile_size=ctx.tile_size)
        else:
            grad = composite_tiles_bwd_plain(
                pack, counts, ctx.n_tiles_x, color, depth, trans, *cots,
                chunk=ctx.chunk, tiles_per_image=ctx.tiles_per_image,
                box=ctx.box, tile_size=ctx.tile_size)
        return grad, None, None, None, None, None, None


class _CompositePhase(torch.autograd.Function):
    """K1-phi forward and K2-phi backward on CUDA tensors, K2-phi taking
    K1-phi's checkpoints; the plain versions of both on CPU tensors.  Only
    the pack gets a gradient, and only once."""

    @staticmethod
    def forward(ctx, pack, counts, n_tiles_x: int, phase_amplitude: float,
                tiles_per_image, box: bool, tile_size: int):
        if _device_of(pack) == "cuda":
            *out, ckpt = _launch_fwd_phase(
                pack, counts, n_tiles_x, phase_amplitude,
                keep_ckpt=ctx.needs_input_grad[0],
                tiles_per_image=tiles_per_image, box=box,
                tile_size=tile_size)
        else:
            with torch.no_grad():
                out = composite_tiles_plain(
                    pack, counts, n_tiles_x, tiles_per_image=tiles_per_image,
                    box=box, phase_amplitude=phase_amplitude,
                    tile_size=tile_size)
            ckpt = None
        ctx.save_for_backward(pack, counts, ckpt)
        ctx.n_tiles_x, ctx.amp = n_tiles_x, phase_amplitude
        ctx.tiles_per_image, ctx.box = tiles_per_image, box
        ctx.tile_size = tile_size
        return tuple(out)

    @staticmethod
    @once_differentiable
    def backward(ctx, g_color, g_depth, g_trans):
        pack, counts, ckpt = ctx.saved_tensors
        cots = (g_color.contiguous(), g_depth.contiguous(),
                g_trans.contiguous())
        if _device_of(pack) == "cuda":
            grad = _launch_bwd_phase(pack, counts, ctx.n_tiles_x, ctx.amp,
                                     *cots, ckpt=ckpt,
                                     tiles_per_image=ctx.tiles_per_image,
                                     box=ctx.box, tile_size=ctx.tile_size)
        else:
            grad = composite_tiles_phase_bwd_plain(
                pack, counts, ctx.n_tiles_x, ctx.amp, *cots, box=ctx.box,
                tiles_per_image=ctx.tiles_per_image,
                tile_size=ctx.tile_size)
        return grad, None, None, None, None, None, None


def composite_tiles_phase(pack: torch.Tensor, counts: torch.Tensor,
                          n_tiles_x: int, phase_amplitude: float,
                          tiles_per_image=None, box: bool = True,
                          tile_size: int = TS
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Phase-blended compositing of binned, depth-ordered tiles,
    differentiably in the pack (the phase in column 11 included): the
    contract of `composite_tiles_packed`, each slot's alpha scaled by 1 -
    A + A cos(2 pi d) of its phase's wrap-around distance d to the pixel's
    running phase, A = `phase_amplitude`.  CUDA tensors launch K1-phi (and
    K2-phi on backward), CPU tensors run the plain versions."""
    return _CompositePhase.apply(pack, counts, n_tiles_x,
                                 float(phase_amplitude), tiles_per_image,
                                 bool(box), _tile_size(tile_size))


def composite_tiles_packed(pack: torch.Tensor, counts: torch.Tensor,
                           n_tiles_x: int, chunk: int = 32,
                           tiles_per_image=None, box: bool = True,
                           tile_size: int = TS
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Composite binned, depth-ordered tiles, differentiably in the pack.

    pack: (T, M, 12) float32 [mean 2, conic 3, radius, rgb 3, opacity,
    depth, pad], dead slots masked (opacity 0, radius -1); counts: (T,)
    int32 occupied slots.  Returns (color (T, P, 3), depth (T, P),
    transmittance (T, P)), P = tile_size^2 (256 at the default 16), the
    contract of the JAX package's composite_tiles_pallas_packed (and, at
    any other tile size, of its XLA scan).  CUDA tensors launch K1 (and K2
    on backward), CPU tensors run the plain versions.  `chunk` is the
    plain versions' step and does not change the kernels.  A pack of B
    images holds each one's `tiles_per_image` tiles in turn (default T:
    one image), so a batch takes one launch of each kernel.  `box=False`
    drops the 3-sigma box test (hard_cutoff=False)."""
    return _Composite.apply(pack, counts, n_tiles_x, chunk, tiles_per_image,
                            bool(box), _tile_size(tile_size))
