"""Dense front-to-back compositing: every Gaussian at every pixel of one
image, depth-sorted.  The hand-written CUDA kernels and their plain
versions.

For each pixel, over the Gaussians in order: alpha_i from the Gaussian's
weight there, w_i = alpha_i T_i with T_0 = 1, T_{i+1} = T_i (1 - alpha_i).
Two modes (csrc/dense_composite_common.cuh):
  DENSE   alpha = clip(exp(-m / 2) opacity, 0, 0.99), m the conic's
          quadratic form, no box: fresnel_tpu/render/dense.py::render_dense
          (:35-115); the depth channel is sum w depth;
  SIMPLE  alpha = clip(exp(-(dx^2 + dy^2) / (2 sigma^2)) opacity, 0, 1)
          inside |dx|, |dy| <= radius + 1: fresnel_tpu/render/simplified.py
          (:22-92); the depth channel is the least depth where alpha > 0.1
          (+inf where none passes).
The per-Gaussian parameters are one (N, 8) tensor in front-to-back order,
[mx, my, conic a (SIMPLE: sigma), b, c, radius (SIMPLE only; no
gradient), opacity, depth], and the colours (N, 3).  The outputs are
(H, W, 4) [colour, depth channel] and the final transmittance (H, W),
before any background.

`dense_composite` goes through the autograd Function `_DenseComposite` on
both devices: for CUDA tensors its forward launches K7
(csrc/dense_composite_fwd.cu) and its backward K8
(csrc/dense_composite_bwd.cu); for CPU tensors the plain version
`dense_composite_plain` (the JAX package's scan: chunks of Gaussians, an
exclusive cumprod of 1 - alpha inside each) and autograd through it.
There is no fall back from one to the other.  `launches` and
`launches_bwd` count calls of each kernel's C entry point.

`chunk` is the JAX scan's step (256 DENSE, 128 SIMPLE by default).  It
changes the plain version's rounding, and in SIMPLE mode where a pixel's
least depth is shared by several Gaussians it sets how the depth's
gradient splits among them (jnp.min over a chunk splits it evenly,
jnp.minimum between the running minimum and a chunk's in halves), which
K8 follows.

The kernels' design (the sources' notes say more).  A block owns a tile
of 32 x 16 pixels, two pixels a thread.  K7 first lists, per tile and in
index order, the Gaussians whose exact reach (past it the weight is 0
bit for bit) meets the tile, and walks only its list; K8 walks the same
lists back to front in runs of SUB = 16, each from a transmittance K7
checkpointed at the run's start, so every pair's alpha is evaluated once
in each kernel (with the same folded constants and intrinsics, so K8's
transmittances are K7's bits).  What K7 leaves for K8 (`_launch_fwd`'s
`ck` and `aux`) is sized for the most every tile could list:
  ck   4 * 512 * tiles * ceil(N / 16) bytes, 64 bytes per (16 x 16
       pixels, Gaussian): 359 MB at 512^2 with N = 5 476, 90 MB at 256^2;
  aux  4 * (tiles * N + 2 N + tiles + 3 H W) bytes: the lists (11 MB at
       512^2, N = 5 476), the tile boxes, the lists' lengths and SIMPLE's
       tie record;
with tiles = ceil(W / 32) ceil(H / 16): ck is about H W N / 4 bytes
(6.55 GB for 10^5 Gaussians at 512^2).  Sizing them to the lists' real
lengths would need those lengths on the host, a synchronisation inside
every launch.  They live from the forward to the backward.  An
allocation that does not fit raises as torch raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from fresnel_tpu_torch import _build
from fresnel_tpu_torch.render.raster import _device_of
from fresnel_tpu_torch.render.wave import jclip

DENSE, SIMPLE = 0, 1
NP = 8          # parameters per Gaussian
CHUNK = {DENSE: 256, SIMPLE: 128}   # the JAX scans' steps
TILE = (32, 16)     # K7 / K8's tile, (width, height) in pixels
SUB = 16            # a tile's listed Gaussians per K8 run; a checkpoint each
ALPHA_MAX = {DENSE: 0.99, SIMPLE: 1.0}
HIT_ALPHA = 0.1     # SIMPLE: the depth channel takes alpha above this

launches = 0        # K7 launches
launches_bwd = 0    # K8 launches


def composite_alpha(params: torch.Tensor, X: torch.Tensor, Y: torch.Tensor,
                    mode: int) -> torch.Tensor:
    """alpha (C, H, W) of the (C, 8) Gaussians `params` at pixel grids X,
    Y, rounded op by op as the JAX renderers write it."""
    dx = X[None] - params[:, 0, None, None]
    dy = Y[None] - params[:, 1, None, None]
    op = params[:, 6, None, None]
    if mode == DENSE:
        mahal = (params[:, 2, None, None] * dx * dx
                 + 2.0 * params[:, 3, None, None] * dx * dy
                 + params[:, 4, None, None] * dy * dy)
        return jclip(torch.exp(-0.5 * mahal) * op, 0.0, ALPHA_MAX[DENSE])
    sig = params[:, 2, None, None]
    w = torch.exp(-(dx * dx + dy * dy) / (2.0 * sig * sig))
    rr = params[:, 5, None, None]
    w = torch.where((torch.abs(dx) <= rr + 1) & (torch.abs(dy) <= rr + 1),
                    w, 0.0)
    return jclip(w * op, 0.0, ALPHA_MAX[SIMPLE])


def dense_composite_plain(params: torch.Tensor, colors: torch.Tensor,
                          height: int, width: int, mode: int,
                          chunk: Optional[int] = None, row0: int = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K7 on any device: (out (H, W, 4),
    transmittance (H, W)), the JAX package's scan over chunks of `chunk`
    Gaussians, each compositing its chunk by an exclusive cumprod.
    Differentiable; in SIMPLE mode the depth channel's gradient splits
    among tied Gaussians as jax.grad splits it.  With `row0` it gives
    the band of `height` rows from row row0 of a taller image (pixels are
    independent, so bands hold the plain backward's memory down)."""
    chunk = CHUNK[mode] if chunk is None else int(chunk)
    dev, dt = params.device, params.dtype
    Y, X = torch.meshgrid(torch.arange(row0, row0 + height, dtype=dt,
                                       device=dev),
                          torch.arange(width, dtype=dt, device=dev),
                          indexing="ij")
    acc = torch.zeros((height, width, 3), dtype=dt, device=dev)
    inf = torch.tensor(float("inf"), dtype=dt, device=dev)
    chan = (torch.zeros((height, width), dtype=dt, device=dev)
            if mode == DENSE else inf.expand(height, width))
    T = torch.ones((height, width), dtype=dt, device=dev)
    for i in range(0, params.shape[0], chunk):
        p = params[i:i + chunk]
        alpha = composite_alpha(p, X, Y, mode)
        T_inc = torch.cumprod(1.0 - alpha, dim=0)
        T_excl = torch.cat([torch.ones_like(T_inc[:1]), T_inc[:-1]], dim=0)
        w = alpha * T_excl * T[None]
        acc = acc + torch.einsum("chw,cd->hwd", w, colors[i:i + chunk])
        if mode == DENSE:
            chan = chan + torch.einsum("chw,c->hw", w, p[:, 7])
        else:
            hit = torch.where(alpha > HIT_ALPHA, p[:, 7, None, None], inf)
            chan = torch.minimum(chan, torch.amin(hit, dim=0))
        T = T * T_inc[-1]
    return torch.cat([acc, chan[..., None]], dim=-1), T


def dense_composite_bwd_plain(params, colors, height: int, width: int,
                              mode: int, chunk, g_out, g_trans,
                              row0: int = 0):
    """Plain PyTorch version of K8 on any device: (g_params, g_colors) by
    autograd through the plain K7 (the radius column and the mode's unused
    columns are 0); with `row0`, of the band that `dense_composite_plain`
    gives, `g_out` and `g_trans` the band's cotangents."""
    with torch.enable_grad():
        p = params.detach().requires_grad_()
        c = colors.detach().requires_grad_()
        out, trans = dense_composite_plain(p, c, height, width, mode, chunk,
                                           row0)
        g_p, g_c = torch.autograd.grad((out, trans), (p, c),
                                       (g_out, g_trans), allow_unused=True)
    return (torch.zeros_like(params) if g_p is None else g_p,
            torch.zeros_like(colors) if g_c is None else g_c)


def _check(params: torch.Tensor, colors: torch.Tensor, mode: int) -> None:
    if mode not in (DENSE, SIMPLE):
        raise ValueError(f"unknown mode {mode}")
    for name, t, last in (("params", params, NP), ("colors", colors, 3)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 2 or t.shape[1] != last:
            raise ValueError(f"{name} must be (N, {last}), got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if params.shape[0] != colors.shape[0] or params.device != colors.device:
        raise ValueError("params and colors must be (N, ...) on one device")


def n_tiles(height: int, width: int) -> int:
    """K7 / K8's tiles (blocks) for an image."""
    return -(-width // TILE[0]) * -(-height // TILE[1])


def checkpoint_shape(n: int, height: int, width: int
                     ) -> Tuple[int, int, int]:
    """K7's transmittance checkpoints: per tile, one per pixel at the start
    of each run of SUB entries of its list (room for n listed)."""
    return (n_tiles(height, width), -(-n // SUB), TILE[0] * TILE[1])


def aux_numel(n: int, height: int, width: int) -> int:
    """int32s of K7's scratch for K8: the tile lists (n per tile), the
    tile boxes (2 per Gaussian), the lists' lengths and SIMPLE's tie
    record (3 per pixel); laid out as `Scratch` in
    csrc/dense_composite_common.cuh."""
    tiles = n_tiles(height, width)
    return tiles * n + 2 * n + tiles + 3 * height * width


def residency(device) -> dict:
    """Registers, shared and local (spill) bytes, threads and blocks per SM
    of K7's and K8's compositing kernels in each mode on a CUDA
    `device`."""
    return {f"{key}_{mname}": _build.residency(name, device, mode)
            for key, name in (("k7", "dense_composite_fwd"),
                              ("k8", "dense_composite_bwd"))
            for mode, mname in ((DENSE, "dense"), (SIMPLE, "simple"))}


def _launch_fwd(params: torch.Tensor, colors: torch.Tensor, height: int,
                width: int, mode: int, chunk: int):
    """K7 on CUDA tensors: (out (H, W, 4), transmittance (H, W), the
    checkpoints (`checkpoint_shape`), the int32 scratch K8 reads (the tile
    lists and SIMPLE's tie record, `aux_numel`))."""
    global launches
    _check(params, colors, mode)
    N = params.shape[0]
    dev = params.device
    out = torch.empty((height, width, 4), dtype=torch.float32, device=dev)
    trans = torch.empty((height, width), dtype=torch.float32, device=dev)
    ck = torch.empty(checkpoint_shape(N, height, width), dtype=torch.float32,
                     device=dev)
    aux = torch.empty(aux_numel(N, height, width), dtype=torch.int32,
                      device=dev)
    if height * width == 0:
        return out, trans, ck, aux
    _build.launch("dense_composite_fwd", dev,
                  (params.data_ptr(), colors.data_ptr(), out.data_ptr(),
                   trans.data_ptr(), ck.data_ptr(), aux.data_ptr()),
                  (N, height, width, mode, chunk))
    launches += 1
    return out, trans, ck, aux


def _launch_bwd(params, colors, out, ck, aux, g_out, g_trans, mode: int,
                chunk: int):
    """K8 on CUDA tensors: (g_params (N, 8), g_colors (N, 3))."""
    global launches_bwd
    _check(params, colors, mode)
    N = params.shape[0]
    H, W = out.shape[:2]
    for name, t, shape in (("g_out", g_out, (H, W, 4)),
                           ("g_trans", g_trans, (H, W))):
        if (t.dtype != torch.float32 or tuple(t.shape) != shape
                or not t.is_contiguous() or t.device != params.device):
            raise ValueError(f"{name} must be the contiguous float32 "
                             f"cotangent of K7's output {shape}")
    g_params = torch.zeros_like(params)
    g_colors = torch.zeros_like(colors)
    if N == 0 or H * W == 0:
        return g_params, g_colors
    _build.launch("dense_composite_bwd", params.device,
                  (params.data_ptr(), colors.data_ptr(), out.data_ptr(),
                   ck.data_ptr(), aux.data_ptr(), g_out.data_ptr(),
                   g_trans.data_ptr(), g_params.data_ptr(),
                   g_colors.data_ptr()),
                  (N, H, W, mode, chunk))
    launches_bwd += 1
    return g_params, g_colors


class _DenseComposite(torch.autograd.Function):
    """K7 forward and K8 backward on CUDA tensors (K8 reading K7's
    checkpoints); the plain version and autograd through it on CPU
    tensors.  Differentiable once."""

    @staticmethod
    def forward(ctx, params, colors, height: int, width: int, mode: int,
                chunk: int):
        if _device_of(params) == "cuda":
            out, trans, ck, aux = _launch_fwd(params, colors, height, width,
                                              mode, chunk)
        else:
            with torch.no_grad():
                out, trans = dense_composite_plain(params, colors, height,
                                                   width, mode, chunk)
            ck = aux = None
        ctx.save_for_backward(params, colors, out, ck, aux)
        ctx.mode, ctx.chunk = mode, chunk
        return out, trans

    @staticmethod
    @once_differentiable
    def backward(ctx, g_out, g_trans):
        params, colors, out, ck, aux = ctx.saved_tensors
        g_out, g_trans = g_out.contiguous(), g_trans.contiguous()
        if _device_of(params) == "cuda":
            g_p, g_c = _launch_bwd(params, colors, out, ck, aux, g_out,
                                   g_trans, ctx.mode, ctx.chunk)
        else:
            H, W = out.shape[:2]
            g_p, g_c = dense_composite_bwd_plain(params, colors, H, W,
                                                 ctx.mode, ctx.chunk, g_out,
                                                 g_trans)
        return g_p, g_c, None, None, None, None


def dense_composite(params: torch.Tensor, colors: torch.Tensor, height: int,
                    width: int, mode: int, chunk: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out (H, W, 4), transmittance (H, W)) of the depth-sorted Gaussians
    `params` (N, 8) with `colors` (N, 3), differentiable in both: K7 / K8
    for CUDA tensors, the plain versions for CPU tensors."""
    chunk = CHUNK[mode] if chunk is None else int(chunk)
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    return _DenseComposite.apply(params.contiguous(), colors.contiguous(),
                                 int(height), int(width), int(mode), chunk)
