"""The dense splat: every Gaussian of an image onto every pixel, no
compositing.  The hand-written CUDA kernels and their plain versions.

For each pixel p of image b: out[b, p, c] = sum_g w(g, p) V[b, g, c], in
one of two modes (csrc/dense_common.cuh):
  WAVE  w = exp(-m / 2) * opacity inside the +-radius box (m the conic's
        quadratic form), the wave-field renderer's amplitude
        (fresnel_tpu/render/wave.py:63-84); V is 8 channels there;
  ISO   w = exp(-(dx^2 + dy^2) / (2 sigma^2 + 1e-8)) * opacity, no box, the
        Fourier renderer's spatial splat (fresnel_tpu/render/fourier.py:
        85-106); V is the colour there.
The per-Gaussian parameters are one (B, N, 8) tensor [mx, my, conic a (ISO:
sigma), b, c, radius, opacity, 0]; the radius carries no gradient.

`dense_splat` goes through the autograd Function `_DenseSplat` on both
devices: for CUDA tensors its forward launches K5 (csrc/dense_fwd.cu: a
block per 16 x 16 tile culls the image's Gaussians together and walks
only those that reach the tile) and its backward K6 (csrc/dense_bwd.cu: a
warp per Gaussian walks its window's rows, 32 columns at a time, and
combines its lanes in a fixed order; no scratch); for CPU tensors the
plain version `dense_splat_plain` (the JAX package's scan: chunks of 64
Gaussians, one einsum each) and autograd through it.  There is no fall
back from one to the other.  `launches` and `launches_bwd` count calls of
each kernel's C entry point.  B images take one launch.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from fresnel_tpu_torch import _build
from fresnel_tpu_torch.render.raster import _device_of

WAVE, ISO = 0, 1
CHANNELS = {WAVE: 8, ISO: 3}
NP = 8          # parameters per Gaussian
CHUNK = 64      # Gaussians per step of the plain version (the JAX scan's)

launches = 0        # K5 launches
launches_bwd = 0    # K6 launches


def splat_weights(params: torch.Tensor, X: torch.Tensor, Y: torch.Tensor,
                  mode: int) -> torch.Tensor:
    """w (C, H, W) of the (C, 8) Gaussians `params` at pixel grids X, Y."""
    dx = X[None] - params[:, 0, None, None]
    dy = Y[None] - params[:, 1, None, None]
    op = params[:, 6, None, None]
    if mode == WAVE:
        mahal = (params[:, 2, None, None] * dx * dx
                 + 2.0 * params[:, 3, None, None] * dx * dy
                 + params[:, 4, None, None] * dy * dy)
        amp = torch.exp(-0.5 * mahal) * op
        rr = params[:, 5, None, None]
        return torch.where((torch.abs(dx) <= rr) & (torch.abs(dy) <= rr),
                           amp, 0.0)
    sg = params[:, 2, None, None]
    return torch.exp(-(dx * dx + dy * dy) / (2.0 * sg * sg + 1e-8)) * op


def dense_splat_plain(params: torch.Tensor, V: torch.Tensor, height: int,
                      width: int, mode: int, chunk: int = CHUNK
                      ) -> torch.Tensor:
    """Plain PyTorch version of K5 on any device: (B, H, W, C), the scan
    over chunks of `chunk` Gaussians of the JAX renderers, each chunk's
    weights contracted with its values by one einsum.  Differentiable."""
    B, N = params.shape[:2]
    Y, X = torch.meshgrid(
        torch.arange(height, dtype=params.dtype, device=params.device),
        torch.arange(width, dtype=params.dtype, device=params.device),
        indexing="ij")
    out = []
    for b in range(B):
        acc = torch.zeros((height, width, V.shape[-1]), dtype=params.dtype,
                          device=params.device)
        for i in range(0, N, chunk):
            w = splat_weights(params[b, i:i + chunk], X, Y, mode)
            acc = acc + torch.einsum("chw,cd->hwd", w, V[b, i:i + chunk])
        out.append(acc)
    return torch.stack(out)


def dense_splat_bwd_plain(params, V, g_out, mode: int):
    """Plain PyTorch version of K6 on any device: (g_params, g_V) by
    autograd through the plain K5 (the radius column and the ISO mode's
    unused columns are 0)."""
    H, W = g_out.shape[1:3]
    with torch.enable_grad():
        p = params.detach().requires_grad_()
        v = V.detach().requires_grad_()
        out = dense_splat_plain(p, v, H, W, mode)
        g_p, g_v = torch.autograd.grad(out, (p, v), g_out, allow_unused=True)
    return (torch.zeros_like(params) if g_p is None else g_p,
            torch.zeros_like(V) if g_v is None else g_v)


def _check(params: torch.Tensor, V: torch.Tensor, mode: int) -> None:
    if mode not in CHANNELS:
        raise ValueError(f"unknown mode {mode}")
    C = CHANNELS[mode]
    for name, t, last in (("params", params, NP), ("V", V, C)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 3 or t.shape[2] != last:
            raise ValueError(f"{name} must be (B, N, {last}), got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if params.shape[:2] != V.shape[:2] or params.device != V.device:
        raise ValueError("params and V must be (B, N, ...) on one device")


def _launch_fwd(params: torch.Tensor, V: torch.Tensor, height: int,
                width: int, mode: int) -> torch.Tensor:
    """K5 on CUDA tensors: (B, H, W, C)."""
    global launches
    _check(params, V, mode)
    B, N = params.shape[:2]
    out = torch.empty((B, height, width, CHANNELS[mode]),
                      dtype=torch.float32, device=params.device)
    if B == 0 or height * width == 0:
        return out
    _build.launch("dense_fwd", params.device,
                  (params.data_ptr(), V.data_ptr(), out.data_ptr()),
                  (B, N, height, width, mode))
    launches += 1
    return out


def _launch_bwd(params: torch.Tensor, V: torch.Tensor, g_out: torch.Tensor,
                mode: int):
    """K6 on CUDA tensors: (g_params (B, N, 8), g_V (B, N, C))."""
    global launches_bwd
    _check(params, V, mode)
    B, N = params.shape[:2]
    H, W = g_out.shape[1:3]
    if (g_out.dtype != torch.float32 or tuple(g_out.shape)
            != (B, H, W, CHANNELS[mode]) or not g_out.is_contiguous()
            or g_out.device != params.device):
        raise ValueError("g_out must be the contiguous float32 cotangent of "
                         "K5's output")
    if g_out.data_ptr() % 16:
        g_out = g_out.clone()     # K6 reads a WAVE pixel as two float4s
    g_params = torch.empty_like(params)
    g_V = torch.empty_like(V)
    if B * N == 0:
        return g_params.zero_(), g_V.zero_()
    _build.launch("dense_bwd", params.device,
                  (params.data_ptr(), V.data_ptr(), g_out.data_ptr(),
                   g_params.data_ptr(), g_V.data_ptr()),
                  (B, N, H, W, mode))
    launches_bwd += 1
    return g_params, g_V


class _DenseSplat(torch.autograd.Function):
    """K5 forward and K6 backward on CUDA tensors; the plain version and
    autograd through it on CPU tensors.  Differentiable once."""

    @staticmethod
    def forward(ctx, params, V, height: int, width: int, mode: int):
        if _device_of(params) == "cuda":
            out = _launch_fwd(params, V, height, width, mode)
        else:
            with torch.no_grad():
                out = dense_splat_plain(params, V, height, width, mode)
        ctx.save_for_backward(params, V)
        ctx.mode = mode
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g_out):
        params, V = ctx.saved_tensors
        g_out = g_out.contiguous()
        if _device_of(params) == "cuda":
            g_p, g_v = _launch_bwd(params, V, g_out, ctx.mode)
        else:
            g_p, g_v = dense_splat_bwd_plain(params, V, g_out, ctx.mode)
        return g_p, g_v, None, None, None


def dense_splat(params: torch.Tensor, V: torch.Tensor, height: int,
                width: int, mode: int) -> torch.Tensor:
    """(B, H, W, C) sums of w(g, p) V[g] over each image's Gaussians
    (params (B, N, 8), V (B, N, C)), differentiable in both: K5 / K6 for
    CUDA tensors, the plain versions for CPU tensors."""
    return _DenseSplat.apply(params.contiguous(), V.contiguous(),
                             int(height), int(width), int(mode))
