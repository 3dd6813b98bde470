"""Helpers shared by the physics, models, render and losses packages,
below all four: the JAX package's float32 rounding of a few small
functions, kept bit for bit.

  * `wrap_phase`: jnp.mod(phi, 2 pi);
  * `Conv2d`: Flax's Conv in a compute dtype on float32 parameters;
  * `resize_linear`: jax.image.resize(..., "linear") on the last two axes;
  * `fftfreq`, `linspace`: jnp.fft.fftfreq and jnp.linspace as jitted JAX
    functions give them (XLA takes a division by a constant as a product
    with its reciprocal).
The constant tables (resize weights, frequency grids, planes) are built
on the host once and kept on each device they are asked for: a fresh copy
from the host each call would wait for the stream on the card.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

TWO_PI = 6.283185307179586


def wrap_phase(phi: torch.Tensor) -> torch.Tensor:
    """phi mod 2 pi with the sign of the divisor, as jnp.mod: fmod, then 2
    pi added where the remainder is negative (its gradient is 1)."""
    two_pi = torch.tensor(TWO_PI, dtype=phi.dtype, device=phi.device)
    r = torch.fmod(phi, two_pi)
    return torch.where((r != 0) & (r < 0), r + two_pi, r)



class Conv2d(nn.Conv2d):
    """nn.Conv2d (NCHW) whose float32 parameters are cast to the input's
    dtype.  With bf16 parameters (`use_amp`, which casts them) the bias is
    added after the convolution is rounded to bf16, as Flax's Conv adds
    it: the fused bias rounds once, and the port's bf16 rotations and edge
    gradients then leave twice JAX's own bf16 gap
    (tests/test_torch_amp.py).  Layers that compute in bf16 on float32
    parameters (CVS, the ViTs) keep the fused bias."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype)
        if self.weight.dtype == torch.bfloat16 and self.bias is not None:
            return (self._conv_forward(x, w, None)
                    + self.bias.to(x.dtype).reshape(-1, 1, 1))
        b = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, w, b)



def _resize_weights(n_in: int, n_out: int, antialias: bool = True
                    ) -> np.ndarray:
    """(n_in, n_out) float32 weights of a linear resize along one axis,
    antialiased when downsampling (if `antialias`), computed in float32 in
    the order of jax.image.scale_and_translate's weight matrix."""
    f = np.float32
    inv = f(1.0 / (n_out / n_in))
    kscale = max(inv, f(1.0)) if antialias else f(1.0)
    sample = (np.arange(n_out, dtype=f) + f(0.5)) * inv - f(0.0) * inv - f(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f)[:, None]) / kscale
    w = np.maximum(f(0.0), f(1.0) - np.abs(x))
    tot = w.sum(axis=0, keepdims=True, dtype=f)
    w = np.where(np.abs(tot) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(tot != 0, tot, f(1.0)), f(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f(0.0)).astype(f)


@functools.lru_cache(maxsize=None)
def _resize_matrix(n_in: int, n_out: int, antialias: bool,
                   device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """`_resize_weights` on `device` in `dtype`, made once: a fresh copy
    from the host each call would wait for the stream on the card."""
    return torch.from_numpy(_resize_weights(n_in, n_out, antialias)).to(
        device=device, dtype=dtype)


def resize_linear(x: torch.Tensor, out_h: int, out_w: int,
                  antialias: bool = True) -> torch.Tensor:
    """(..., H, W) -> (..., out_h, out_w) bilinear with half-pixel centres,
    antialiased when downsampling (unless `antialias` is False): what
    jax.image.resize(..., "linear") does to the last two axes, as two
    products with its weight matrices, rows first, the weights rounded as
    JAX rounds them and cast to x's dtype (in bf16 each product rounds to
    bf16, as XLA:CPU's does; F.interpolate places samples up to ~1e-5 px
    apart, which moves an upsampled image by ~4e-6)."""
    H, W = x.shape[-2:]
    if H != out_h:
        wh = _resize_matrix(H, out_h, antialias, x.device, x.dtype)
        x = torch.einsum("...hw,hH->...Hw", x, wh)
    if W != out_w:
        ww = _resize_matrix(W, out_w, antialias, x.device, x.dtype)
        x = torch.einsum("...hw,wW->...hW", x, ww)
    return x



def _host_fftfreq(n: int, d: float) -> np.ndarray:
    i = np.arange(n, dtype=np.float32)
    k = ((i + n // 2) % n - n // 2).astype(np.float32)
    return (k * (np.float32(1.0) / np.float32(d * n))).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _fftfreq_on(n: int, d: float, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_host_fftfreq(n, d)).to(device)


def fftfreq(n: int, d: float = 1.0, device=None) -> torch.Tensor:
    """float32 jnp.fft.fftfreq(n, d) as a jitted JAX function gives it,
    bit for bit (k * (1 / (d n))).  Made once per device, as
    `_resize_matrix`: the caller must not modify it."""
    return _fftfreq_on(int(n), float(d), torch.device(device or "cpu"))


def _host_linspace(start: float, stop: float, num: int) -> np.ndarray:
    s, e = np.float32(start), np.float32(stop)
    if num == 1:
        return np.array([s], np.float32)
    div = num - 1
    step = (np.arange(div, dtype=np.float32)
            * (np.float32(1.0) / np.float32(div))).astype(np.float32)
    out = (s * (np.float32(1.0) - step)).astype(np.float32) \
        + (e * step).astype(np.float32)
    return np.concatenate([out.astype(np.float32), [e]]).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _linspace_on(start: float, stop: float, num: int,
                 device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_host_linspace(start, stop, num)).to(device)


def linspace(start: float, stop: float, num: int, device=None
             ) -> torch.Tensor:
    """float32 jnp.linspace(start, stop, num) as a jitted JAX function
    gives it, bit for bit.  Made once per device: the caller must not
    modify it."""
    return _linspace_on(float(start), float(stop), int(num),
                        torch.device(device or "cpu"))
