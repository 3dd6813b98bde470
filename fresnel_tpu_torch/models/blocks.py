"""Shared model building blocks.

Counterpart of fresnel_tpu/models/blocks.py (`MLP` with dropout,
`sinusoidal_encode` / `PoseEncoder`, `bilinear_sample` /
`FeatureInterpolator`, `adaptive_average_pool` / `DepthEncoder`,
`rotate_positions_for_pose`, `tensegrity_loss`,
`fibonacci_spiral_positions`), plus the layers every
model of the port uses to run in a compute dtype with float32 parameters,
as the Flax modules do with `dtype=bfloat16` (`Conv2d` lives in core/ops.py,
below the physics package, which uses it too).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fresnel_tpu_torch.core.ops import Conv2d, resize_linear


class Linear(nn.Linear):
    """nn.Linear whose float32 parameters are cast to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


def _f32(p: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if p is None else p.float()


class LayerNorm(nn.LayerNorm):
    """Flax-style LayerNorm: epsilon 1e-6 (torch's default is 1e-5),
    statistics in float32, the scale and bias (bf16 under `use_amp`)
    applied in float32, the output rounded once to the input's dtype, as
    Flax's `_normalize` does."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__(dim, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape,
                            _f32(self.weight), _f32(self.bias),
                            self.eps).to(x.dtype)


def dropout(x: torch.Tensor, rate: float, deterministic: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Flax's Dropout: in training (deterministic False) each element is
    kept with probability 1 - rate and scaled by 1 / (1 - rate); the mask
    is drawn from `generator` (the device's default one if None)."""
    if deterministic or rate <= 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class MLP(nn.Module):
    """ReLU stack with dropout after each hidden layer (active only when
    called with deterministic=False)."""

    def __init__(self, in_dim: int, hidden_dims: Sequence[int],
                 output_dim: int, dropout: float = 0.0):
        super().__init__()
        dims = [in_dim, *hidden_dims, output_dim]
        self.dropout = dropout
        self.layers = nn.ModuleList(
            Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for layer in self.layers[:-1]:
            x = dropout(F.relu(layer(x)), self.dropout, deterministic,
                        generator)
        return self.layers[-1](x)


def sinusoidal_encode(x: torch.Tensor, num_frequencies: int = 8
                      ) -> torch.Tensor:
    """(...,) angles -> (..., 2 * num_frequencies): [sin | cos] of the
    angle times 2^k, k < num_frequencies."""
    freqs = 2.0 ** torch.arange(num_frequencies, dtype=x.dtype,
                                device=x.device)
    xe = x[..., None] * freqs
    return torch.cat([torch.sin(xe), torch.cos(xe)], dim=-1)


class PoseEncoder(nn.Module):
    """Camera pose (elevation, azimuth), (B,) each in radians -> (B,
    embed_dim): their sinusoidal encodings, then Dense, ReLU, Dense.
    `dense0` / `dense1` are Flax's `Dense_0` / `Dense_1`."""

    def __init__(self, embed_dim: int = 64, num_frequencies: int = 8):
        super().__init__()
        self.num_frequencies = num_frequencies
        self.dense0 = Linear(4 * num_frequencies, embed_dim)
        self.dense1 = Linear(embed_dim, embed_dim)

    def forward(self, elevation: torch.Tensor,
                azimuth: torch.Tensor) -> torch.Tensor:
        enc = torch.cat([sinusoidal_encode(elevation, self.num_frequencies),
                         sinusoidal_encode(azimuth, self.num_frequencies)],
                        dim=-1)
        return self.dense1(F.relu(self.dense0(enc)))


def adaptive_average_pool(x: torch.Tensor, out_hw: Tuple[int, int]
                          ) -> torch.Tensor:
    """(B, H, W, C) -> (B, out_h, out_w, C) by jax.image.resize's linear
    resize, antialiased when shrinking: the JAX package's smooth stand-in
    for adaptive_avg_pool2d."""
    return resize_linear(x.permute(0, 3, 1, 2), *out_hw).permute(0, 2, 3, 1)


class DepthEncoder(nn.Module):
    """(B, H, W[, 1]) depth -> (B, grid, grid, out_channels): three 3x3
    SAME convolutions (32, 64, out_channels), each with a ReLU, pooled to
    the patch grid.  `conv0`..`conv2` are Flax's `Conv_0`..`Conv_2`."""

    def __init__(self, out_channels: int = 64, grid_size: int = 37):
        super().__init__()
        self.grid_size = grid_size
        self.conv0 = Conv2d(1, 32, 3, padding=1)
        self.conv1 = Conv2d(32, 64, 3, padding=1)
        self.conv2 = Conv2d(64, out_channels, 3, padding=1)

    def forward(self, depth: torch.Tensor,
                grid_size: Optional[int] = None) -> torch.Tensor:
        """`grid_size` overrides the constructor's (the decoder passes its
        feature grid's side)."""
        g = grid_size or self.grid_size
        x = (depth[..., 0] if depth.dim() == 4 else depth)[:, None]
        x = F.relu(self.conv0(x))
        x = F.relu(self.conv1(x))
        x = F.relu(self.conv2(x)).permute(0, 2, 3, 1)
        return adaptive_average_pool(x, (g, g))


class ZeroInitLinear(Linear):
    """A Linear layer whose weight and bias start at zero (Flax's
    zeros initialisers; weights.init_flax_like_ keeps them so)."""

    def reset_parameters(self) -> None:
        nn.init.zeros_(self.weight)
        nn.init.zeros_(self.bias)


def bilinear_sample(features: torch.Tensor, positions: torch.Tensor
                    ) -> torch.Tensor:
    """Bilinear sampling of a channels-last grid at normalised positions:
    features (H, W, C) with positions (N, 2), or batched (B, H, W, C) with
    (B, N, 2), each (x, y) in [0, 1] -> (N, C) or (B, N, C).  Border
    padding, pixel centres at (i + 0.5) / size (align_corners=False)."""
    H, W = features.shape[-3:-1]
    x = positions[..., 0] * W - 0.5
    y = positions[..., 1] * H - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = (x - x0)[..., None], (y - y0)[..., None]
    if features.dim() == 4:
        b = torch.arange(features.shape[0], device=features.device)[:, None]
    else:
        b = None

    def at(yi, xi):
        yi = torch.clamp(yi.to(torch.int64), 0, H - 1)
        xi = torch.clamp(xi.to(torch.int64), 0, W - 1)
        return features[yi, xi] if b is None else features[b, yi, xi]

    top = at(y0, x0) * (1 - wx) + at(y0, x0 + 1) * wx
    bot = at(y0 + 1, x0) * (1 - wx) + at(y0 + 1, x0 + 1) * wx
    return top * (1 - wy) + bot * wy


class FeatureInterpolator(nn.Module):
    """Batched bilinear feature lookup: (B, H, W, C) x (B, N, 2) ->
    (B, N, C)."""

    def forward(self, features: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
        return bilinear_sample(features, positions)


def rotate_positions_for_pose(positions: torch.Tensor,
                              elevation: torch.Tensor,
                              azimuth: torch.Tensor) -> torch.Tensor:
    """Rotate a (B, ..., 3) position grid to face the camera at the given
    (B,) pose: azimuth about Y, then elevation about X."""
    shape = (-1,) + (1,) * (positions.dim() - 2)
    cos_az = torch.cos(azimuth).reshape(shape)
    sin_az = torch.sin(azimuth).reshape(shape)
    cos_el = torch.cos(elevation).reshape(shape)
    sin_el = torch.sin(elevation).reshape(shape)
    x, y, z = positions[..., 0], positions[..., 1], positions[..., 2]
    x_rot = x * cos_az + z * sin_az
    z_rot = -x * sin_az + z * cos_az
    y_rot = y * cos_el - z_rot * sin_el
    z_fin = y * sin_el + z_rot * cos_el
    return torch.stack([x_rot, y_rot, z_fin], dim=-1)


def _fma_host(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """float32 a * b + c with one rounding: the product is exact in
    float64, the float64 sum is rounded to odd (its lost bits kept as a
    sticky last bit), so rounding it to float32 rounds once."""
    p = a.astype(np.float64) * b.astype(np.float64)
    c = c.astype(np.float64)
    s = p + c
    p_big = np.abs(p) >= np.abs(c)
    big, small = np.where(p_big, p, c), np.where(p_big, c, p)
    err = small - (s - big)                           # Fast2Sum: exact
    odd = s.view(np.int64) & 1
    s = np.where((err != 0) & (odd == 0),
                 np.nextafter(s, s + np.sign(err)), s)
    return s.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _spiral_host(n_points: int) -> np.ndarray:
    """(4, n) float32 on the host: the spiral's x and y, and x + 1 and
    y + 1, rounded as the JAX package's jitted code is on XLA:CPU (jax
    0.9).  XLA turns idx / n into idx * (1 / n); its float32 cos and sin
    are the C library's cosf / sinf (glibc's, within 0.56 ulp), from
    which numpy's and torch's differ by 1 ulp at up to ~750 of 5 476
    points, where theta reaches 13 140 rad; and where a sampler adds 1 to
    the spiral in the same fusion, r * cos + 1 is one fused multiply-add.
    """
    libm = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    for fn in (libm.cosf, libm.sinf):
        fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float]
    idx = np.arange(n_points, dtype=np.float32)
    r = np.sqrt(idx * np.float32(1.0 / n_points))
    theta = idx * np.float32(math.pi * (3.0 - math.sqrt(5.0)))
    cos = np.array([libm.cosf(float(t)) for t in theta], np.float32)
    sin = np.array([libm.sinf(float(t)) for t in theta], np.float32)
    one = np.ones_like(r)
    return np.stack([r * cos, r * sin, _fma_host(r, cos, one),
                     _fma_host(r, sin, one)])


@functools.lru_cache(maxsize=None)
def spiral_table(n_points: int, device: torch.device) -> torch.Tensor:
    """`_spiral_host(n_points)` on `device`, moved there once."""
    return torch.from_numpy(_spiral_host(n_points)).to(device)


def fibonacci_spiral_positions(n_points: int, device=None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vogel golden-angle spiral: n points in [-1, 1]^2 with sqrt radial
    density (equal area per point), as (x, y) float32 tensors on `device`.
    Computed once on the host, so the card and the CPU get the same
    bits."""
    xy = spiral_table(n_points, torch.device(device or "cpu"))
    return xy[0], xy[1]


GOLDEN_RATIO = 1.618033988749895


def tensegrity_loss(positions: torch.Tensor, k_neighbors: int = 6,
                    target_spacing: float = 0.1) -> torch.Tensor:
    """Golden-ratio kNN spring-energy spacing regulariser over (B, N, 3):
    the k smallest pairwise distances of each point (itself pushed out by
    +1e6 on the diagonal) against target_spacing * phi^(i / 2)."""
    diff = positions[:, :, None, :] - positions[:, None, :, :]
    # sqrt(x + eps) keeps the self-distance diagonal's gradient finite.
    d = torch.sqrt((diff * diff).sum(-1) + 1e-12)
    n = positions.shape[1]
    d = d + torch.eye(n, dtype=d.dtype, device=d.device)[None] * 1e6
    knn = -torch.topk(-d, k_neighbors, dim=-1).values
    ideal = target_spacing * GOLDEN_RATIO ** (
        torch.arange(k_neighbors, dtype=torch.float32,
                     device=d.device) * 0.5)
    return ((knn - ideal) ** 2).mean()
