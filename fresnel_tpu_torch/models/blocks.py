"""Shared model building blocks.

Counterpart of fresnel_tpu/models/blocks.py (`MLP` with dropout,
`rotate_positions_for_pose`, `tensegrity_loss`), plus the layers every
model of the port uses to run in a compute dtype with float32 parameters,
as the Flax modules do with `dtype=bfloat16`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


class Linear(nn.Linear):
    """nn.Linear whose float32 parameters are cast to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class Conv2d(nn.Conv2d):
    """nn.Conv2d (NCHW) whose float32 parameters are cast to the input's
    dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), b)


class LayerNorm(nn.LayerNorm):
    """Flax-style LayerNorm: epsilon 1e-6 (torch's default is 1e-5),
    statistics in float32, output in the input's dtype."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__(dim, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(x.dtype)


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
