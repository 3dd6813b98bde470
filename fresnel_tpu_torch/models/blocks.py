"""Shared model building blocks.

Counterpart of fresnel_tpu/models/blocks.py (MLP only), plus the layers
every model of the port uses to run in a compute dtype with float32
parameters, as the Flax modules do with `dtype=bfloat16`.
"""

from __future__ import annotations

from typing import Sequence

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


class MLP(nn.Module):
    """ReLU stack.  Dropout is inactive at inference and not ported."""

    def __init__(self, in_dim: int, hidden_dims: Sequence[int],
                 output_dim: int):
        super().__init__()
        dims = [in_dim, *hidden_dims, output_dim]
        self.layers = nn.ModuleList(
            Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers[:-1]:
            x = F.relu(layer(x))
        return self.layers[-1](x)
