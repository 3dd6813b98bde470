"""Trainable image encoder, trained end to end with the decoder.

Counterpart of fresnel_tpu/models/image_encoder.py::ImageEncoder: (B, 3,
H, W) images in [0, 1] -> (B, grid, grid, feature_dim) NHWC features, the
DINOv2 grid contract, so the decoder downstream is unchanged.  The image is
resized to 8 x grid (296 for the 37 grid) and mapped to [-1, 1]; three
stride-2 convolutions with pre-norm residual blocks land on the grid; a
dense projection, a learned positional embedding and two pre-norm
transformer blocks over the grid's tokens (or, with attn_pool > 1, over an
average-pooled token grid whose context is resized back and added); a
final LayerNorm.

What the Flax modules do and PyTorch's defaults do not:
* "SAME" padding at stride 2 is asymmetric (5x5 on 296 pads (1, 2), 3x3
  on 148 and 74 pads (0, 1)), so each convolution pads with `F.pad` first;
* `nn.gelu` is the tanh approximation;
* GroupNorm and LayerNorm use epsilon 1e-6;
* attention: (C, heads, head_dim) query / key / value kernels (here
  Linear(C, C)), the query divided by sqrt(head_dim), a float32 softmax,
  and the largest head count <= 6 that divides `feature_dim`.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fresnel_tpu_torch.models.blocks import Conv2d, LayerNorm, Linear, _f32
from fresnel_tpu_torch.models.encoders import resize_linear


def same_padding(size: int, k: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of one axis under XLA's "SAME" rule."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class SameConv2d(Conv2d):
    """Conv2d (NCHW) with XLA's "SAME" padding, asymmetric where the total
    is odd."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (kh, kw), (sh, sw) = self.kernel_size, self.stride
        ph = same_padding(x.shape[-2], kh, sh)
        pw = same_padding(x.shape[-1], kw, sw)
        return super().forward(F.pad(x, (*pw, *ph)))


class GroupNorm(nn.GroupNorm):
    """Flax-style GroupNorm: epsilon 1e-6, statistics in float32, the
    scale and bias (bf16 under `use_amp`) applied in float32, the output
    rounded once to the input's dtype."""

    def __init__(self, groups: int, channels: int):
        super().__init__(groups, channels, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, _f32(self.weight),
                            _f32(self.bias), self.eps).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Flax's default nn.gelu: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class ResBlock(nn.Module):
    """Pre-norm 3x3 conv residual block (NCHW)."""

    def __init__(self, width: int):
        super().__init__()
        self.norm1 = GroupNorm(min(32, width), width)
        self.conv1 = SameConv2d(width, width, 3)
        self.norm2 = GroupNorm(min(32, width), width)
        self.conv2 = SameConv2d(width, width, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(gelu(self.norm1(x)))
        h = self.conv2(gelu(self.norm2(h)))
        return x + h


def attention_heads(dim: int, heads: int = 6) -> int:
    """The largest head count <= `heads` that divides `dim`."""
    while dim % heads:
        heads -= 1
    return heads


class Attention(nn.Module):
    """Flax's MultiHeadDotProductAttention (self-attention)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q = Linear(dim, dim)
        self.k = Linear(dim, dim)
        self.v = Linear(dim, dim)
        self.out = Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, L, C = x.shape
        h, d = self.heads, C // self.heads

        def split(t):
            return t.reshape(B, L, h, d).transpose(1, 2)      # (B, h, L, d)

        q = split(self.q(x)) / math.sqrt(d)
        k, v = split(self.k(x)), split(self.v(x))
        w = torch.softmax((q @ k.transpose(-1, -2)).float(), dim=-1)
        o = (w.to(v.dtype) @ v).transpose(1, 2).reshape(B, L, C)
        return self.out(o)


class AttnBlock(nn.Module):
    """Pre-norm transformer block over the flattened grid."""

    def __init__(self, dim: int, heads: int = 6):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, attention_heads(dim, heads))
        self.norm2 = LayerNorm(dim)
        self.fc1 = Linear(dim, dim * 4)
        self.fc2 = Linear(dim * 4, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.fc2(gelu(self.fc1(self.norm2(x))))


class ImageEncoder(nn.Module):
    """(B, 3, H, W) image in [0, 1] -> (B, grid, grid, feature_dim) NHWC."""

    def __init__(self, feature_dim: int = 384, grid: int = 37,
                 width: int = 64, n_attn_blocks: int = 2, attn_pool: int = 1):
        super().__init__()
        w = width
        self.feature_dim, self.grid, self.attn_pool = feature_dim, grid, attn_pool
        self.conv1 = SameConv2d(3, w, 5, stride=2)            # 296 -> 148
        self.conv2 = SameConv2d(w, 2 * w, 3, stride=2)        # 148 -> 74
        self.conv3 = SameConv2d(2 * w, 4 * w, 3, stride=2)    # 74 -> 37
        self.res = nn.ModuleList([ResBlock(w), ResBlock(2 * w),
                                  ResBlock(2 * w), ResBlock(4 * w),
                                  ResBlock(4 * w)])
        self.proj = Linear(4 * w, feature_dim)
        self.pos_embed = nn.Parameter(
            torch.zeros(1, grid, grid, feature_dim))
        self.blocks = nn.ModuleList(AttnBlock(feature_dim)
                                    for _ in range(n_attn_blocks))
        if attn_pool > 1:
            self.pool_norm = LayerNorm(feature_dim)
        self.norm = LayerNorm(feature_dim)

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        B = image.shape[0]
        g, C = self.grid, self.feature_dim
        side = g * 8
        x = resize_linear(image, side, side) * 2.0 - 1.0
        x = self.res[0](self.conv1(x))
        x = self.res[2](self.res[1](self.conv2(x)))
        x = self.res[4](self.res[3](self.conv3(x)))
        x = self.proj(x.permute(0, 2, 3, 1)) + self.pos_embed   # (B, g, g, C)
        if self.attn_pool > 1:
            p = self.attn_pool
            g2 = g // p
            t = F.avg_pool2d(x.permute(0, 3, 1, 2), p, p)        # (B, C, g2, g2)
            tok = t.flatten(2).transpose(1, 2)                 # (B, g2^2, C)
            for blk in self.blocks:
                tok = blk(tok)
            tok = self.pool_norm(tok).transpose(1, 2).reshape(B, C, g2, g2)
            ctx = resize_linear(tok, g, g).permute(0, 2, 3, 1)
            return self.norm(x + ctx)
        tokens = x.reshape(B, g * g, C)
        for blk in self.blocks:
            tokens = blk(tokens)
        return self.norm(tokens).reshape(B, g, g, C)
