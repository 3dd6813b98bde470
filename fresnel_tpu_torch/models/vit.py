"""DINOv2 ViT and Depth-Anything-V2 (DPT neck + head).

Counterpart of fresnel_tpu/models/vit.py.  Public layouts match the JAX
package: images (B, H, W, 3) in [0, 1], features (B, g, g, width), depth
(B, out, out).  Inside, convolutions run NCHW.

`dtype` is the compute dtype: parameters stay float32 and are cast at each
layer, the softmax runs in float32, and the outputs are float32, as in the
Flax modules.  LayerNorms use epsilon 1e-6 and GELU is the exact erf form.
Submodules carry the Flax modules' names, so converted weights map one to
one (see fresnel_tpu_torch/weights.py).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fresnel_tpu_torch.models.blocks import Conv2d, LayerNorm, Linear

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

VIT_CONFIGS = {
    "small": dict(width=384, depth=12, heads=6),
    "base": dict(width=768, depth=12, heads=12),
    "large": dict(width=1024, depth=24, heads=16),
}

DA_OUT_INDICES = (3, 6, 9, 12)
DA_NECK_CHANNELS = (48, 96, 192, 384)
DA_FUSION = 64
DA_HEAD_HIDDEN = 32


# ----------------------------------------------------------------------
# Resize helpers
# ----------------------------------------------------------------------

def _linear_ac_taps(in_size: int, out_size: int):
    """align_corners=True bilinear taps: (idx0, idx1, weight1) numpy arrays."""
    if out_size == 1:
        return (np.zeros(1, np.int64), np.zeros(1, np.int64),
                np.zeros(1, np.float32))
    src = np.arange(out_size, dtype=np.float64) * (in_size - 1) / (out_size - 1)
    i0 = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    i1 = np.minimum(i0 + 1, in_size - 1)
    w1 = (src - i0).astype(np.float32)
    return i0, i1, w1


def _resize_ac_axis(x: torch.Tensor, out: int, axis: int) -> torch.Tensor:
    i0, i1, w1 = _linear_ac_taps(x.shape[axis], out)
    shape = [1] * x.dim()
    shape[axis] = out
    w1 = torch.from_numpy(w1).to(device=x.device, dtype=x.dtype).reshape(shape)
    i0 = torch.from_numpy(i0).to(x.device)
    i1 = torch.from_numpy(i1).to(x.device)
    return (x.index_select(axis, i0) * (1.0 - w1)
            + x.index_select(axis, i1) * w1)


def _resize_ac(x: torch.Tensor, out_h: int, out_w: int,
               h_axis: int) -> torch.Tensor:
    if x.shape[h_axis] != out_h:
        x = _resize_ac_axis(x, out_h, h_axis)
    if x.shape[h_axis + 1] != out_w:
        x = _resize_ac_axis(x, out_w, h_axis + 1)
    return x


def resize_bilinear_ac(x: torch.Tensor, out_h: int, out_w: int
                       ) -> torch.Tensor:
    """(B, H, W, C) bilinear resize with align_corners=True, by the same
    two-tap gathers (rows, then columns) as the JAX package."""
    return _resize_ac(x, out_h, out_w, h_axis=1)


def _cubic_weights(t: np.ndarray, A: float = -0.75) -> np.ndarray:
    """Cubic-convolution weights of the 4 taps at fractional offset t
    (torch upsample_bicubic2d, A = -0.75)."""
    def w1(x):
        return ((A + 2) * x - (A + 3)) * x * x + 1

    def w2(x):
        return ((A * x - 5 * A) * x + 8 * A) * x - 4 * A
    return np.stack([w2(t + 1.0), w1(t), w1(1.0 - t), w2(2.0 - t)], -1)


def _torch_bicubic_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) matrix of torch bicubic interpolation with
    align_corners=False and border-clamped taps."""
    M = np.zeros((out_size, in_size), np.float64)
    scale = in_size / out_size
    dst = np.arange(out_size, dtype=np.float64)
    src = (dst + 0.5) * scale - 0.5
    base = np.floor(src)
    w = _cubic_weights(src - base)
    for tap in range(4):
        idx = np.clip(base + tap - 1, 0, in_size - 1).astype(np.int64)
        np.add.at(M, (np.arange(out_size), idx), w[:, tap])
    return M


def interpolate_pos_embed(pos: np.ndarray, new_grid: int) -> np.ndarray:
    """(1, old_grid^2 + 1, D) -> (1, new_grid^2 + 1, D), CLS passed through,
    by torch-exact bicubic interpolation of the patch grid."""
    pos = np.asarray(pos, np.float32)
    n = pos.shape[1] - 1
    old_grid = int(round(math.sqrt(n)))
    if old_grid * old_grid != n:
        raise ValueError(f"pos_embed token count {n} is not a square grid")
    if old_grid == new_grid:
        return pos
    cls, patch = pos[:, :1], pos[:, 1:]
    D = pos.shape[-1]
    grid = patch.reshape(old_grid, old_grid, D).astype(np.float64)
    M = _torch_bicubic_matrix(old_grid, new_grid)
    grid = np.einsum("oi,ijd->ojd", M, grid)
    grid = np.einsum("oj,ijd->iod", M, grid)
    out = np.concatenate(
        [cls, grid.reshape(1, new_grid * new_grid, D).astype(np.float32)], 1)
    return out.astype(np.float32)


# ----------------------------------------------------------------------
# DINOv2 backbone
# ----------------------------------------------------------------------

class Attention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = Linear(width, 3 * width)
        self.proj = Linear(width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, D = x.shape
        hd = D // self.heads
        qkv = self.qkv(x).reshape(B, N, 3, self.heads, hd)
        q = qkv[:, :, 0].transpose(1, 2)                      # (B, h, N, hd)
        k = qkv[:, :, 1].transpose(1, 2)
        v = qkv[:, :, 2].transpose(1, 2)
        logits = (q @ k.transpose(-1, -2)) * hd ** -0.5
        # Softmax in float32 whatever the compute dtype.
        attn = torch.softmax(logits.float(), dim=-1).to(q.dtype)
        out = (attn @ v).transpose(1, 2).reshape(B, N, D)
        return self.proj(out)


class LayerScale(nn.Module):
    def __init__(self, dim: int, init: float = 1e-5):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), init))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype)


class Block(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.norm1 = LayerNorm(width)
        self.attn = Attention(width, heads)
        self.ls1 = LayerScale(width)
        self.norm2 = LayerNorm(width)
        self.mlp_fc1 = Linear(width, 4 * width)
        self.mlp_fc2 = Linear(4 * width, width)
        self.ls2 = LayerScale(width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.ls1(self.attn(self.norm1(x)))
        h = F.gelu(self.mlp_fc1(self.norm2(x)), approximate="none")
        return x + self.ls2(self.mlp_fc2(h))


class DINOv2(nn.Module):
    """DINOv2 ViT backbone.

    forward(images) returns the (B, g, g, width) final-norm patch-token
    grid in float32.  With `out_indices` it returns the tapped token
    sequences (B, N + 1, width) after the 1-based layers named, each passed
    through the final LayerNorm with CLS kept."""

    def __init__(self, width: int = 384, depth: int = 12, heads: int = 6,
                 patch_size: int = 14, image_size: int = 518,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.width, self.depth = width, depth
        self.patch_size, self.image_size = patch_size, image_size
        self.dtype = dtype
        g = image_size // patch_size
        self.patch_embed = Conv2d(3, width, patch_size, stride=patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, width))
        self.pos_embed = nn.Parameter(torch.zeros(1, g * g + 1, width))
        self.blocks = nn.ModuleList(Block(width, heads) for _ in range(depth))
        self.norm = LayerNorm(width)
        self.register_buffer("mean", torch.from_numpy(IMAGENET_MEAN),
                             persistent=False)
        self.register_buffer("std", torch.from_numpy(IMAGENET_STD),
                             persistent=False)

    def forward(self, images: torch.Tensor,
                out_indices: Optional[Tuple[int, ...]] = None):
        B = images.shape[0]
        g = self.image_size // self.patch_size
        x = ((images - self.mean) / self.std).to(self.dtype)
        x = self.patch_embed(x.permute(0, 3, 1, 2))           # (B, W, g, g)
        x = x.flatten(2).transpose(1, 2)                      # (B, g*g, W)
        cls = self.cls_token.to(self.dtype).expand(B, 1, self.width)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(self.dtype)

        if out_indices is not None and \
                tuple(out_indices) != tuple(sorted(set(out_indices))):
            raise ValueError("out_indices must be strictly ascending")
        want = set(out_indices or ())
        taps: List[torch.Tensor] = []
        for i, block in enumerate(self.blocks):
            x = block(x)
            if (i + 1) in want:
                taps.append(self.norm(x))
        if out_indices is not None:
            return taps
        x = self.norm(x)
        return x[:, 1:].reshape(B, g, g, self.width).float()


# ----------------------------------------------------------------------
# Depth-Anything DPT neck + head (NCHW inside)
# ----------------------------------------------------------------------

class PatchUpsample(nn.Module):
    """Transpose convolution with kernel == stride == factor: a learned
    non-overlapping upsample.  `weight` has torch's ConvTranspose2d layout
    (in, out, k, k)."""

    def __init__(self, in_channels: int, channels: int, factor: int):
        super().__init__()
        self.factor = factor
        self.weight = nn.Parameter(
            torch.zeros(in_channels, channels, factor, factor))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, self.weight.to(x.dtype),
                                  self.bias.to(x.dtype), stride=self.factor)


class PreActResidual(nn.Module):
    """x + conv(relu(conv(relu(x))))."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = Conv2d(features, features, 3, padding=1)
        self.conv2 = Conv2d(features, features, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class FeatureFusion(nn.Module):
    """Optional residual merge, residual unit, align_corners=True bilinear
    upsample, 1x1 projection."""

    def __init__(self, features: int, has_residual: bool):
        super().__init__()
        if has_residual:
            self.res1 = PreActResidual(features)
        self.res2 = PreActResidual(features)
        self.proj = Conv2d(features, features, 1)

    def forward(self, x, residual=None, out_size=None):
        if residual is not None:
            x = x + self.res1(residual)
        x = self.res2(x)
        if out_size is None:
            out_size = (x.shape[2] * 2, x.shape[3] * 2)
        x = _resize_ac(x, out_size[0], out_size[1], h_axis=2)
        return self.proj(x)


class DPTNeckHead(nn.Module):
    """Reassembles the 4 tapped token sequences at strides x4 / x2 / x1 /
    x0.5 of the patch grid, fuses them coarsest to finest, and regresses
    ReLU relative depth at patch_size * grid resolution."""

    def __init__(self, in_width: int,
                 neck_channels: Sequence[int] = DA_NECK_CHANNELS,
                 fusion: int = DA_FUSION, head_hidden: int = DA_HEAD_HIDDEN,
                 patch_size: int = 14):
        super().__init__()
        self.n_levels = len(neck_channels)
        self.patch_size = patch_size
        for i, ch in enumerate(neck_channels):
            self.add_module(f"reassemble_{i}_proj", Conv2d(in_width, ch, 1))
            if i == 0:
                self.add_module(f"reassemble_{i}_resize",
                                PatchUpsample(ch, ch, 4))
            elif i == 1:
                self.add_module(f"reassemble_{i}_resize",
                                PatchUpsample(ch, ch, 2))
            elif i == 3:
                self.add_module(f"reassemble_{i}_resize",
                                Conv2d(ch, ch, 3, stride=2, padding=1))
            self.add_module(f"neck_conv_{i}",
                            Conv2d(ch, fusion, 3, padding=1, bias=False))
        for i in range(self.n_levels):
            self.add_module(f"fusion_{i}", FeatureFusion(fusion, i > 0))
        self.head_conv1 = Conv2d(fusion, fusion // 2, 3, padding=1)
        self.head_conv2 = Conv2d(fusion // 2, head_hidden, 3, padding=1)
        self.head_conv3 = Conv2d(head_hidden, 1, 1)

    def forward(self, taps: Sequence[torch.Tensor], grid: int) -> torch.Tensor:
        if len(taps) != self.n_levels:
            raise ValueError(f"expected {self.n_levels} taps, got {len(taps)}")
        feats = []
        for i, tokens in enumerate(taps):
            B, _, C = tokens.shape
            h = tokens[:, 1:].reshape(B, grid, grid, C).permute(0, 3, 1, 2)
            h = getattr(self, f"reassemble_{i}_proj")(h)
            if i != 2:
                h = getattr(self, f"reassemble_{i}_resize")(h)
            feats.append(getattr(self, f"neck_conv_{i}")(h))

        rev = feats[::-1]
        fused = None
        for i, f in enumerate(rev):
            size = tuple(rev[i + 1].shape[2:]) if i + 1 < len(rev) else None
            layer = getattr(self, f"fusion_{i}")
            fused = layer(f, None, size) if fused is None \
                else layer(fused, f, size)

        x = self.head_conv1(fused)
        out = grid * self.patch_size
        x = _resize_ac(x, out, out, h_axis=2)
        x = F.relu(self.head_conv2(x))
        x = self.head_conv3(x)
        return F.relu(x[:, 0]).float()


class DepthAnything(nn.Module):
    """DINOv2 backbone + DPT neck/head -> relative depth.

    forward(images) min-max normalises the raw head output to [0, 1] and
    resizes it to `out_size` with an antialiased bilinear resize, which is
    what jax.image.resize(..., "linear") does when it downsamples.
    `raw=True` returns the unnormalised (B, 518, 518) head output."""

    def __init__(self, width: int = 384, depth: int = 12, heads: int = 6,
                 out_size: int = 256, image_size: int = 518,
                 patch_size: int = 14,
                 out_indices: Tuple[int, ...] = DA_OUT_INDICES,
                 neck_channels: Tuple[int, ...] = DA_NECK_CHANNELS,
                 fusion: int = DA_FUSION, head_hidden: int = DA_HEAD_HIDDEN,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.out_size = out_size
        self.grid = image_size // patch_size
        self.out_indices = tuple(out_indices)
        self.backbone = DINOv2(width, depth, heads, patch_size, image_size,
                               dtype=dtype)
        self.dpt = DPTNeckHead(width, neck_channels, fusion, head_hidden,
                               patch_size)

    def forward(self, images: torch.Tensor, raw: bool = False) -> torch.Tensor:
        taps = self.backbone(images, out_indices=self.out_indices)
        depth = self.dpt(taps, self.grid)
        if raw:
            return depth
        lo = depth.amin(dim=(1, 2), keepdim=True)
        hi = depth.amax(dim=(1, 2), keepdim=True)
        rel = (depth - lo) / torch.clamp(hi - lo, min=1e-6)
        if self.out_size != rel.shape[1]:
            rel = F.interpolate(rel[:, None], size=(self.out_size,) * 2,
                                mode="bilinear", align_corners=False,
                                antialias=True)[:, 0]
        return rel
