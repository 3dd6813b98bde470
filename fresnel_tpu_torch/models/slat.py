"""Fresnel v2 sparse-voxel decoders (TRELLIS distillation students).

Counterpart of fresnel_tpu/models/slat.py:
  * `PositionalEncoding3D`: learned per-axis embeddings over a 64^3 grid;
  * `DirectSLatDecoder`: DINOv2 context cross-attention, 3D-encoded voxel
    queries, pre-norm `SparseTransformerBlock`s, `GaussianHead` (8
    Gaussians per voxel, a learned position-offset scale and scale factor)
    and `OccupancyHead`; with `apply_occupancy_mask` the full static-shape
    Gaussian set plus boolean masks;
  * `MLPSLatDecoder`: the per-voxel MLP baseline;
  * `DirectStructurePredictor`: image features -> a dense occupancy grid
    (2D convolutions, a linear resize of the two patch axes, 3D
    convolutions), and `occupancy_to_coords`, its top voxels as coords.

Every submodule carries the name Flax gives it (`block_0.SelfAttention_0.
qkv`, `gaussian_head.Dense_2`, `OccupancyHead_0`, ...), so the state dict's
keys are the Flax parameter paths with "." and `weights.slat_params` only
changes layouts.

What the Flax modules do and PyTorch's defaults do not:
* `nn.gelu` is the tanh approximation;
* LayerNorm and GroupNorm use epsilon 1e-6, statistics in float32;
* `dtype` (bfloat16 under `use_amp`) is the transformer stack's compute
  dtype: its Dense layers cast input and parameters to it, its norms
  compute in float32 and round to it, the attention's products and
  softmax run on scores of that dtype (written out, not
  `scaled_dot_product_attention`, so the roundings follow JAX's), the
  self-attention mask is an additive -1e9 cast to the scores' dtype, and
  the residual stream, the final norm and both heads stay float32;
* dropout draws its keep masks from an explicit `torch.Generator`, before
  each block, and `use_checkpoint` (torch.utils.checkpoint) hands the
  block its masks and its parameter tensors, so the recompute uses the
  same masks and weights (also under the trainer's `functional_call`);
* `occupancy_to_coords` breaks ties toward the lower flat index, as
  `lax.top_k` does (a stable descending sort, not `torch.topk`).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from fresnel_tpu_torch.core.ops import Conv2d, resize_linear
from fresnel_tpu_torch.models.blocks import LayerNorm
from fresnel_tpu_torch.models.cvs import Dense
from fresnel_tpu_torch.models.image_encoder import GroupNorm, gelu


class SmallInitDense(Dense):
    """A Dense layer whose kernel Flax initialises normal(0.01) and bias
    zero (the heads' output layers; `weights.init_flax_like_`)."""

    init_std = 0.01


class Conv3d(nn.Conv3d):
    """Flax `nn.Conv` over (D, H, W) with "SAME" padding at stride 1, on
    NCDHW, its float32 parameters cast to the input's dtype."""

    def __init__(self, in_ch: int, out_ch: int, k: int):
        super().__init__(in_ch, out_ch, k, padding=k // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), b)


class PositionalEncoding3D(nn.Module):
    """coords (..., 4) [batch_idx, x, y, z] -> (..., d_model): an embedding
    per axis (d_model // 3, d_model // 3, the rest) of the clipped index."""

    def __init__(self, d_model: int, max_resolution: int = 64):
        super().__init__()
        self.max_resolution = max_resolution
        third = d_model // 3
        for axis, d in zip("xyz", (third, third, d_model - 2 * third)):
            self.add_module(f"pos_embed_{axis}",
                            nn.Embedding(max_resolution, d))

    def forward(self, coords: torch.Tensor) -> torch.Tensor:
        outs = []
        for axis, name in zip((1, 2, 3), "xyz"):
            idx = torch.clamp(coords[..., axis].long(), 0,
                              self.max_resolution - 1)
            outs.append(getattr(self, f"pos_embed_{name}")(idx))
        return torch.cat(outs, dim=-1)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, N, h, d), k / v (B, M, h, d) -> (B, N, h * d): scores times
    d^-0.5 (and + bias) in the inputs' dtype, softmax over M."""
    B, N, h, d = q.shape
    attn = torch.einsum("bnhd,bmhd->bhnm", q, k) * (d ** -0.5)
    if bias is not None:
        attn = attn + bias
    attn = torch.softmax(attn, dim=-1)
    return torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(B, N, h * d)


class CrossAttention(nn.Module):
    """Voxel queries attend to the image-feature context; the output is
    zeroed at masked voxels."""

    def __init__(self, dim: int, num_heads: int = 8,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_heads = num_heads
        self.q = Dense(dim, dim, dtype=dtype)
        self.kv = Dense(dim, 2 * dim, dtype=dtype)
        self.proj = Dense(dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, N, D = x.shape
        h = self.num_heads
        q = self.q(x).reshape(B, N, h, D // h)
        kv = self.kv(context).reshape(B, context.shape[1], 2, h, D // h)
        out = self.proj(_attend(q, kv[:, :, 0], kv[:, :, 1]))
        if mask is not None:
            out = out * mask[..., None]
        return out


class SelfAttention(nn.Module):
    """Voxel self-attention; masked keys get an additive -1e9 in the
    scores' dtype (masked queries still produce outputs)."""

    def __init__(self, dim: int, num_heads: int = 8,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Dense(dim, 3 * dim, dtype=dtype)
        self.proj = Dense(dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, N, D = x.shape
        h = self.num_heads
        qkv = self.qkv(x).reshape(B, N, 3, h, D // h)
        bias = None
        if mask is not None:
            bias = torch.where(mask[:, None, None, :].bool(), 0.0, -1e9).to(
                qkv.dtype)
        return self.proj(_attend(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                                 bias))


class SparseTransformerBlock(nn.Module):
    """Pre-norm block: self-attention, cross-attention, a GELU MLP (ratio
    4) with dropout; the norms round to the compute dtype, the residual
    stream keeps the caller's."""

    def __init__(self, dim: int, num_heads: int = 8, mlp_ratio: float = 4.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = torch.float32 if dtype is None else dtype
        self.SelfAttention_0 = SelfAttention(dim, num_heads, dtype)
        self.LayerNorm_0 = LayerNorm(dim)
        self.CrossAttention_0 = CrossAttention(dim, num_heads, dtype)
        self.LayerNorm_1 = LayerNorm(dim)
        self.LayerNorm_2 = LayerNorm(dim)
        hidden = int(dim * mlp_ratio)
        self.Dense_0 = Dense(dim, hidden, dtype=dtype)
        self.Dense_1 = Dense(hidden, dim, dtype=dtype)

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                keep: Optional[torch.Tensor] = None,
                rate: float = 0.0) -> torch.Tensor:
        """`keep`: dropout's keep mask (shape of x), or None for none."""
        dt = self.compute_dtype
        x = x + self.SelfAttention_0(self.LayerNorm_0(x).to(dt), mask)
        x = x + self.CrossAttention_0(self.LayerNorm_1(x).to(dt), context,
                                      mask)
        h = self.Dense_1(gelu(self.Dense_0(self.LayerNorm_2(x).to(dt))))
        if keep is not None:
            h = torch.where(keep, h / (1.0 - rate), torch.zeros_like(h))
        return x + h


class OccupancyHead(nn.Module):
    """(..., in_dim) -> (...) occupancy logits."""

    def __init__(self, in_dim: int, hidden_dim: int = 512):
        super().__init__()
        self.Dense_0 = Dense(in_dim, hidden_dim // 2)
        self.Dense_1 = SmallInitDense(hidden_dim // 2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_1(F.relu(self.Dense_0(x)))[..., 0]


class GaussianHead(nn.Module):
    """Voxel features (B, N, in_dim) and coords -> (B, N * G, 14) Gaussians:
    positions within `position_offset_scale` of the voxel centre (in
    [-1, 1]), softplus scales times |scale_factor|, unit quaternions,
    sigmoid colours and opacity."""

    def __init__(self, in_dim: int, hidden_dim: int = 256,
                 num_gaussians_per_voxel: int = 8,
                 init_offset_scale: float = 0.5, grid_resolution: int = 64):
        super().__init__()
        self.G = num_gaussians_per_voxel
        self.init_offset_scale = init_offset_scale
        self.grid_resolution = grid_resolution
        self.Dense_0 = Dense(in_dim, hidden_dim)
        self.Dense_1 = Dense(hidden_dim, hidden_dim)
        self.Dense_2 = SmallInitDense(hidden_dim, self.G * 14)
        self.position_offset_scale = nn.Parameter(
            torch.tensor(init_offset_scale, dtype=torch.float32))
        self.scale_factor = nn.Parameter(torch.tensor(0.01,
                                                      dtype=torch.float32))

    def forward(self, x: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
        B, N, _ = x.shape
        h = gelu(self.Dense_1(gelu(self.Dense_0(x))))
        raw = torch.clamp(self.Dense_2(h), -10.0, 10.0).reshape(
            B, N, self.G, 14)
        R = self.grid_resolution
        centers = torch.clamp(coords[..., 1:4].to(torch.float32), 0, R - 1)
        centers = (centers / R * 2.0 - 1.0)[:, :, None, :]
        pos = torch.clamp(centers + torch.tanh(raw[..., :3])
                          * self.position_offset_scale, -1.0, 1.0)
        scale = torch.clamp(F.softplus(raw[..., 3:6])
                            * torch.abs(self.scale_factor), 1e-4, 1.0)
        quat = raw[..., 6:10]
        quat = quat / torch.clamp(
            torch.sqrt((quat * quat).sum(-1, keepdim=True)), min=1e-6)
        color = torch.sigmoid(raw[..., 10:13])
        opacity = torch.sigmoid(raw[..., 13:14])
        g = torch.cat([pos, scale, quat, color, opacity], dim=-1)
        return g.reshape(B, N * self.G, 14)


def _block_call(block: nn.Module, names, x, context, mask, keep, rate,
                *tensors) -> torch.Tensor:
    """`block(x, context, mask, keep, rate)` on the parameter `tensors`
    (named `names`): torch.utils.checkpoint's recompute runs it after the
    caller's own `functional_call` has restored the module's parameters,
    so the tensors the forward used are handed to it explicitly."""
    return functional_call(block, dict(zip(names, tensors)),
                           (x, context, mask, keep, rate))


class DirectSLatDecoder(nn.Module):
    """Sparse transformer from DINOv2 features (B, P, feature_dim) and voxel
    coords (B, N, 4) to {"gaussians" (B, N * G, 14), "occupancy_logits"
    (B, N)}, plus with `apply_occupancy_mask` "occupancy_mask" (B, N),
    "gaussian_mask" (B, N * G) and "n_gaussians" (B,).  `dtype`: the
    stack's compute dtype (None: float32)."""

    def __init__(self, feature_dim: int = 1024, hidden_dim: int = 512,
                 num_layers: int = 6, num_heads: int = 8,
                 num_gaussians_per_voxel: int = 8, max_resolution: int = 64,
                 dropout: float = 0.1, use_checkpoint: bool = False,
                 predict_occupancy: bool = True,
                 occupancy_threshold: float = 0.5,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_layers = num_layers
        self.num_gaussians_per_voxel = num_gaussians_per_voxel
        self.max_resolution = max_resolution
        self.dropout = dropout
        self.use_checkpoint = use_checkpoint
        self.predict_occupancy = predict_occupancy
        self.occupancy_threshold = occupancy_threshold
        self.feature_proj = Dense(feature_dim, hidden_dim, dtype=dtype)
        self.PositionalEncoding3D_0 = PositionalEncoding3D(hidden_dim,
                                                           max_resolution)
        self.voxel_embed = nn.Parameter(torch.zeros(1, 1, hidden_dim))
        for i in range(num_layers):
            self.add_module(f"block_{i}", SparseTransformerBlock(
                hidden_dim, num_heads, dtype=dtype))
        self.LayerNorm_0 = LayerNorm(hidden_dim)
        self.gaussian_head = GaussianHead(
            hidden_dim, hidden_dim, num_gaussians_per_voxel,
            grid_resolution=max_resolution)
        if predict_occupancy:
            self.OccupancyHead_0 = OccupancyHead(hidden_dim, hidden_dim)

    def forward(self, features: torch.Tensor, coords: torch.Tensor,
                coord_mask: Optional[torch.Tensor] = None,
                apply_occupancy_mask: bool = False,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """`generator` draws dropout's keep masks (deterministic False);
        None takes the device's default generator."""
        features = torch.nan_to_num(features, nan=0.0, posinf=1.0,
                                    neginf=-1.0)
        coords = torch.cat([coords[..., :1], torch.clamp(
            coords[..., 1:4], 0, self.max_resolution - 1)], dim=-1)
        context = self.feature_proj(features)
        x = self.voxel_embed + self.PositionalEncoding3D_0(coords)
        rate = self.dropout
        for i in range(self.num_layers):
            block = getattr(self, f"block_{i}")
            keep = None
            if not deterministic and rate > 0.0:
                keep = torch.rand(x.shape, generator=generator,
                                  device=x.device) >= rate
            if self.use_checkpoint and torch.is_grad_enabled():
                names, tensors = zip(*block.named_parameters())
                x = checkpoint(_block_call, block, names, x, context,
                               coord_mask, keep, rate, *tensors,
                               use_reentrant=False)
            else:
                x = block(x, context, coord_mask, keep, rate)
        # Final norm and heads in float32.
        x = self.LayerNorm_0(x.to(torch.float32))
        result = {"gaussians": self.gaussian_head(x, coords)}
        if self.predict_occupancy:
            logits = self.OccupancyHead_0(x)
            result["occupancy_logits"] = logits
            if apply_occupancy_mask:
                occ = torch.sigmoid(logits) > self.occupancy_threshold
                if coord_mask is not None:
                    occ = occ & coord_mask.bool()
                result["occupancy_mask"] = occ
                g_mask = torch.repeat_interleave(
                    occ, self.num_gaussians_per_voxel, dim=1)
                result["gaussian_mask"] = g_mask
                result["n_gaussians"] = g_mask.sum(dim=1)
        return result


class MLPSLatDecoder(nn.Module):
    """Per-voxel MLP baseline: positional encoding plus the projected mean
    image feature, two GELU layers, then the same heads."""

    def __init__(self, feature_dim: int = 1024, hidden_dim: int = 512,
                 num_gaussians_per_voxel: int = 8, max_resolution: int = 64):
        super().__init__()
        self.Dense_0 = Dense(feature_dim, hidden_dim)
        self.PositionalEncoding3D_0 = PositionalEncoding3D(hidden_dim,
                                                           max_resolution)
        self.Dense_1 = Dense(hidden_dim, hidden_dim)
        self.Dense_2 = Dense(hidden_dim, hidden_dim)
        self.GaussianHead_0 = GaussianHead(
            hidden_dim, hidden_dim, num_gaussians_per_voxel,
            grid_resolution=max_resolution)
        self.OccupancyHead_0 = OccupancyHead(hidden_dim, hidden_dim)

    def forward(self, features: torch.Tensor, coords: torch.Tensor,
                coord_mask: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """`coord_mask`, `deterministic` and `generator` are accepted for
        the transformer's signature and unused."""
        pooled = self.Dense_0(features.mean(dim=1))
        x = self.PositionalEncoding3D_0(coords) + pooled[:, None, :]
        x = gelu(self.Dense_2(gelu(self.Dense_1(x))))
        return {"gaussians": self.GaussianHead_0(x, coords),
                "occupancy_logits": self.OccupancyHead_0(x)}


class DirectStructurePredictor(nn.Module):
    """Image features (B, P, feature_dim), P a square, -> (occupancy probs,
    logits), each (B, D, D, D) with D = `resolution`."""

    def __init__(self, feature_dim: int = 1024, hidden_dim: int = 256,
                 resolution: int = 64, threshold: float = 0.5):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.resolution = resolution
        self.threshold = threshold
        D, dch = resolution, hidden_dim // 4
        self.Dense_0 = Dense(feature_dim, hidden_dim)
        self.Conv_0 = Conv2d(hidden_dim, hidden_dim, 3, padding=1)
        self.GroupNorm_0 = GroupNorm(8, hidden_dim)
        self.Conv_1 = Conv2d(hidden_dim, dch * D, 1)
        self.Conv_2 = Conv3d(dch, hidden_dim, 3)
        self.GroupNorm_1 = GroupNorm(8, hidden_dim)
        self.Conv_3 = Conv3d(hidden_dim, hidden_dim // 2, 3)
        self.GroupNorm_2 = GroupNorm(8, hidden_dim // 2)
        self.Conv_4 = Conv3d(hidden_dim // 2, 1, 1)

    def forward(self, features: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        B, P, _ = features.shape
        side = int(round(P ** 0.5))
        D, dch = self.resolution, self.hidden_dim // 4
        x = gelu(self.Dense_0(features))
        x = x.reshape(B, side, side, -1).permute(0, 3, 1, 2)     # NCHW
        x = gelu(self.GroupNorm_0(self.Conv_0(x)))
        x = self.Conv_1(x)                          # (B, D * dch, s, s)
        # Flax's (B, s, s, D, dch) -> (B, D, s, s, dch), here NCDHW: the
        # channel index is d * dch + c.
        x = x.reshape(B, D, dch, side, side).permute(0, 2, 1, 3, 4)
        # jax.image.resize(..., "trilinear") changes only the two patch
        # axes: a linear resize with half-pixel centres on those.
        x = resize_linear(x, D, D)
        x = gelu(self.GroupNorm_1(self.Conv_2(x)))
        x = gelu(self.GroupNorm_2(self.Conv_3(x)))
        logits = self.Conv_4(x)[:, 0]                           # (B, D, D, D)
        return torch.sigmoid(logits), logits


def occupancy_to_coords(occupancy: torch.Tensor, max_coords: int,
                        threshold: float = 0.5
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A dense (D, D, D) occupancy -> (max_coords, 4) int32 [0, x, y, z]
    coords of its largest values (ties to the lower flat index) and their
    validity (value > threshold)."""
    D = occupancy.shape[-1]
    vals, idx = torch.sort(occupancy.reshape(-1), descending=True,
                           stable=True)
    vals, idx = vals[:max_coords], idx[:max_coords]
    x = idx // (D * D)
    y = (idx // D) % D
    z = idx % D
    coords = torch.stack([torch.zeros_like(x), x, y, z], dim=-1)
    return coords.to(torch.int32), vals > threshold
