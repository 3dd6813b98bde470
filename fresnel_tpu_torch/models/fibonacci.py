"""FibonacciPatchDecoder (experiment 4): golden-spiral Gaussian placement.

Counterpart of fresnel_tpu/models/fibonacci.py: N Vogel-spiral points
(377 by default), features and depth sampled bilinearly at the spiral
coordinates (align_corners=True, border clipping), an MLP (512, 256, 128)
per point, XY offsets scaled 0.15 around the spiral, Z locked to the depth
sampled at each point, softplus(raw + 1 + bias) * 0.15 scales, 6D
rotations and sigmoid colours and opacities.  The options: the sampled
depth snapped to Fresnel-zone centres (`use_fresnel_zones`), per-RGB
phases sigmoid * 2 pi from 19 outputs per Gaussian (`use_phase_output`)
and opacities modulated into [0.5, 1.5] by a `PoseEncoder` of the pose
(`use_pose_encoding`, a 64-wide hidden layer).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from fresnel_tpu_torch.core.gaussians import rotation_6d_to_quaternion
from fresnel_tpu_torch.models.blocks import (
    MLP, Linear, PoseEncoder, rotate_positions_for_pose, spiral_table)
from fresnel_tpu_torch.models.decoders import (
    OUTPUTS_PER_GAUSSIAN, OUTPUTS_WITH_PHASE, TWO_PI, _fma, pose_opacity)
from fresnel_tpu_torch.physics.fresnel_zones import FresnelZones


def sample_grid_at(grid: torch.Tensor, coords_m11: torch.Tensor
                   ) -> torch.Tensor:
    """Bilinear sample of (..., H, W, C) at (N, 2) coordinates in [-1, 1]
    -> (..., N, C): align_corners=True, corner indices clipped to the
    border (torch grid_sample's border padding), by gathers."""
    return _sample_p1(grid, coords_m11 + 1.0)


def _sample_p1(grid: torch.Tensor, coords_p1: torch.Tensor) -> torch.Tensor:
    """`sample_grid_at` given the coordinates plus one, (N, 2), as the
    caller rounds them.  The blend is rounded as the JAX package's jitted
    function is on XLA:CPU (jax 0.9) for a batch of two or more: each row
    the fused multiply-add of its right tap with the rounded product of
    its left one, then across the rows that of the top row with the
    rounded product of the bottom one.  For one image XLA fuses the left
    tap instead, and some samples differ by 1 ulp (the spiral of 5 476
    points over a 256^2 corpus depth: ~100 of them); one formula serves
    every batch size, so a scene's Gaussians do not depend on the batch it
    is decoded in.  Depth-locked Gaussians on a flat background sample
    equal depths, and these last bits decide which of them tie, so the
    compositing order."""
    H, W = grid.shape[-3:-1]
    x = coords_p1[:, 0] * (0.5 * (W - 1))
    y = coords_p1[:, 1] * (0.5 * (H - 1))
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = (x - x0)[:, None], (y - y0)[:, None]

    def at(yi, xi):
        yi = torch.clamp(yi.to(torch.int64), 0, H - 1)
        xi = torch.clamp(xi.to(torch.int64), 0, W - 1)
        return grid[..., yi, xi, :]

    top = _fma(at(y0, x0 + 1), wx, at(y0, x0) * (1 - wx))
    bot = _fma(at(y0 + 1, x0 + 1), wx, at(y0 + 1, x0) * (1 - wx))
    return _fma(top, 1 - wy, bot * wy)


def _spiral_samples(grid: torch.Tensor, n_points: int) -> torch.Tensor:
    """(..., H, W, C) sampled at the n-point spiral -> (..., n, C), its
    coordinates plus one rounded as XLA fuses them (models.blocks)."""
    table = spiral_table(n_points, grid.device)
    return _sample_p1(grid, table[2:].T)


def fib_head_transform(raw: torch.Tensor, depth: Optional[torch.Tensor],
                       depth_offset: torch.Tensor, *,
                       scale_bias: float = 0.0, opacity_bias: float = 0.0,
                       use_fresnel_zones: bool = False,
                       num_fresnel_zones: int = 8,
                       use_phase_output: bool = False,
                       elevation: Optional[torch.Tensor] = None,
                       azimuth: Optional[torch.Tensor] = None
                       ) -> Dict[str, torch.Tensor]:
    """Raw spiral-point head outputs (B, N, K, 16 or 19) and depth (B, H,
    W[, 1])
    -> Gaussian parameters: the spiral base, XY offsets * 0.15, Z locked
    to the depth sampled at each point (depth_offset - 2 * depth), scales
    softplus(clip(raw, -10, 20) + 1 + scale_bias) * 0.15 clamped, 6D
    rotations, sigmoid colours and opacities; with a (B,) elevation and
    azimuth the positions are rotated to face that pose.
    `use_fresnel_zones` snaps the sampled depth to its zone's centre;
    `use_phase_output` adds "phases" (B, N * K, 3), sigmoid * 2 pi of raw
    channels 16-18.  Shared by the decoder and the experiment-4 teacher
    fit."""
    B, N, K = raw.shape[:3]
    raw_pos, raw_scale = raw[..., 0:3], raw[..., 3:6]
    rot_6d, raw_color, raw_op = raw[..., 6:12], raw[..., 12:15], raw[..., 15]

    table = spiral_table(N, raw.device)
    base_x = table[0][None, :, None].expand(B, N, K)
    base_y = table[1][None, :, None].expand(B, N, K)
    if depth is not None:
        d = depth[..., 0] if depth.dim() == 4 else depth
        d_sampled = _spiral_samples(d[..., None], N)[..., 0]
        if use_fresnel_zones:
            d_sampled = FresnelZones(
                num_zones=num_fresnel_zones).zone_centers_for_depth(d_sampled)
        base_z = (depth_offset + d_sampled[..., None] * (-2.0)).expand(
            B, N, K)
    else:
        base_z = depth_offset.expand(B, N, K)

    positions = torch.stack([base_x + raw_pos[..., 0] * 0.15,
                             base_y + raw_pos[..., 1] * 0.15,
                             base_z], -1)
    if elevation is not None and azimuth is not None:
        positions = rotate_positions_for_pose(positions, elevation, azimuth)
    scales = torch.clamp(F.softplus(torch.clamp(raw_scale, -10.0, 20.0)
                                    + 1.0 + scale_bias) * 0.15, 1e-6, 2.0)
    rotations = rotation_6d_to_quaternion(rot_6d)
    colors = torch.sigmoid(raw_color)
    opacities = torch.sigmoid(raw_op + opacity_bias)

    total = N * K
    result = {
        "positions": positions.reshape(B, total, 3),
        "scales": scales.reshape(B, total, 3),
        "rotations": rotations.reshape(B, total, 4),
        "colors": colors.reshape(B, total, 3),
        "opacities": opacities.reshape(B, total),
    }
    if use_phase_output:
        result["phases"] = (torch.sigmoid(raw[..., 16:19]) * TWO_PI
                            ).reshape(B, total, 3)
    return result


class FibonacciPatchDecoder(nn.Module):
    """features (B, h, w, C) [+ depth (B, H, W)] -> n_points *
    gaussians_per_point Gaussians on the spiral."""

    def __init__(self, feature_dim: int = 384, n_points: int = 377,
                 gaussians_per_point: int = 1,
                 hidden_dims: Sequence[int] = (512, 256, 128),
                 dropout: float = 0.1, *, use_fresnel_zones: bool = False,
                 num_fresnel_zones: int = 8,
                 use_phase_output: bool = False,
                 use_pose_encoding: bool = False,
                 pose_embed_dim: int = 64,
                 scale_bias: float = 0.0, opacity_bias: float = 0.0):
        super().__init__()
        self.n_points = n_points
        self.gaussians_per_point = gaussians_per_point
        self.scale_bias = scale_bias
        self.opacity_bias = opacity_bias
        self.use_fresnel_zones = use_fresnel_zones
        self.num_fresnel_zones = num_fresnel_zones
        self.use_phase_output = use_phase_output
        self.use_pose_encoding = use_pose_encoding
        self.outputs = (OUTPUTS_WITH_PHASE if use_phase_output
                        else OUTPUTS_PER_GAUSSIAN)
        self.mlp = MLP(feature_dim, hidden_dims,
                       gaussians_per_point * self.outputs, dropout)
        self.depth_offset = nn.Parameter(torch.tensor(-2.0))
        if use_pose_encoding:
            self.pose_encoder = PoseEncoder(pose_embed_dim)
            self.opacity_hidden = Linear(pose_embed_dim, 64)
            self.opacity_out = Linear(64, 1)

    def forward(self, features: torch.Tensor,
                depth: Optional[torch.Tensor] = None,
                num_gaussians: Optional[int] = None,
                elevation: Optional[torch.Tensor] = None,
                azimuth: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                return_raw: bool = False) -> Dict[str, torch.Tensor]:
        """`num_gaussians` is accepted and ignored, as in the JAX module;
        dropout is active only with deterministic=False (masks from
        `generator`); with `return_raw` the result also holds "raw", the
        (B, N, K, 16 or 19) head outputs."""
        B = features.shape[0]
        N, K = self.n_points, self.gaussians_per_point
        sampled = _spiral_samples(features, N)
        out = self.mlp(sampled.reshape(B * N, -1), deterministic, generator)
        out = out.reshape(B, N, K, self.outputs)
        result = fib_head_transform(
            out, depth, self.depth_offset, scale_bias=self.scale_bias,
            opacity_bias=self.opacity_bias,
            use_fresnel_zones=self.use_fresnel_zones,
            num_fresnel_zones=self.num_fresnel_zones,
            use_phase_output=self.use_phase_output, elevation=elevation,
            azimuth=azimuth)
        if self.use_pose_encoding and elevation is not None \
                and azimuth is not None:
            result["opacities"] = pose_opacity(
                result["opacities"], self.pose_encoder, self.opacity_hidden,
                self.opacity_out, elevation, azimuth)
        if return_raw:
            result["raw"] = out
        return result
