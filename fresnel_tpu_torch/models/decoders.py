"""DirectPatchDecoder: per-patch MLP from the DINOv2 grid to Gaussians.

Counterpart of fresnel_tpu/models/decoders.py at the configuration the
image->3DGS path runs: K Gaussians per patch x 16 outputs, base grid in
[-1, 1], XY offsets scaled 0.25, Z locked to depth (depth_offset + depth *
depth_z_scale), scales softplus(raw + 1) * 0.15 clamped, 6D rotations,
sigmoid colors and opacities, dropout 0.1 in the MLP in training (called
with deterministic=False), and the grid rotated to face a given (elevation,
azimuth) pose as the multi-pose trainer asks.  The Fresnel-zone,
edge-aware, phase-output, pose-encoding, depth-fusion, feature-upsample and
z-offset options raise NotImplementedError.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from fresnel_tpu_torch.core.gaussians import rotation_6d_to_quaternion
from fresnel_tpu_torch.models.blocks import MLP, rotate_positions_for_pose

OUTPUTS_PER_GAUSSIAN = 16


def _resize_depth_to_grid(depth: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, H, W[, 1]) -> (B, h, w) bilinear without antialiasing, as the
    JAX package's resize with antialias=False."""
    if depth.dim() == 4:
        depth = depth[..., 0]
    return F.interpolate(depth[:, None], size=(h, w), mode="bilinear",
                         align_corners=False, antialias=False)[:, 0]


def head_transform(raw: torch.Tensor, depth: Optional[torch.Tensor],
                   depth_offset: torch.Tensor, *, scale_bias: float = 0.0,
                   opacity_bias: float = 0.0, depth_z_scale: float = -2.0,
                   elevation: Optional[torch.Tensor] = None,
                   azimuth: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
    """Raw per-patch head outputs (B, H, W, K, 16) -> Gaussian parameters;
    with a (B,) elevation and azimuth the positions are rotated to face
    that pose."""
    B, H, W, K = raw.shape[:4]
    raw_pos = raw[..., 0:3]
    raw_scale = raw[..., 3:6]
    rot_6d = raw[..., 6:12]
    raw_color = raw[..., 12:15]
    raw_opacity = raw[..., 15]

    lin_y = torch.linspace(-1.0, 1.0, H, device=raw.device)
    lin_x = torch.linspace(-1.0, 1.0, W, device=raw.device)
    y_grid, x_grid = torch.meshgrid(lin_y, lin_x, indexing="ij")
    base_x = x_grid[None, :, :, None].expand(B, H, W, K)
    base_y = y_grid[None, :, :, None].expand(B, H, W, K)

    if depth is not None:
        depth_grid = _resize_depth_to_grid(depth, H, W)            # (B, H, W)
        base_z = depth_offset + depth_grid[..., None] * depth_z_scale
        base_z = base_z.expand(B, H, W, K)
    else:
        base_z = depth_offset.expand(B, H, W, K)

    positions = torch.stack([base_x + raw_pos[..., 0] * 0.25,
                             base_y + raw_pos[..., 1] * 0.25,
                             base_z], dim=-1)
    if elevation is not None and azimuth is not None:
        positions = rotate_positions_for_pose(positions, elevation, azimuth)
    scales = F.softplus(torch.clamp(raw_scale, -10.0, 20.0) + 1.0
                        + scale_bias) * 0.15
    scales = torch.clamp(scales, 1e-6, 2.0)
    rotations = rotation_6d_to_quaternion(rot_6d)
    colors = torch.sigmoid(raw_color)
    opacities = torch.sigmoid(raw_opacity + opacity_bias)

    N = H * W * K
    return {
        "positions": positions.reshape(B, N, 3),
        "scales": scales.reshape(B, N, 3),
        "rotations": rotations.reshape(B, N, 4),
        "colors": colors.reshape(B, N, 3),
        "opacities": opacities.reshape(B, N),
    }


class DirectPatchDecoder(nn.Module):
    """features (B, H, W, C) [+ depth (B, Hd, Wd)] -> H * W * K Gaussians."""

    def __init__(self, feature_dim: int = 384, gaussians_per_patch: int = 8,
                 hidden_dims: Sequence[int] = (512, 512, 256, 128),
                 scale_bias: float = 0.0, opacity_bias: float = 0.0,
                 depth_z_scale: float = -2.0, *, dropout: float = 0.1,
                 use_fresnel_zones: bool = False,
                 use_edge_aware: bool = False,
                 use_phase_output: bool = False,
                 use_pose_encoding: bool = False,
                 use_depth_fusion: bool = False,
                 feature_upsample: int = 1,
                 z_offset_scale: float = 0.0):
        super().__init__()
        unported = dict(use_fresnel_zones=use_fresnel_zones,
                        use_edge_aware=use_edge_aware,
                        use_phase_output=use_phase_output,
                        use_pose_encoding=use_pose_encoding,
                        use_depth_fusion=use_depth_fusion,
                        feature_upsample=feature_upsample != 1,
                        z_offset_scale=z_offset_scale != 0.0)
        on = [k for k, v in unported.items() if v]
        if on:
            raise NotImplementedError(
                f"DirectPatchDecoder options not ported: {on}")
        self.gaussians_per_patch = gaussians_per_patch
        self.scale_bias = scale_bias
        self.opacity_bias = opacity_bias
        self.depth_z_scale = depth_z_scale
        self.mlp = MLP(feature_dim, hidden_dims,
                       gaussians_per_patch * OUTPUTS_PER_GAUSSIAN, dropout)
        self.depth_offset = nn.Parameter(torch.tensor(-2.0))

    def forward(self, features: torch.Tensor,
                depth: Optional[torch.Tensor] = None,
                num_gaussians: Optional[int] = None,
                elevation: Optional[torch.Tensor] = None,
                azimuth: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """Dropout is active only with deterministic=False (the masks
        drawn from `generator`); a (B,) elevation and azimuth rotate the
        grid to face that pose."""
        B, H, W, C = features.shape
        full_K = self.gaussians_per_patch
        K = min(num_gaussians, full_K) if num_gaussians is not None else full_K
        out = self.mlp(features.reshape(B * H * W, C), deterministic,
                       generator)
        out = out.reshape(B, H, W, full_K, OUTPUTS_PER_GAUSSIAN)[:, :, :, :K]
        return head_transform(out, depth, self.depth_offset,
                              scale_bias=self.scale_bias,
                              opacity_bias=self.opacity_bias,
                              depth_z_scale=self.depth_z_scale,
                              elevation=elevation, azimuth=azimuth)
