"""SAAGRefinementNet (experiment 1) and FeatureGuidedSAAG (experiment 3).

Counterpart of fresnel_tpu/models/saag_refine.py; the submodules and
parameters carry the Flax names (`MLP_0` is `mlp`, as in the decoders),
so `weights.decoder_state_dict` carries the JAX params over.
  * SAAGRefinementNet: features sampled bilinearly at the SAAG Gaussians'
    projected positions, an MLP -> 16 residuals scaled by learned
    per-type scales, an exponential scale update and a delta-quaternion
    composed onto the SAAG rotation; returns the residuals for the
    regulariser.
  * FeatureGuidedSAAG: a two-layer net, its last layer zero-initialised,
    predicting 6 tanh-bounded per-patch SAAG modulations.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from fresnel_tpu_torch.core.gaussians import (
    quaternion_multiply, quaternion_normalize, rotation_6d_to_quaternion)
from fresnel_tpu_torch.models.blocks import (
    MLP, Linear, ZeroInitLinear, bilinear_sample)

# Each SAAG Gaussian's own fields beside its sampled features: position 3,
# scale 3, rotation 4, colour 3, opacity 1.
SAAG_FIELDS = 14


class SAAGRefinementNet(nn.Module):
    def __init__(self, feature_dim: int = 384,
                 hidden_dims: Sequence[int] = (256, 128),
                 residual_scale: float = 0.1, dropout: float = 0.1):
        super().__init__()
        self.residual_scale = residual_scale
        self.mlp = MLP(feature_dim + SAAG_FIELDS, hidden_dims, 16, dropout)
        self.pos_scale = nn.Parameter(torch.tensor(0.05))
        self.scale_scale = nn.Parameter(torch.tensor(0.1))
        self.color_scale = nn.Parameter(torch.tensor(0.1))
        self.opacity_scale = nn.Parameter(torch.tensor(0.1))

    def forward(self, features: torch.Tensor,        # (B, 37, 37, C)
                saag_positions: torch.Tensor,       # (B, N, 3)
                saag_scales: torch.Tensor,          # (B, N, 3)
                saag_rotations: torch.Tensor,       # (B, N, 4)
                saag_colors: torch.Tensor,          # (B, N, 3)
                saag_opacities: torch.Tensor,       # (B, N)
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """The refined Gaussians and their residuals; dropout is active
        only with deterministic=False (masks from `generator`)."""
        # [0, 1] image coordinates (camera at the origin, positions in
        # about [-2, 2]).
        z = torch.clamp(saag_positions[..., 2:3], min=0.1)
        pos2d = saag_positions[..., :2] / z
        pos01 = torch.clamp((pos2d + 2.0) / 4.0, 0.0, 1.0)

        sampled = bilinear_sample(features, pos01)             # (B, N, C)
        inputs = torch.cat([sampled, saag_positions, saag_scales,
                            saag_rotations, saag_colors,
                            saag_opacities[..., None]], -1)
        residuals = self.mlp(inputs, deterministic, generator)

        rs = self.residual_scale
        pos_delta = residuals[..., 0:3] * self.pos_scale * rs
        scale_delta = residuals[..., 3:6] * self.scale_scale * rs
        rot_6d = residuals[..., 6:12]
        color_delta = residuals[..., 12:15] * self.color_scale * rs
        opacity_delta = residuals[..., 15:16] * self.opacity_scale * rs

        rot_delta = rotation_6d_to_quaternion(rot_6d)
        refined_rot = quaternion_normalize(
            quaternion_multiply(rot_delta, saag_rotations))
        return {
            "positions": saag_positions + pos_delta,
            "scales": saag_scales * torch.exp(scale_delta),
            "rotations": refined_rot,
            "colors": torch.clamp(saag_colors + color_delta, 0.0, 1.0),
            "opacities": torch.clamp(
                saag_opacities + opacity_delta[..., 0], 0.0, 1.0),
            "residuals": {
                "pos_delta": pos_delta,
                "scale_delta": scale_delta,
                "color_delta": color_delta,
                "opacity_delta": opacity_delta,
            },
        }


class FeatureGuidedSAAG(nn.Module):
    def __init__(self, feature_dim: int = 384, num_params: int = 6,
                 hidden_dim: int = 64):
        super().__init__()
        self.Dense_0 = Linear(feature_dim, hidden_dim)
        self.Dense_1 = ZeroInitLinear(hidden_dim, num_params)

    def forward(self, features: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(B, H, W, C) features -> per-patch SAAG modulation maps
        (B, H, W)."""
        p = self.Dense_1(F.relu(self.Dense_0(features)))
        t = torch.tanh(p)
        return {
            "aspect_ratio_mult": 1.0 + t[..., 0] * 0.5,
            "edge_threshold_add": t[..., 1] * 0.1,
            "edge_shrink_mult": 1.0 + t[..., 2] * 0.3,
            "normal_strength_mult": 1.0 + t[..., 3] * 0.3,
            "base_size_mult": 1.0 + t[..., 4] * 0.5,
            "opacity_mult": 1.0 + t[..., 5] * 0.3,
        }
