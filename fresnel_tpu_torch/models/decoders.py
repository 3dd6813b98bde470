"""DirectPatchDecoder: per-patch MLP from the DINOv2 grid to Gaussians.

Counterpart of fresnel_tpu/models/decoders.py at the configuration the
image->3DGS path runs: K Gaussians per patch x 16 outputs, base grid in
[-1, 1], XY offsets scaled 0.25, Z locked to depth (depth_offset + depth *
depth_z_scale, plus tanh(raw z) * z_offset_scale when that is not 0),
scales softplus(raw + 1) * 0.15 clamped, 6D rotations,
sigmoid colors and opacities, dropout 0.1 in the MLP in training (called
with deterministic=False), the grid rotated to face a given (elevation,
azimuth) pose as the multi-pose trainer asks, and with feature_upsample f
the features decoded on an f-times finer lattice (bilinear upsample, then
a 3x3 conv, GELU and a zero-initialised 3x3 conv added as a residual).
The Fresnel-zone, edge-aware, phase-output, pose-encoding and
depth-fusion options raise NotImplementedError.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fresnel_tpu_torch.core.gaussians import rotation_6d_to_quaternion
from fresnel_tpu_torch.models.blocks import (
    MLP, Conv2d, rotate_positions_for_pose)
from fresnel_tpu_torch.models.encoders import _resize_weights, resize_linear

OUTPUTS_PER_GAUSSIAN = 16


@functools.lru_cache(maxsize=None)
def _taps(n_in: int, n_out: int, device: torch.device
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two taps of each output sample of a linear resize without
    antialiasing (jax.image.resize's weights): indices and weights, each
    (2, n_out), in ascending index order; a missing tap has weight 0."""
    wm = _resize_weights(n_in, n_out, antialias=False)
    idx = np.argsort(wm == 0, axis=0, kind="stable")[:2]
    wt = np.take_along_axis(wm, idx, axis=0)
    return (torch.from_numpy(idx).to(device),
            torch.from_numpy(wt).to(device))


def _fma(x: torch.Tensor, w: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """x * w + acc in float32 with one rounding, as a fused multiply-add
    gives it: computed in float64, where the product is exact."""
    return (x.double() * w.double() + acc.double()).float()


def _resize_depth_to_grid(depth: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, H, W[, 1]) -> (B, h, w) bilinear without antialiasing, rounded
    as the JAX package's jax.image.resize(antialias=False) is on XLA:CPU
    (jax 0.9): rows first, each output the fused multiply-add of its two
    taps in index order; then columns, the sum of the two rounded
    products.  That is bit for bit at every batch size at 74^2 and above
    a batch of one at 37^2; for one image at 37^2 XLA's dot kernel fuses
    the column step as well, and a few hundred of the 1 369 values differ
    by 1 ulp (tests/test_torch_decoder.py holds both).
    The depth-locked Gaussians of a patch, and of patches of equal depth,
    share one z: these last bits decide which of them tie, so the
    compositing order, so the image (F.interpolate's samples moved
    renders of the trained exp2 model by up to 1.6e-3)."""
    if depth.dim() == 4:
        depth = depth[..., 0]
    H, W = depth.shape[-2:]
    if H != h:
        i, a = _taps(H, h, depth.device)
        depth = _fma(depth[:, i[1]], a[1][:, None],
                     depth[:, i[0]] * a[0][:, None])
    if W != w:
        i, a = _taps(W, w, depth.device)
        depth = depth[..., i[0]] * a[0] + depth[..., i[1]] * a[1]
    return depth


def head_transform(raw: torch.Tensor, depth: Optional[torch.Tensor],
                   depth_offset: torch.Tensor, *, scale_bias: float = 0.0,
                   opacity_bias: float = 0.0, depth_z_scale: float = -2.0,
                   z_offset_scale: float = 0.0,
                   elevation: Optional[torch.Tensor] = None,
                   azimuth: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
    """Raw per-patch head outputs (B, H, W, K, 16) -> Gaussian parameters;
    with a (B,) elevation and azimuth the positions are rotated to face
    that pose.  A z_offset_scale other than 0 adds tanh(raw z) times it to
    the depth-locked z, a bounded per-Gaussian residual."""
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
    z_term = (base_z + torch.tanh(raw_pos[..., 2]) * z_offset_scale
              if z_offset_scale else base_z)

    positions = torch.stack([base_x + raw_pos[..., 0] * 0.25,
                             base_y + raw_pos[..., 1] * 0.25,
                             z_term], dim=-1)
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


class ZeroInitConv2d(Conv2d):
    """A Conv2d that `weights.init_flax_like_` initialises to zero (Flax's
    `kernel_init=zeros`)."""


class DirectPatchDecoder(nn.Module):
    """features (B, H, W, C) [+ depth (B, Hd, Wd)] -> H * W * K Gaussians
    (f^2 times as many with feature_upsample f)."""

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
                        use_depth_fusion=use_depth_fusion)
        on = [k for k, v in unported.items() if v]
        if on:
            raise NotImplementedError(
                f"DirectPatchDecoder options not ported: {on}")
        self.gaussians_per_patch = gaussians_per_patch
        self.scale_bias = scale_bias
        self.opacity_bias = opacity_bias
        self.depth_z_scale = depth_z_scale
        self.z_offset_scale = z_offset_scale
        self.feature_upsample = feature_upsample
        if feature_upsample > 1:
            # Flax's names; 3x3 SAME, NHWC there, NCHW here.
            self.upsample_conv = Conv2d(feature_dim, feature_dim, 3,
                                        padding=1)
            self.upsample_refine = ZeroInitConv2d(feature_dim, feature_dim,
                                                  3, padding=1)
        self.mlp = MLP(feature_dim, hidden_dims,
                       gaussians_per_patch * OUTPUTS_PER_GAUSSIAN, dropout)
        self.depth_offset = nn.Parameter(torch.tensor(-2.0))

    def forward(self, features: torch.Tensor,
                depth: Optional[torch.Tensor] = None,
                num_gaussians: Optional[int] = None,
                elevation: Optional[torch.Tensor] = None,
                azimuth: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                return_raw: bool = False) -> Dict[str, torch.Tensor]:
        """Dropout is active only with deterministic=False (the masks
        drawn from `generator`); a (B,) elevation and azimuth rotate the
        grid to face that pose; with `return_raw` the result also holds
        "raw", the (B, H, W, K, 16) head outputs."""
        B, H, W, C = features.shape
        if self.feature_upsample > 1:
            f = self.feature_upsample
            H, W = H * f, W * f
            up = resize_linear(features.permute(0, 3, 1, 2), H, W)
            # Flax's nn.gelu is the tanh form.
            up = up + self.upsample_refine(F.gelu(self.upsample_conv(up),
                                                  approximate="tanh"))
            features = up.permute(0, 2, 3, 1)
        full_K = self.gaussians_per_patch
        K = min(num_gaussians, full_K) if num_gaussians is not None else full_K
        out = self.mlp(features.reshape(B * H * W, C), deterministic,
                       generator)
        out = out.reshape(B, H, W, full_K, OUTPUTS_PER_GAUSSIAN)[:, :, :, :K]
        result = head_transform(out, depth, self.depth_offset,
                                scale_bias=self.scale_bias,
                                opacity_bias=self.opacity_bias,
                                depth_z_scale=self.depth_z_scale,
                                z_offset_scale=self.z_offset_scale,
                                elevation=elevation, azimuth=azimuth)
        if return_raw:
            result["raw"] = out
        return result
