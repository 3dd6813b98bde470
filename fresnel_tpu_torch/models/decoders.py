"""DirectPatchDecoder: per-patch MLP from the DINOv2 grid to Gaussians.

Counterpart of fresnel_tpu/models/decoders.py::DirectPatchDecoder and
`head_transform`: K Gaussians per patch x 16 outputs (19 with per-RGB
phases, `use_phase_output`), base grid in [-1, 1], XY offsets scaled
0.25, Z locked to depth (depth_offset + depth * depth_z_scale, plus
tanh(raw z) * z_offset_scale when that is not 0), scales softplus(raw +
1) * 0.15 clamped, 6D rotations, sigmoid colors and opacities, dropout
0.1 in the MLP in training (called with deterministic=False), the grid
rotated to face a given (elevation, azimuth) pose as the multi-pose
trainer asks, and with feature_upsample f the features decoded on an
f-times finer lattice (bilinear upsample, then a 3x3 conv, GELU and a
zero-initialised 3x3 conv added as a residual).  The options: the depth
quantised to Fresnel-zone centres (`use_fresnel_zones`), scales shrunk
and opacities raised at depth edges found by a learned
`FresnelEdgeDetector` (`use_edge_aware`), phases sigmoid * 2 pi
(`use_phase_output`), opacities modulated into [0.5, 1.5] by a
`PoseEncoder` of the pose (`use_pose_encoding`), and a `DepthEncoder`'s
features concatenated to the patch features (`use_depth_fusion`).

`PhysicsDirectPatchDecoder` (the JAX package's, for the wave-field
renderer) has the same MLP and head, its z always depth-locked (offset
plus depth times -2), and computes its phase from z by the wave equation
instead of predicting it: z normalised over each image to [0, 1], phi =
(2 pi / lambda) |z - focal| wrapped to [0, 2 pi), with a learnable
wavelength `wavelength_raw`; with `use_diffraction_placement` the
opacities are scaled by the Fresnel edge-diffraction profile of the
depth grid's Sobel edges.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fresnel_tpu_torch.core.gaussians import rotation_6d_to_quaternion
from fresnel_tpu_torch.core.ops import (
    _resize_weights, resize_linear, wrap_phase)
from fresnel_tpu_torch.models.blocks import (
    MLP, Conv2d, DepthEncoder, Linear, PoseEncoder,
    rotate_positions_for_pose)
from fresnel_tpu_torch.physics.edge_detector import FresnelEdgeDetector
from fresnel_tpu_torch.physics.diffraction import FresnelDiffraction
from fresnel_tpu_torch.physics.fresnel_zones import (
    FresnelZones, PhysicsFresnelZones, sobel_gradients, sqrt_rn)

OUTPUTS_PER_GAUSSIAN = 16
OUTPUTS_WITH_PHASE = 19
TWO_PI = 6.283185307179586


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
    renders of the trained exp2 model by up to 1.6e-3).  A bf16 depth
    (`use_amp`) is resized as XLA:CPU resizes it: two bf16 products with
    the weights rounded to bf16, rows first, which `resize_linear` gives
    bit for bit."""
    if depth.dim() == 4:
        depth = depth[..., 0]
    if depth.dtype == torch.bfloat16:
        return resize_linear(depth, h, w, antialias=False)
    H, W = (int(n) for n in depth.shape[-2:])  # ints also under tracing
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
                   opacity_bias: float = 0.0,
                   use_fresnel_zones: bool = False,
                   num_fresnel_zones: int = 8,
                   use_edge_aware: bool = False,
                   edge_scale_factor: float = 0.5,
                   edge_opacity_boost: float = 0.2,
                   use_phase_output: bool = False,
                   edge_detector: Optional[nn.Module] = None,
                   depth_z_scale: float = -2.0,
                   z_offset_scale: float = 0.0,
                   elevation: Optional[torch.Tensor] = None,
                   azimuth: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
    """Raw per-patch head outputs (B, H, W, K, 16 or 19) -> Gaussian
    parameters; with a (B,) elevation and azimuth the positions are
    rotated to face that pose.  A z_offset_scale other than 0 adds
    tanh(raw z) times it to the depth-locked z, a bounded per-Gaussian
    residual.  With a depth, `use_edge_aware` runs `edge_detector` (the
    decoder's module: this function builds none, so a caller outside a
    decoder keeps it off) on the depth grid, shrinks scales by
    1 - edge_scale_factor * edge and adds edge_opacity_boost * edge to
    the opacities, and returns "edge_strength" (B, H, W, 1);
    `use_fresnel_zones` then snaps the depth grid to its zone's centre.
    `use_phase_output` returns "phases" (B, N, 3), sigmoid * 2 pi of raw
    channels 16-18.  Under `use_amp` the raw outputs are bf16 and the
    head computes in bf16 as the JAX function does; the float32 grid
    makes the positions float32, as JAX's strong float32 linspace
    does."""
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

    edge_strength = None
    if depth is not None:
        depth_grid = _resize_depth_to_grid(depth, H, W)            # (B, H, W)
        if use_edge_aware:
            if edge_detector is None:
                raise ValueError("use_edge_aware needs the decoder's "
                                 "edge detector")
            edge_strength = edge_detector(depth_grid)              # (B,H,W,1)
        if use_fresnel_zones:
            depth_grid = FresnelZones(
                num_zones=num_fresnel_zones).zone_centers_for_depth(depth_grid)
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
    if edge_strength is not None:
        edge = edge_strength                                   # (B, H, W, 1)
        scales = scales * (1.0 - edge_scale_factor * edge[..., None])
        opacities = torch.clamp(opacities + edge_opacity_boost * edge,
                                0.0, 1.0)

    N = H * W * K
    result = {
        "positions": positions.reshape(B, N, 3),
        "scales": scales.reshape(B, N, 3),
        "rotations": rotations.reshape(B, N, 4),
        "colors": colors.reshape(B, N, 3),
        "opacities": opacities.reshape(B, N),
    }
    if use_phase_output:
        result["phases"] = (torch.sigmoid(raw[..., 16:19]) * TWO_PI
                            ).reshape(B, N, 3)
    if edge_strength is not None:
        result["edge_strength"] = edge_strength
    return result


def pose_opacity(opacities: torch.Tensor, pose_encoder: nn.Module,
                 hidden: nn.Module, out: nn.Module,
                 elevation: torch.Tensor, azimuth: torch.Tensor
                 ) -> torch.Tensor:
    """(B, N) opacities times 0.5 + sigmoid(out(relu(hidden(pose
    embedding)))), a (B, 1) factor in [0.5, 1.5], clamped to [0, 1]."""
    mod = out(F.relu(hidden(pose_encoder(elevation, azimuth))))
    return torch.clamp(opacities * (0.5 + torch.sigmoid(mod)), 0.0, 1.0)


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
                 num_fresnel_zones: int = 8,
                 use_edge_aware: bool = False,
                 edge_scale_factor: float = 0.5,
                 edge_opacity_boost: float = 0.2,
                 use_phase_output: bool = False,
                 use_pose_encoding: bool = False,
                 pose_embed_dim: int = 64,
                 use_depth_fusion: bool = False,
                 depth_feature_dim: int = 64,
                 feature_upsample: int = 1,
                 z_offset_scale: float = 0.0):
        super().__init__()
        self.gaussians_per_patch = gaussians_per_patch
        self.scale_bias = scale_bias
        self.opacity_bias = opacity_bias
        self.depth_z_scale = depth_z_scale
        self.z_offset_scale = z_offset_scale
        self.feature_upsample = feature_upsample
        self.use_fresnel_zones = use_fresnel_zones
        self.num_fresnel_zones = num_fresnel_zones
        self.use_edge_aware = use_edge_aware
        self.edge_scale_factor = edge_scale_factor
        self.edge_opacity_boost = edge_opacity_boost
        self.use_phase_output = use_phase_output
        self.use_pose_encoding = use_pose_encoding
        self.use_depth_fusion = use_depth_fusion
        self.outputs = (OUTPUTS_WITH_PHASE if use_phase_output
                        else OUTPUTS_PER_GAUSSIAN)
        if feature_upsample > 1:
            # Flax's names; 3x3 SAME, NHWC there, NCHW here.
            self.upsample_conv = Conv2d(feature_dim, feature_dim, 3,
                                        padding=1)
            self.upsample_refine = ZeroInitConv2d(feature_dim, feature_dim,
                                                  3, padding=1)
        mlp_in = feature_dim
        if use_depth_fusion:
            self.depth_encoder = DepthEncoder(depth_feature_dim)
            mlp_in += depth_feature_dim
        self.mlp = MLP(mlp_in, hidden_dims,
                       gaussians_per_patch * self.outputs, dropout)
        self.depth_offset = nn.Parameter(torch.tensor(-2.0))
        if use_edge_aware:
            self.edge_detector = FresnelEdgeDetector()
        if use_pose_encoding:
            self.pose_encoder = PoseEncoder(pose_embed_dim)
            self.opacity_hidden = Linear(pose_embed_dim, 128)
            self.opacity_out = Linear(128, 1)

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
        grid to face that pose (and, with `use_pose_encoding`, modulate
        the opacities); with `return_raw` the result also holds "raw",
        the (B, H, W, K, 16 or 19) head outputs."""
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
        if self.use_depth_fusion:
            if depth is None:
                raise ValueError("use_depth_fusion needs a depth")
            features = torch.cat(
                [features, self.depth_encoder(depth, grid_size=H)], dim=-1)
        out = self.mlp(features.reshape(B * H * W, -1), deterministic,
                       generator)
        out = out.reshape(B, H, W, full_K, self.outputs)[:, :, :, :K]
        result = head_transform(
            out, depth, self.depth_offset, scale_bias=self.scale_bias,
            opacity_bias=self.opacity_bias,
            use_fresnel_zones=self.use_fresnel_zones,
            num_fresnel_zones=self.num_fresnel_zones,
            use_edge_aware=self.use_edge_aware,
            edge_scale_factor=self.edge_scale_factor,
            edge_opacity_boost=self.edge_opacity_boost,
            use_phase_output=self.use_phase_output,
            edge_detector=getattr(self, "edge_detector", None),
            depth_z_scale=self.depth_z_scale,
            z_offset_scale=self.z_offset_scale,
            elevation=elevation, azimuth=azimuth)
        if self.use_pose_encoding and elevation is not None \
                and azimuth is not None:
            result["opacities"] = pose_opacity(
                result["opacities"], self.pose_encoder, self.opacity_hidden,
                self.opacity_out, elevation, azimuth)
        if return_raw:
            result["raw"] = out
        return result


class PhysicsDirectPatchDecoder(nn.Module):
    """DirectPatchDecoder with its phase computed from z by the wave
    equation (batch-normalised z -> phi = (2 pi / lambda) |z~ - f|,
    wrapped to [0, 2 pi)) instead of predicted: features (B, H, W, C) [+
    depth] -> H * W * K Gaussians with a scalar phase each."""

    def __init__(self, feature_dim: int = 384, gaussians_per_patch: int = 8,
                 hidden_dims: Sequence[int] = (512, 512, 256, 128),
                 dropout: float = 0.1, wavelength: float = 0.05,
                 learnable_wavelength: bool = True, focal_depth: float = 0.5,
                 use_diffraction_placement: bool = False,
                 scale_bias: float = 0.0, opacity_bias: float = 0.0):
        super().__init__()
        self.gaussians_per_patch = gaussians_per_patch
        self.wavelength = wavelength
        self.learnable_wavelength = learnable_wavelength
        self.focal_depth = focal_depth
        self.use_diffraction_placement = use_diffraction_placement
        self.scale_bias = scale_bias
        self.opacity_bias = opacity_bias
        self.mlp = MLP(feature_dim, hidden_dims,
                       gaussians_per_patch * OUTPUTS_PER_GAUSSIAN, dropout)
        self.depth_offset = nn.Parameter(torch.tensor(-2.0))
        if learnable_wavelength:
            self.wavelength_raw = nn.Parameter(torch.tensor(float(wavelength)))

    def fringe(self, depth_grid: torch.Tensor) -> torch.Tensor:
        """(B, H, W) Fresnel edge-diffraction opacity factor in [0.5,
        1.25]: strong Sobel edges of the depth grid lie in the fringe
        region."""
        fd = FresnelDiffraction(wavelength=self.wavelength)
        gx, gy = sobel_gradients(depth_grid)
        edge = torch.tanh(sqrt_rn(gx * gx + gy * gy + 1e-12) * 10.0)
        dist = (1.0 - edge) * 0.5
        w = fd.compute_fresnel_parameter(dist, torch.abs(depth_grid) + 1.0)
        return torch.clamp(fd.fresnel_intensity(w) / 2.0, 0.5, 1.25)

    def forward(self, features: torch.Tensor,
                depth: Optional[torch.Tensor] = None,
                num_gaussians: Optional[int] = None,
                elevation: Optional[torch.Tensor] = None,
                azimuth: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """Dropout is active only with deterministic=False (the masks
        drawn from `generator`).  The pose arguments are accepted, as the
        JAX decoder accepts them, and unused."""
        B, H, W, C = features.shape
        full_K = self.gaussians_per_patch
        K = min(num_gaussians, full_K) if num_gaussians is not None else full_K
        out = self.mlp(features.reshape(B * H * W, C), deterministic,
                       generator)
        out = out.reshape(B, H, W, full_K, OUTPUTS_PER_GAUSSIAN)[:, :, :, :K]
        result = head_transform(out, depth, self.depth_offset,
                                scale_bias=self.scale_bias,
                                opacity_bias=self.opacity_bias)
        if self.use_diffraction_placement and depth is not None:
            fringe = self.fringe(_resize_depth_to_grid(depth, H, W))
            op = result["opacities"].reshape(B, H, W, K)
            result["opacities"] = torch.clamp(
                op * fringe[..., None], 0.0, 1.0).reshape(B, H * W * K)

        wl = (self.wavelength_raw if self.learnable_wavelength
              else torch.tensor(self.wavelength, device=features.device))
        zones = PhysicsFresnelZones(wavelength_init=self.wavelength,
                                    focal_depth=self.focal_depth)
        z = result["positions"][..., 2]                            # (B, N)
        z_min = torch.amin(z, dim=1, keepdim=True)
        z_max = torch.amax(z, dim=1, keepdim=True)
        z_norm = (z - z_min) / (z_max - z_min + 1e-8)
        result["phases"] = wrap_phase(zones.depth_to_phase(z_norm,
                                                           wavelength=wl))
        return result
