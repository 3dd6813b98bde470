"""Fresnel-zone utilities: `sobel_gradients` and `FresnelZones`.

Counterpart of fresnel_tpu/physics/fresnel_zones.py::sobel_gradients
(which the gradient depth fallback uses) and its `FresnelZones`: uniform
depth zones, zone-centre snapping and the soft boundary mask that weights
the trainer's boundary loss.  `PhysicsFresnelZones` and
`MultiWavelengthPhysics` are not ported (ROADMAP Queue 1, item 5).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def sobel_gradients(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sobel x / y gradients of (..., H, W) maps, zero padded to the same
    size (the JAX package's 3x3 convolution with SAME padding).

    The taps are small integers, so each map is a sum of shifted slices:
    exact float32 products on any device, and no cuDNN (whose float32
    convolutions may run in TF32)."""
    if not img.is_floating_point():
        img = img.to(torch.float32)
    lead, (H, W) = img.shape[:-2], img.shape[-2:]
    x = F.pad(img.reshape(-1, H, W), (1, 1, 1, 1))

    def tap(i, j):
        return x[:, i:i + H, j:j + W]

    # kx = [[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]]; ky is its transpose.
    gx = (tap(0, 2) - tap(0, 0)) + 2.0 * (tap(1, 2) - tap(1, 0)) \
        + (tap(2, 2) - tap(2, 0))
    gy = (tap(2, 0) - tap(0, 0)) + 2.0 * (tap(2, 1) - tap(0, 1)) \
        + (tap(2, 2) - tap(0, 2))
    return gx.reshape(*lead, H, W), gy.reshape(*lead, H, W)


@dataclasses.dataclass(frozen=True)
class FresnelZones:
    """Heuristic uniform depth zones over `depth_range`."""

    num_zones: int = 8
    depth_range: Tuple[float, float] = (0.0, 1.0)
    boundary_threshold: float = 0.02
    soft_boundaries: bool = True

    def zone_boundaries(self, device=None) -> torch.Tensor:
        """(num_zones + 1,) float32 boundaries, linspace over the range."""
        return torch.linspace(self.depth_range[0], self.depth_range[1],
                              self.num_zones + 1, device=device)

    def zone_centers(self, device=None) -> torch.Tensor:
        b = self.zone_boundaries(device)
        return 0.5 * (b[:-1] + b[1:])

    def quantize_depth(self, depth: torch.Tensor) -> torch.Tensor:
        """Zone index per value; a value exactly on a boundary belongs to
        the lower zone (searchsorted side="left")."""
        d = torch.clamp(depth, self.depth_range[0], self.depth_range[1])
        inner = self.zone_boundaries(depth.device)[1:-1].contiguous()
        return torch.bucketize(d, inner, right=False)

    def zone_centers_for_depth(self, depth: torch.Tensor) -> torch.Tensor:
        return self.zone_centers(depth.device)[self.quantize_depth(depth)]

    def boundary_mask(self, depth: torch.Tensor,
                      threshold: Optional[float] = None,
                      emphasis: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
        """Per-pixel proximity to the nearest zone boundary: a sigmoid of
        sharpness 10 / threshold (or a hard mask).  With a learnable
        per-boundary `emphasis` (num_zones + 1,), the largest weighted
        per-boundary mask."""
        t = self.boundary_threshold if threshold is None else threshold
        dist = torch.abs(depth[..., None]
                         - self.zone_boundaries(depth.device))
        if emphasis is None:
            dmin = dist.min(dim=-1).values
            if self.soft_boundaries:
                return torch.sigmoid((10.0 / t) * (t - dmin))
            return (dmin < t).to(torch.float32)
        if self.soft_boundaries:
            per_b = torch.sigmoid((10.0 / t) * (t - dist))
        else:
            per_b = (dist < t).to(torch.float32)
        return (per_b * emphasis).max(dim=-1).values
