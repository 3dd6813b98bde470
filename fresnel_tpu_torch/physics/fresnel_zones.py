"""Fresnel-zone utilities.

Counterpart of fresnel_tpu/physics/fresnel_zones.py:
  * `sobel_gradients` (which the gradient depth fallback uses);
  * `FresnelZones`: uniform depth zones, zone-centre snapping and the soft
    boundary mask that weights the trainer's boundary loss;
  * `constrain_wavelength`, `PhysicsFresnelZones` (zone-plate boundaries
    r_n = sqrt(n lambda f) normalised to [0, 1], alternating 0 / pi zone
    phases, the wave equation phi = (2 pi / lambda) |d - f|) and
    `MultiWavelengthPhysics` (per-RGB wavelengths at the ratios 700 : 550
    : 450, per-channel phases, chromatic dispersion).
The wavelength is an argument of each call, so a learnable one lives in
the caller's parameters.  Every division takes a tensor divisor and every
square root is rounded once from float64, so the values equal the JAX
package's on XLA:CPU bit for bit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F


PI = math.pi
# Physical wavelength ratios normalised to green (700/550, 1, 450/550).
WAVELENGTH_RATIO_R = 700.0 / 550.0
WAVELENGTH_RATIO_G = 1.0
WAVELENGTH_RATIO_B = 450.0 / 550.0


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """float32 square root rounded once (through float64, where it is
    exact before the final rounding), as XLA computes it; torch's
    vectorised CPU sqrt is 1 ulp off for a few inputs."""
    return torch.sqrt(x.double()).to(x.dtype)


def constrain_wavelength(raw, lo: float = 0.01, hi: float = 0.5
                         ) -> torch.Tensor:
    """|raw| clamped to [lo, hi]: no divergence, still differentiable."""
    return torch.clamp(torch.abs(raw), lo, hi)


def sobel_gradients(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sobel x / y gradients of (..., H, W) maps, zero padded to the same
    size (the JAX package's 3x3 convolution with SAME padding).

    The taps are small integers, so each map is a sum of shifted slices:
    exact float32 products on any device, and no cuDNN (whose float32
    convolutions may run in TF32).  A bf16 map (`use_amp`) is summed in
    float32, where its sums are exact, and rounded once to bf16, as
    XLA:CPU's bf16 convolution rounds them (summed in bf16, the edge
    detector's gradients leave twice JAX's own bf16 gap,
    tests/test_torch_amp.py)."""
    if not img.is_floating_point():
        img = img.to(torch.float32)
    if img.dtype == torch.bfloat16:
        gx, gy = sobel_gradients(img.float())
        return gx.to(img.dtype), gy.to(img.dtype)
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


@dataclasses.dataclass(frozen=True)
class PhysicsFresnelZones:
    """Zone-plate physics: sqrt-spaced boundaries and wave-equation phases.
    The (possibly learnable) wavelength is passed per call; None takes
    `wavelength_init`."""

    num_zones: int = 8
    wavelength_init: float = 0.05
    focal_depth: float = 0.5
    wavelength_min: float = 0.01
    wavelength_max: float = 0.5

    def _wl(self, wavelength, device=None) -> torch.Tensor:
        wl = self.wavelength_init if wavelength is None else wavelength
        return constrain_wavelength(_f32(wl, device), self.wavelength_min,
                                    self.wavelength_max)

    def zone_boundaries(self, wavelength=None, device=None) -> torch.Tensor:
        wl = self._wl(wavelength, device)
        n = torch.arange(self.num_zones + 1, dtype=torch.float32,
                         device=wl.device)
        r = sqrt_rn(n * wl * self.focal_depth)
        return r / (r[-1] + 1e-8)

    def zone_index(self, depth: torch.Tensor, wavelength=None
                   ) -> torch.Tensor:
        """Zone of each depth: searchsorted(side="right") over the inner
        boundaries, clipped to [0, num_zones - 1]."""
        b = self.zone_boundaries(wavelength, depth.device)
        idx = torch.bucketize(depth, b[1:-1].contiguous(), right=True)
        return torch.clamp(idx, 0, self.num_zones - 1)

    @staticmethod
    def zone_phase(zone_idx: torch.Tensor) -> torch.Tensor:
        """Alternating 0 / pi phases, the zone-plate signature."""
        return (zone_idx % 2).to(torch.float32) * PI

    def path_difference(self, depth: torch.Tensor) -> torch.Tensor:
        return torch.abs(depth - self.focal_depth)

    def depth_to_phase(self, depth: torch.Tensor, wavelength=None
                       ) -> torch.Tensor:
        """phi = (2 pi / lambda) |depth - focal|."""
        wl = self._wl(wavelength, depth.device)
        return (_f32(2.0 * PI, wl.device) / wl) * self.path_difference(depth)

    def __call__(self, depth: torch.Tensor, wavelength=None,
                 return_all: bool = False):
        if not return_all:
            return self.depth_to_phase(depth, wavelength)
        zi = self.zone_index(depth, wavelength)
        return {
            "phase": self.depth_to_phase(depth, wavelength),
            "zone_idx": zi,
            "zone_phase": self.zone_phase(zi),
            "path_difference": self.path_difference(depth),
            "boundaries": self.zone_boundaries(wavelength, depth.device),
            "wavelength": self._wl(wavelength, depth.device),
        }


@dataclasses.dataclass(frozen=True)
class MultiWavelengthPhysics:
    """Per-RGB-channel wavelength physics."""

    base_wavelength: float = 0.05
    use_physical_ratios: bool = True
    wavelength_min: float = 0.01
    wavelength_max: float = 0.5
    focal_depth: float = 0.5

    def init_wavelengths(self, device=None) -> torch.Tensor:
        """Initial raw (3,) wavelengths [R, G, B], the learnable
        parameter."""
        if self.use_physical_ratios:
            return _f32([self.base_wavelength * WAVELENGTH_RATIO_R,
                         self.base_wavelength * WAVELENGTH_RATIO_G,
                         self.base_wavelength * WAVELENGTH_RATIO_B], device)
        return torch.full((3,), self.base_wavelength, dtype=torch.float32,
                          device=device)

    def _wls(self, wavelengths, device=None) -> torch.Tensor:
        wl = (self.init_wavelengths(device) if wavelengths is None
              else _f32(wavelengths, device))
        return constrain_wavelength(wl, self.wavelength_min,
                                    self.wavelength_max)

    def path_difference(self, depth: torch.Tensor) -> torch.Tensor:
        return torch.abs(depth - self.focal_depth)

    def depth_to_phase_rgb(self, depth: torch.Tensor, wavelengths=None
                           ) -> torch.Tensor:
        """(...,) depth -> (..., 3) per-channel phase."""
        pd = self.path_difference(depth)[..., None]
        wl = self._wls(wavelengths, depth.device)
        return (_f32(2.0 * PI, wl.device) / wl) * pd

    def depth_to_phase_single(self, depth: torch.Tensor, channel: str = "g",
                              wavelengths=None) -> torch.Tensor:
        c = {"r": 0, "g": 1, "b": 2}[channel.lower()]
        wl = self._wls(wavelengths, depth.device)[c]
        return (_f32(2.0 * PI, wl.device) / wl) * self.path_difference(depth)

    def chromatic_dispersion(self, wavelengths=None, device=None
                             ) -> torch.Tensor:
        wl = self._wls(wavelengths, device)
        return (wl[0] - wl[2]) / wl[1]

    def __call__(self, depth: torch.Tensor, wavelengths=None,
                 return_all: bool = False):
        phases = self.depth_to_phase_rgb(depth, wavelengths)
        if not return_all:
            return phases
        out: Dict[str, torch.Tensor] = {
            "phases": phases,
            "wavelengths": self._wls(wavelengths, depth.device),
            "chromatic_dispersion": self.chromatic_dispersion(
                wavelengths, depth.device),
        }
        return out
