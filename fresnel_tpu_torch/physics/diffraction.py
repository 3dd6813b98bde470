"""Fresnel diffraction: the C / S integral tables and the edge profile.

Counterpart of fresnel_tpu/physics/diffraction.py::FresnelDiffraction:
lookup tables of the Fresnel integrals C(w) = int cos(pi t^2 / 2) and
S(w) = int sin(pi t^2 / 2) built on the host as the JAX package builds
them (numpy float32 cumsum), linear interpolation in them, the edge
intensity profile I = (C + 1/2)^2 + (S + 1/2)^2, the Fresnel parameter
w = |x| sqrt(2 / (lambda z)) and the fringe maxima w_n ~ sqrt(2n + 1/2).
Rounded as XLA:CPU rounds the JAX functions: the table index is `w`
times the folded constant (lut_size - 1) / lut_max_w, truncated, the
interpolation and the profile end in one fused multiply-add, and square
roots round once, so the values are bit for bit the JAX package's.
`DiffractiveLayer` and `MultiscaleDiffractiveLayer` are not ported
(ROADMAP Queue 1, item 5).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from fresnel_tpu_torch.physics.fresnel_zones import sqrt_rn


@functools.lru_cache(maxsize=None)
def _host_lut(lut_max_w: float, lut_size: int
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    w = np.linspace(0, lut_max_w, lut_size, dtype=np.float32)
    dt = w[1] - w[0]
    C = np.cumsum(np.cos(np.pi * w ** 2 / 2)) * dt
    S = np.cumsum(np.sin(np.pi * w ** 2 / 2)) * dt
    return w, C.astype(np.float32), S.astype(np.float32)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c in float32 with one rounding (computed in float64, where
    the product of two float32 values is exact)."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


@dataclasses.dataclass(frozen=True)
class FresnelDiffraction:
    wavelength: float = 0.05
    num_fringe_samples: int = 16
    lut_size: int = 1000
    lut_max_w: float = 5.0

    def _lut(self, device=None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(w, C, S) tables, (lut_size,) float32 each."""
        return tuple(torch.from_numpy(a).to(device)
                     for a in _host_lut(self.lut_max_w, self.lut_size))

    def _interp(self, w: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
        wc = torch.clamp(w, 0.0, self.lut_max_w)
        # XLA folds `/ lut_max_w * (lut_size - 1)` into one constant.
        idx_f = wc * torch.tensor(np.float32(self.lut_size - 1)
                                  / np.float32(self.lut_max_w),
                                  device=w.device)
        lo = idx_f.to(torch.int32)
        hi = torch.clamp(lo + 1, max=self.lut_size - 1)
        frac = idx_f - lo.to(idx_f.dtype)
        lo_v, hi_v = lut[lo.long()], lut[hi.long()]
        return _fma(hi_v, frac, lo_v * (1 - frac))

    def fresnel_C(self, w: torch.Tensor) -> torch.Tensor:
        return self._interp(w, self._lut(w.device)[1])

    def fresnel_S(self, w: torch.Tensor) -> torch.Tensor:
        return self._interp(w, self._lut(w.device)[2])

    def fresnel_intensity(self, w: torch.Tensor) -> torch.Tensor:
        """I(w) = (C + 0.5)^2 + (S + 0.5)^2, the edge diffraction
        profile."""
        _, C, S = self._lut(w.device)
        c = self._interp(w, C) + 0.5
        s = self._interp(w, S) + 0.5
        return _fma(c, c, s * s)

    def compute_fresnel_parameter(self, distance_from_edge: torch.Tensor,
                                  depth: torch.Tensor) -> torch.Tensor:
        z = torch.clamp(depth, min=0.1)
        two = torch.tensor(2.0, device=depth.device)
        return torch.abs(distance_from_edge) * sqrt_rn(
            two / (self.wavelength * z))

    def compute_edge_density(self, depth: torch.Tensor,
                             edge_mask: torch.Tensor,
                             distance_from_edge: torch.Tensor
                             ) -> torch.Tensor:
        """Fringe-modulated Gaussian-placement density."""
        w = self.compute_fresnel_parameter(distance_from_edge, depth)
        return self.fresnel_intensity(w) * edge_mask

    def get_fringe_positions(self, depth_at_edge: float,
                             device=None) -> torch.Tensor:
        """Distances of the diffraction maxima from the edge:
        w_n ~ sqrt(2n + 0.5), x = w sqrt(lambda z / 2)."""
        n = torch.arange(self.num_fringe_samples, dtype=torch.float32,
                         device=device)
        w_n = sqrt_rn(2 * n + 0.5)
        return w_n * float(np.sqrt(np.float32(
            self.wavelength * depth_at_edge / 2.0)))

    def __call__(self, depth, edge_mask, distance_from_edge):
        return self.compute_edge_density(depth, edge_mask,
                                         distance_from_edge)
