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

`DiffractiveLayer` (a learnable complex transmission surface, D^2NN: t =
sigmoid(amplitude_raw) exp(i (phase mod 2 pi)) multiplying a (C, H, W) or
(B, C, H, W) complex64 field, with its total-variation and centring
regulariser) and `MultiscaleDiffractiveLayer` (children `scale_s`, each
modulating the running field resized to (H >> s, W >> s), its real and
imaginary parts resized as jax.image.resize's "linear" resizes them,
antialiased when downsampling, and back) are the Flax modules of the same
names as torch modules; `weights.diffractive_state_dict` converts their
flat Flax params.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from fresnel_tpu_torch.core.ops import resize_linear, wrap_phase
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


class DiffractiveLayer(nn.Module):
    """Learnable complex transmission surface (D^2NN): parameters
    `amplitude_raw` (C, H, W), initialised to `init_amplitude`, and
    `phase`, normal times `init_phase_scale` drawn from `generator`."""

    def __init__(self, height: int, width: int, num_channels: int = 3,
                 init_amplitude: float = 0.5,
                 init_phase_scale: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.height, self.width = height, width
        shape = (num_channels, height, width)
        self.amplitude_raw = nn.Parameter(
            torch.full(shape, float(init_amplitude)))
        self.phase = nn.Parameter(
            torch.randn(shape, generator=generator) * init_phase_scale)

    def transmission(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(amplitude in (0, 1), phase in [0, 2 pi)), phase taken mod 2 pi
        as jnp.mod takes it."""
        return torch.sigmoid(self.amplitude_raw), wrap_phase(self.phase)

    def forward(self, wave_field: torch.Tensor) -> torch.Tensor:
        """U_in t with t = A e^{i phi}; wave_field complex64 (C, H, W) or
        (B, C, H, W)."""
        amplitude, phase = self.transmission()
        t = torch.polar(amplitude, phase)
        if wave_field.dim() == 4:
            t = t[None]
        return wave_field * t

    def regularization_loss(self) -> torch.Tensor:
        """Total variation of amplitude and phase (0.01 each) plus the
        amplitude's mean squared distance from 0.5 (0.001)."""
        amplitude, phase = self.transmission()

        def jabs(x):
            # |x| with jax.grad's derivative at 0, +1 (torch's is 0): a
            # fresh layer's amplitude is constant, so every difference is 0.
            return torch.where(x >= 0, x, -x)

        def tv(x):
            return (torch.mean(jabs(x[:, 1:] - x[:, :-1]))
                    + torch.mean(jabs(x[:, :, 1:] - x[:, :, :-1])))

        amp_center = torch.mean((amplitude - 0.5) ** 2)
        return 0.01 * tv(amplitude) + 0.01 * tv(phase) + 0.001 * amp_center


def _resize_complex(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """A complex field's real and imaginary parts resized apart (bilinear,
    antialiased when downsampling, as jax.image.resize "linear")."""
    return torch.complex(resize_linear(x.real, h, w),
                         resize_linear(x.imag, h, w))


class MultiscaleDiffractiveLayer(nn.Module):
    """Pyramid of diffractive layers: child `scale_s` modulates the running
    field resized to (max(H >> s, 1), max(W >> s, 1)), which is then
    resized back."""

    def __init__(self, height: int, width: int, num_channels: int = 3,
                 num_scales: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.height, self.width = height, width
        self.num_scales = num_scales
        for s in range(num_scales):
            self.add_module(f"scale_{s}", DiffractiveLayer(
                max(height >> s, 1), max(width >> s, 1), num_channels,
                generator=generator))

    def forward(self, wave_field: torch.Tensor) -> torch.Tensor:
        batched = wave_field.dim() == 4
        out = wave_field if batched else wave_field[None]
        H, W = out.shape[-2:]
        if (H, W) != (self.height, self.width):
            raise ValueError(f"field is {H}x{W}, the layer "
                             f"{self.height}x{self.width}")
        for s in range(self.num_scales):
            layer = getattr(self, f"scale_{s}")
            small = _resize_complex(out, layer.height, layer.width)
            out = _resize_complex(layer(small), H, W)
        return out if batched else out[0]
