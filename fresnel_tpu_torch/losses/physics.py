"""Physics-grounded training losses.

Counterpart of fresnel_tpu/losses/physics.py:
* learnable wavelengths: clamp(softplus(raw), 0.01, 0.5), the raw init the
  inverse softplus of the HFGS defaults;
* phase retrieval: U = sqrt(I) * exp(i phi(depth)), compare |DFT(U)|;
* frequency-domain loss: radial low / high split at `cutoff`, high x
  weight;
* the Helmholtz wave-equation residual with a circular 5-point stencil;
* the scale- and shift-invariant depth L1.
`dft2` is `torch.fft.fft2` here, where the JAX package multiplies by DFT
matrices; both are the same transform in complex64 and differ by rounding
(the losses' parity tests state their tolerance).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from fresnel_tpu_torch.core.ops import fftfreq
from fresnel_tpu_torch.parallel.mesh import Shard, global_sum

HFGS_DEFAULT_WAVELENGTHS = (0.0635, 0.05, 0.041)  # R, G, B


def dft2(x: torch.Tensor) -> torch.Tensor:
    """2-D DFT over the last two axes, complex64."""
    return torch.fft.fft2(x.to(torch.complex64))


def constrain_learnable_wavelengths(raw: torch.Tensor) -> torch.Tensor:
    """Raw (3,) parameter -> physical wavelengths in [0.01, 0.5]."""
    return torch.clamp(F.softplus(raw), 0.01, 0.5)


def init_learnable_wavelengths(device=None) -> torch.Tensor:
    """Raw init such that softplus(raw) equals the HFGS defaults."""
    wl = torch.tensor(HFGS_DEFAULT_WAVELENGTHS, dtype=torch.float32,
                      device=device)
    return torch.log(torch.expm1(wl))


def phase_retrieval_loss(rendered: torch.Tensor, target: torch.Tensor,
                         depth: torch.Tensor, wavelength=0.05,
                         focal_depth: float = 0.5) -> torch.Tensor:
    """Frequency-magnitude consistency with the phase known from depth:
    phi = (2 pi / lambda) |depth - focal|.  rendered, target (B, 3, H, W),
    depth (B, H, W) (or with a unit channel axis)."""
    if depth.dim() == 4:
        depth = depth[:, 0] if depth.shape[1] == 1 else depth[..., 0]
    phase = (2.0 * math.pi / wavelength) * torch.abs(depth - focal_depth)
    e_iphi = torch.exp(1j * phase[:, None].to(torch.complex64))
    r_amp = torch.sqrt(torch.clamp(rendered, min=1e-8))
    t_amp = torch.sqrt(torch.clamp(target, min=1e-8))
    r_freq = dft2(r_amp * e_iphi)
    t_freq = dft2(t_amp * e_iphi)
    return ((r_freq.abs() - t_freq.abs()) ** 2).mean()


def _radial_masks(h: int, w: int, cutoff: float, device
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    # The grids in the jitted JAX function's bits (core.ops.fftfreq) and
    # the radius rounded once, so that no frequency changes sides of the
    # cutoff.
    u = fftfreq(w, device=device)
    v = fftfreq(h, device=device)
    V, U = torch.meshgrid(v, u, indexing="ij")
    radius = torch.sqrt((U * U + V * V).double()).float()
    low = (radius < cutoff).to(torch.float32)
    return low, 1.0 - low


def frequency_domain_loss(rendered: torch.Tensor, target: torch.Tensor,
                          cutoff: float = 0.1, high_weight: float = 2.0
                          ) -> torch.Tensor:
    H, W = rendered.shape[-2:]
    low, high = _radial_masks(H, W, cutoff, rendered.device)
    r_freq = dft2(rendered)
    t_freq = dft2(target)
    low_loss = (((r_freq * low).abs() - (t_freq * low).abs()) ** 2).mean()
    high_loss = (((r_freq * high).abs() - (t_freq * high).abs()) ** 2).mean()
    return low_loss + high_weight * high_loss


def wave_equation_loss(wave_field: torch.Tensor, wavelength: float,
                       pixel_spacing: float = 1.0 / 256.0) -> torch.Tensor:
    """Helmholtz residual mean((lap U + k^2 U)^2) with a circular 5-point
    Laplacian."""
    if wave_field.dim() == 3:
        wave_field = wave_field[:, None]
    k = 2.0 * math.pi / wavelength
    lap = (torch.roll(wave_field, 1, -1) + torch.roll(wave_field, -1, -1)
           + torch.roll(wave_field, 1, -2) + torch.roll(wave_field, -1, -2)
           - 4.0 * wave_field) / (pixel_spacing ** 2)
    return ((lap + (k * k) * wave_field) ** 2).mean()


def _batch_moments(x: torch.Tensor, shard: Optional[Shard]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and population std of `x` over the whole batch: every rank's
    rows under a data-parallel `shard` (two passes, each one
    differentiable all-reduce), `x` alone for None."""
    n = x.numel() * (1 if shard is None else shard.world)
    mean = global_sum(x.sum(), shard) / n
    var = global_sum(((x - mean) ** 2).sum(), shard) / n
    return mean, torch.sqrt(var)


def normalized_depth_l1(rendered_depth: torch.Tensor,
                        target_depth: torch.Tensor,
                        shard: Optional[Shard] = None) -> torch.Tensor:
    """Scale/shift-invariant depth L1: both depths standardised (population
    std, floored at 1e-4) before the comparison.  The mean and std are the
    whole batch's: under a data-parallel step (`shard`, from
    `parallel.mesh.step_shard`) every rank's; the L1 is this rank's mean,
    which the step averages over ranks."""
    rd_mean, rd_std = _batch_moments(rendered_depth, shard)
    td_mean, td_std = _batch_moments(target_depth, shard)
    rd = (rendered_depth - rd_mean) / torch.clamp(rd_std, min=1e-4)
    td = (target_depth - td_mean) / torch.clamp(td_std, min=1e-4)
    return (rd - td).abs().mean()
