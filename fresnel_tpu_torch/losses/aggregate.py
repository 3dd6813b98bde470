"""Loss aggregation for decoder training.

Counterpart of fresnel_tpu/losses/aggregate.py::compute_losses, term for
term and key for key: L1 RGB (optionally VLM-density weighted), 1 - SSIM,
LPIPS (with an `lpips_fn`, such as losses.lpips.LPIPS: both images
resized to 128^2 as jax.image.resize does, antialiased when shrinking,
and mapped to [-1, 1]), normalised depth L1, the residual regulariser,
the Fresnel boundary term, the Helmholtz residual, HFGS phase retrieval
and the frequency-domain loss.  Every value of the returned dict is a
tensor on the inputs' device (no host read).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from fresnel_tpu_torch.core.ops import resize_linear
from fresnel_tpu_torch.losses.physics import (
    constrain_learnable_wavelengths,
    frequency_domain_loss,
    normalized_depth_l1,
    phase_retrieval_loss,
    wave_equation_loss,
)
from fresnel_tpu_torch.losses.ssim import ssim
from fresnel_tpu_torch.physics.fresnel_zones import FresnelZones
from fresnel_tpu_torch.train.config import (
    HFGSConfig, PhysicsConfig, TrainingConfig)


def compute_losses(
    rendered: torch.Tensor,                       # (B, 3, H, W)
    target: torch.Tensor,                         # (B, 3, H, W)
    rendered_depth: Optional[torch.Tensor] = None,   # (B, H, W)
    target_depth: Optional[torch.Tensor] = None,     # (B, H, W)
    residuals: Optional[Dict[str, torch.Tensor]] = None,
    config: Optional[TrainingConfig] = None,
    lpips_fn=None,                        # callable(a, b) -> (B,)
    vlm_density: Optional[torch.Tensor] = None,   # (B, 1, h, w)
    physics_config: Optional[PhysicsConfig] = None,
    hfgs_config: Optional[HFGSConfig] = None,
    learnable_wavelengths_raw: Optional[torch.Tensor] = None,   # raw (3,)
    fresnel_zones: Optional[FresnelZones] = None,
    boundary_emphasis: Optional[torch.Tensor] = None,  # (num_zones + 1,)
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    config = config or TrainingConfig()
    loss_dict: Dict[str, torch.Tensor] = {}

    if (vlm_density is not None and config.use_vlm_guidance
            and config.vlm_weight > 0):
        pixel_loss = (rendered - target).abs()
        dens = vlm_density.detach()
        if dens.shape[-2:] != rendered.shape[-2:]:
            dens = resize_linear(dens, *rendered.shape[-2:])
        weight = (1.0 - config.vlm_weight) + config.vlm_weight * dens
        rgb_loss = (pixel_loss * weight).mean()
    else:
        rgb_loss = (rendered - target).abs().mean()
    loss_dict["rgb"] = rgb_loss
    total = config.rgb_weight * rgb_loss

    rendered_c = torch.clamp(rendered, 0.0, 1.0)

    if config.ssim_weight > 0:
        ssim_l = 1.0 - ssim(rendered_c, target, data_range=1.0)
        loss_dict["ssim"] = ssim_l
        total = total + config.ssim_weight * ssim_l

    if lpips_fn is not None and config.lpips_weight > 0:
        r128 = resize_linear(rendered_c, 128, 128) * 2 - 1
        t128 = resize_linear(target, 128, 128) * 2 - 1
        lp = lpips_fn(r128, t128).mean()
        loss_dict["lpips"] = lp
        total = total + config.lpips_weight * lp

    if (rendered_depth is not None and target_depth is not None
            and config.depth_weight > 0):
        d_l = normalized_depth_l1(rendered_depth, target_depth)
        loss_dict["depth"] = d_l
        total = total + config.depth_weight * d_l

    if residuals is not None:
        reg = 0.0
        for key in ("pos_delta", "scale_delta", "color_delta",
                    "opacity_delta"):
            if key in residuals:
                reg = reg + residuals[key].abs().mean()
        loss_dict["residual"] = reg
        total = total + config.residual_weight * reg

    if (fresnel_zones is not None and config.boundary_weight > 0
            and target_depth is not None):
        bm = fresnel_zones.boundary_mask(target_depth,
                                         emphasis=boundary_emphasis)
        pixel_loss = (rendered - target).abs().mean(dim=1)
        b_l = (pixel_loss * bm).mean()
        loss_dict["boundary"] = b_l
        total = total + config.boundary_weight * b_l

    if physics_config is not None and physics_config.wave_equation_weight > 0:
        w_l = wave_equation_loss(rendered, physics_config.wavelength,
                                 pixel_spacing=1.0 / config.image_size)
        loss_dict["wave_eq"] = w_l
        total = total + physics_config.wave_equation_weight * w_l

    if hfgs_config is not None:
        wavelength = hfgs_config.wavelength_g
        if learnable_wavelengths_raw is not None:
            wavelength = constrain_learnable_wavelengths(
                learnable_wavelengths_raw)[1]    # green reference channel
        if hfgs_config.use_phase_retrieval_loss and target_depth is not None:
            pr = phase_retrieval_loss(
                rendered, target, target_depth, wavelength=wavelength,
                focal_depth=hfgs_config.focal_depth)
            loss_dict["phase_retrieval"] = pr
            total = total + hfgs_config.phase_retrieval_weight * pr
        if hfgs_config.use_frequency_loss:
            fq = frequency_domain_loss(
                rendered, target, cutoff=hfgs_config.frequency_cutoff,
                high_weight=hfgs_config.high_freq_weight)
            loss_dict["frequency"] = fq
            total = total + hfgs_config.frequency_loss_weight * fq

    loss_dict["total"] = total
    return total, loss_dict
