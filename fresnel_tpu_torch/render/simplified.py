"""Simplified isotropic point-splat renderer for quick tests.

Counterpart of fresnel_tpu/render/simplified.py::render_simplified:
`camera.project` (not `project_gaussians`) with visibility depth > 0,
isotropic radii clip(mean(scale) fx / max(depth, 1e-6), 1, 20), weights
exp(-d^2 / (2 sigma^2)) with sigma = max(r / 2, 1) inside the square
|dx|, |dy| <= r + 1, alpha = clip(w opacity, 0, 1), front to back in a
stable depth order (invisible Gaussians last), the background blended
with the final transmittance; the depth map is the least depth where
alpha > 0.1, 0 where none passes.  The compositing is
`render.dense_composite` in SIMPLE mode: K7 forward and K8 backward on
CUDA tensors, the JAX package's chunked scan as the plain version on CPU
tensors; the rest is autograd.
"""

from __future__ import annotations

from typing import Tuple

import torch

from fresnel_tpu_torch.core.camera import Camera
from fresnel_tpu_torch.render import dense_composite as dc
from fresnel_tpu_torch.render.wave import jclip


def simplified_inputs(positions, scales, colors, opacities, camera: Camera
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The compositing inputs in depth order: params (N, 8) [mean, sigma,
    0, 0, radius (no gradient), opacity (0 where invisible), depth] and
    the colours (N, 3)."""
    means2d, depths = camera.project(positions)
    visible = depths > 0
    # XLA takes jnp.mean's division by 3 as a product with its reciprocal.
    third = torch.tensor(1.0 / 3.0, dtype=scales.dtype, device=scales.device)
    radius = jclip(torch.sum(scales, dim=-1) * third * camera.fx
                   / torch.maximum(depths, depths.new_tensor(1e-6)),
                   1.0, 20.0)
    opac = torch.where(visible, opacities, 0.0)
    key = torch.where(visible, depths, torch.full_like(depths, float("inf")))
    order = torch.argsort(key, stable=True)
    radius = radius[order]
    sig = torch.maximum(radius / 2.0, radius.new_tensor(1.0))
    zero = torch.zeros_like(radius)
    params = torch.stack([means2d[order, 0], means2d[order, 1], sig, zero,
                          zero, radius.detach(), opac[order], depths[order]],
                         dim=-1)
    return params, colors[order]


def render_simplified(positions, scales, rotations, colors, opacities,
                      camera: Camera, background=(0.0, 0.0, 0.0),
                      return_depth: bool = False, chunk: int = 128):
    """Render one cloud to (3, H, W) in [0, 1] [, depth (H, W)].
    `rotations` is unused (isotropic), kept for the common signature;
    `chunk` is the JAX scan's step, which sets the plain version's
    rounding and how a least depth shared by several Gaussians splits its
    gradient among them."""
    H, W = camera.height, camera.width
    params, cols = simplified_inputs(positions, scales, colors, opacities,
                                     camera)
    out, T = dc.dense_composite(params, cols, H, W, dc.SIMPLE, chunk)
    bg = torch.tensor(background, dtype=out.dtype, device=out.device)
    image = jclip((out[..., :3] + T[..., None] * bg).permute(2, 0, 1),
                  0.0, 1.0)
    if return_depth:
        min_d = out[..., 3]
        return image, torch.where(torch.isinf(min_d), 0.0, min_d)
    return image
