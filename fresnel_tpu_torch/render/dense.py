"""Dense golden-reference renderer.

Counterpart of fresnel_tpu/render/dense.py::render_dense: every visible
Gaussian at every pixel, composited front to back in depth order, with a
loose 100 px screen margin for visibility, no 3-sigma box and no alpha
threshold, alpha clamped at 0.99, the background blended with the final
transmittance and the image clipped to [0, 1]; `return_depth` adds the
unnormalised sum of w * depth.  The compositing is
`render.dense_composite` in DENSE mode: K7 forward and K8 backward on
CUDA tensors, the JAX package's chunked scan as the plain version on CPU
tensors; projection, the sort and the tail are autograd.
"""

from __future__ import annotations

from typing import Tuple

import torch

from fresnel_tpu_torch.core.camera import Camera
from fresnel_tpu_torch.render import dense_composite as dc
from fresnel_tpu_torch.render.projection import (
    depth_sort_indices, project_gaussians)
from fresnel_tpu_torch.render.wave import jclip

ALPHA_MAX = dc.ALPHA_MAX[dc.DENSE]


def dense_inputs(positions, scales, rotations, colors, opacities,
                 camera: Camera) -> Tuple[torch.Tensor, torch.Tensor]:
    """The compositing inputs in depth order: params (N, 8) [mean, conic,
    0, opacity (0 where invisible), depth] and the colours (N, 3)."""
    proj = project_gaussians(positions, scales, rotations, camera,
                             visibility_margin=100.0)
    order = depth_sort_indices(proj)
    visible = proj.visible[order]
    opac = torch.where(visible, opacities[order], 0.0)
    params = torch.cat([proj.means2d[order], proj.conic[order],
                        torch.zeros_like(opac)[:, None], opac[:, None],
                        proj.depths[order][:, None]], dim=-1)
    return params, colors[order]


def render_dense(positions, scales, rotations, colors, opacities,
                 camera: Camera, background=(0.0, 0.0, 0.0),
                 return_depth: bool = False, chunk: int = 256):
    """Render one cloud to (3, H, W) in [0, 1] [, depth (H, W)].  `chunk`
    is the plain version's step (the JAX scan's), which changes only its
    rounding."""
    H, W = camera.height, camera.width
    params, cols = dense_inputs(positions, scales, rotations, colors,
                                opacities, camera)
    out, T = dc.dense_composite(params, cols, H, W, dc.DENSE, chunk)
    bg = torch.tensor(background, dtype=out.dtype, device=out.device)
    acc_color = out[..., :3] + T[..., None] * bg
    image = jclip(acc_color.permute(2, 0, 1), 0.0, 1.0)
    if return_depth:
        return image, out[..., 3]
    return image
