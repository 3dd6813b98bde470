"""The HFGS Fourier renderer, in its spatial mode.

Counterpart of fresnel_tpu/render/fourier.py::render_fourier with
mode="spatial", the reference renderer's behaviour: isotropic additive
splats (sigma from the trace of each 2-D covariance, no box), visibility
with a loose margin of one image size, the image divided by its largest
value (when above 1e-8), the background where the channels' sum is below
1, and depth returned as zeros.  The splat is `render.splat`'s ISO mode:
K5 forward and K6 backward on CUDA tensors, the JAX package's chunked scan
as the plain version on CPU tensors.  `render_fourier_batched` renders B
clouds with one launch of each kernel, each image normalised by its own
largest value, as `jax.vmap` of the JAX function.  Mode "fourier" (true
frequency-domain synthesis, which only `make_renderer("fourier_true")`
selects) raises NotImplementedError (ROADMAP Queue 1, item 5).
"""

from __future__ import annotations

from typing import Tuple

import torch

from fresnel_tpu_torch.core.camera import Camera
from fresnel_tpu_torch.render import splat
from fresnel_tpu_torch.render.projection import (
    batch_cameras, project_gaussians)
from fresnel_tpu_torch.render.wave import jclip

def _check_mode(mode: str) -> None:
    if mode == "fourier":
        raise NotImplementedError(
            "render_fourier mode 'fourier' (frequency-domain synthesis) is "
            "not ported (ROADMAP Queue 1, item 5)")
    if mode != "spatial":
        raise ValueError(f"unknown mode {mode!r}")


def fourier_inputs(positions, scales, rotations, colors, opacities,
                   camera: Camera):
    """One cloud's dense-splat inputs: params (N, 8) [mean, sigma, 0, 0,
    0, opacity (0 where invisible), 0] and V, the colours."""
    H, W = camera.height, camera.width
    proj = project_gaussians(positions, scales, rotations, camera,
                             visibility_margin=float(max(H, W)))
    opac = torch.where(proj.visible, opacities, 0.0)
    a = proj.cov2d[:, 0, 0]
    d = proj.cov2d[:, 1, 1]
    sigma = torch.sqrt((a + d) / 2.0 + 1e-8)
    zero = torch.zeros_like(opac)
    params = torch.stack([proj.means2d[:, 0], proj.means2d[:, 1], sigma,
                          zero, zero, zero, opac, zero], dim=-1)
    return params, colors


def fourier_tail(acc: torch.Tensor, background=(0.0, 0.0, 0.0)
                 ) -> torch.Tensor:
    """(B, H, W, 3) splat sums -> images (B, 3, H, W), each divided by its
    own largest value."""
    image = acc.permute(0, 3, 1, 2)
    bg = torch.tensor(background, dtype=acc.dtype, device=acc.device)
    max_val = torch.amax(image, dim=(1, 2, 3), keepdim=True)
    image = torch.where(max_val > 1e-8, image / max_val, image)
    total = torch.sum(image, dim=1, keepdim=True)
    image = image + bg[:, None, None] * jclip(1.0 - total, 0.0, 1.0)
    return jclip(image, 0.0, 1.0)


def render_fourier_batched(positions, scales, rotations, colors, opacities,
                           cameras, background=(0.0, 0.0, 0.0),
                           mode: str = "spatial"
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B clouds (B, N, ...) -> (images (B, 3, H, W), depth (B, H, W) of
    zeros); `cameras` one Camera or a sequence of B of one size.  One K5
    (and K6) launch for the batch on the card."""
    _check_mode(mode)
    B = positions.shape[0]
    cams = batch_cameras(cameras, B)
    H, W = cams[0].height, cams[0].width
    ins = [fourier_inputs(positions[b], scales[b], rotations[b], colors[b],
                          opacities[b], cams[b]) for b in range(B)]
    acc = splat.dense_splat(torch.stack([p for p, _ in ins]),
                            torch.stack([v for _, v in ins]), H, W,
                            splat.ISO)
    depth = torch.zeros((B, H, W), dtype=acc.dtype, device=acc.device)
    return fourier_tail(acc, background), depth


def render_fourier(positions, scales, rotations, colors, opacities,
                   camera: Camera, phases=None,
                   background=(0.0, 0.0, 0.0), return_depth: bool = False,
                   mode: str = "spatial"):
    """Render one cloud to (3, H, W) [, depth (H, W) of zeros].  The
    spatial mode does not read `phases`, which the renderers' common
    signature carries."""
    img, depth = render_fourier_batched(
        positions[None], scales[None], rotations[None], colors[None],
        opacities[None], camera, background, mode)
    return (img[0], depth[0]) if return_depth else img[0]
