"""Complex wave-field renderer: U = sum A e^{i phi}, I = |U|^2.

Counterpart of fresnel_tpu/render/wave.py::render_wave_field.  Every
Gaussian adds its complex amplitude to every pixel inside its 3-sigma box
(order-independent, no compositing): the amplitude exp(-m / 2) * opacity
times colour * (cos phi, sin phi) per RGB channel, with scalar or per-RGB
phases; the image is sqrt(|U|^2 + 1e-8) divided by its largest value (at
least 1), the background fills where the total amplitude is below 1, and
the depth is the amplitude-weighted mean depth.  The sums are the dense
splat (`render.splat`, WAVE mode: V = (cos phi c, sin phi c, depth, 1)):
K5 forward and K6 backward on CUDA tensors, the JAX package's chunked
scan as the plain version on CPU tensors; the tail is autograd.
`render_wave_field_batched` renders B clouds with one launch of each
kernel, each image normalised by its own largest value, as `jax.vmap` of
the JAX function.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from fresnel_tpu_torch.core.camera import Camera
from fresnel_tpu_torch.render import splat
from fresnel_tpu_torch.render.projection import (
    batch_cameras, project_gaussians)


def jclip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip: maximum then minimum, a tie's gradient split evenly (the
    normalised image's largest value sits exactly on the bound 1)."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def wave_inputs(positions, scales, rotations, colors, opacities,
                camera: Camera, phases: torch.Tensor,
                max_radius: float = 64.0):
    """One cloud's dense-splat inputs: params (N, 8) [mean, conic, radius,
    opacity (0 where invisible), 0] and V (N, 8) [cos(phi) rgb, sin(phi)
    rgb, depth, 1]; phases (N,) or (N, 3) in radians."""
    proj = project_gaussians(positions, scales, rotations, camera,
                             max_radius=max_radius)
    opac = torch.where(proj.visible, opacities, 0.0)
    N = positions.shape[0]
    ph = phases[:, None] if phases.dim() == 1 else phases
    ph = ph.expand(N, 3)
    zero = torch.zeros_like(opac)
    # The radius only gates the box test: it carries no gradient (a zero
    # cotangent into effective_radius's sqrt would be nan at isotropy).
    params = torch.stack([proj.means2d[:, 0], proj.means2d[:, 1],
                          proj.conic[:, 0], proj.conic[:, 1],
                          proj.conic[:, 2], proj.radii.detach(), opac, zero],
                         dim=-1)
    V = torch.cat([torch.cos(ph) * colors, torch.sin(ph) * colors,
                   proj.depths[:, None], torch.ones_like(opac)[:, None]],
                  dim=-1)
    return params, V


def wave_tail(acc: torch.Tensor, background=(0.0, 0.0, 0.0)
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W, 8) splat sums -> (images (B, 3, H, W), depth (B, H, W)),
    each image normalised by its own largest value."""
    wr, wi = acc[..., 0:3], acc[..., 3:6]
    acc_d, tot_w = acc[..., 6], acc[..., 7]
    bg = torch.tensor(background, dtype=acc.dtype, device=acc.device)
    intensity = wr * wr + wi * wi
    rendered = torch.sqrt(intensity + 1e-8)
    peak = torch.amax(rendered, dim=(1, 2, 3), keepdim=True)
    rendered = rendered / torch.maximum(peak, peak.new_tensor(1.0))
    rendered = jclip(rendered, 0.0, 1.0)
    total_amp = jclip(torch.sqrt(torch.sum(intensity, dim=-1, keepdim=True)
                                 + 1e-8), 0.0, 1.0)
    rendered = rendered + bg * (1.0 - total_amp)
    image = jclip(rendered.permute(0, 3, 1, 2), 0.0, 1.0)
    return image, acc_d / (tot_w + 1e-8)


def render_wave_field_batched(positions, scales, rotations, colors,
                              opacities, cameras, phases,
                              background=(0.0, 0.0, 0.0),
                              max_radius: float = 64.0
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B clouds (B, N, ...) with phases (B, N) or (B, N, 3) -> (images (B,
    3, H, W), depth (B, H, W)); `cameras` one Camera or a sequence of B of
    one size.  One K5 (and K6) launch for the batch on the card."""
    B = positions.shape[0]
    cams = batch_cameras(cameras, B)
    H, W = cams[0].height, cams[0].width
    ins = [wave_inputs(positions[b], scales[b], rotations[b], colors[b],
                       opacities[b], cams[b], phases[b], max_radius)
           for b in range(B)]
    acc = splat.dense_splat(torch.stack([p for p, _ in ins]),
                            torch.stack([v for _, v in ins]), H, W,
                            splat.WAVE)
    return wave_tail(acc, background)


def render_wave_field(positions, scales, rotations, colors, opacities,
                      camera: Camera, phases: torch.Tensor,
                      background=(0.0, 0.0, 0.0), return_depth: bool = False,
                      max_radius: float = 64.0):
    """Render one cloud to (3, H, W) [, depth (H, W)].  Requires phases
    (radians), (N,) or (N, 3)."""
    img, depth = render_wave_field_batched(
        positions[None], scales[None], rotations[None], colors[None],
        opacities[None], camera, phases[None], background, max_radius)
    return (img[0], depth[0]) if return_depth else img[0]
