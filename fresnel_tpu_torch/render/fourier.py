"""The HFGS Fourier renderer, in both its modes.

Counterpart of fresnel_tpu/render/fourier.py::render_fourier.

Mode "spatial" (the default, the reference renderer's behaviour):
isotropic additive splats (sigma from the trace of each 2-D covariance,
no box), visibility with a loose margin of one image size, the image
divided by its largest value (when above 1e-8), the background where the
channels' sum is below 1, and depth returned as zeros.  The splat is
`render.splat`'s ISO mode: K5 forward and K6 backward on CUDA tensors, the
JAX package's chunked scan as the plain version on CPU tensors.
`render_fourier_batched` renders B clouds with one launch of each kernel,
each image normalised by its own largest value, as `jax.vmap` of the JAX
function (the spatial mode, the one a training route selects).

Mode "fourier" (`make_renderer("fourier_true")`): every Gaussian is
synthesised in the frequency domain, 2 pi sigma^2 exp(-2 pi^2 sigma^2
(u^2 + v^2)) exp(-2 pi i (u x0 + v y0)) times opacity * colour *
exp(i phi_c), and one inverse FFT per channel (times H W) gives the field;
the image is |field| divided by max(max, 1e-8), with the background where
the channels' sum is below 1.  Phases default to (2 pi / lambda_g) |depth
- focal| and scale per channel by lambda_g / lambda_c; the wavelengths
default to HFGS_WAVELENGTHS.  The JAX package sums the synthesis over
chunks of (64, H, W); here it is written in its separable form: the
Gaussian's spectrum factors into a (v, y0) factor times a (u, x0) factor,
so each channel's spectrum is one complex (H x N) (N x W) matrix product,
`torch.matmul` (cuBLAS on the card; TF32 must be off for parity, as in
every parity run).  The factors are formed in float64, where the phase
u x0 (up to ~1.6e3 rad at 512^2) is reduced exactly before its cos /
sin, then rounded to complex64: closer to the exact synthesis than the
JAX scan, which rounds u x0 + v y0 in float32, and nothing of size
(N, H, W) is kept for the backward.
"""

from __future__ import annotations

from typing import Tuple

import torch

from fresnel_tpu_torch.core.camera import Camera
from fresnel_tpu_torch.core.ops import fftfreq
from fresnel_tpu_torch.physics.fresnel_zones import sqrt_rn
from fresnel_tpu_torch.render import splat
from fresnel_tpu_torch.render.projection import (
    batch_cameras, project_gaussians)
from fresnel_tpu_torch.render.wave import jclip

TWO_PI = 6.283185307179586
HFGS_WAVELENGTHS = (0.0635, 0.05, 0.041)


def _check_mode(mode: str) -> None:
    if mode not in ("spatial", "fourier"):
        raise ValueError(f"unknown mode {mode!r}")


def _spectral_factor(freq: torch.Tensor, center: torch.Tensor,
                     s2: torch.Tensor) -> torch.Tensor:
    """(N, n) complex128 exp(-2 pi^2 s2 f^2) exp(-2 pi i f c) of the
    float32 frequencies `freq` (n,) and the Gaussians' centres (N,) and
    float64 variances s2 (N,): f c is exact in float64 and reduced mod 1
    before its cos / sin."""
    f = freq.double()[None, :]
    turns = torch.remainder(center.double()[:, None] * f, 1.0)
    decay = torch.exp(-2.0 * (torch.pi ** 2) * s2[:, None] * f * f)
    ang = -TWO_PI * turns
    return torch.complex(decay * torch.cos(ang), decay * torch.sin(ang))


def render_fourier_true(positions, scales, rotations, colors, opacities,
                        camera: Camera, phases=None, wavelengths=None,
                        background=(0.0, 0.0, 0.0),
                        return_depth: bool = False,
                        focal_depth: float = 0.5):
    """Mode "fourier" of one cloud: (3, H, W) [, depth (H, W) of zeros].
    float64 inputs evaluate the same formula in double precision on the
    same float32 frequency grids (complex128)."""
    H, W = camera.height, camera.width
    dev, dt = positions.device, positions.dtype
    ct = torch.complex64 if dt == torch.float32 else torch.complex128
    wls = (torch.tensor(HFGS_WAVELENGTHS, dtype=torch.float32,
                        device=dev).to(dt)
           if wavelengths is None
           else torch.as_tensor(wavelengths, dtype=dt, device=dev))
    proj = project_gaussians(positions, scales, rotations, camera,
                             visibility_margin=float(max(H, W)))
    opac = torch.where(proj.visible, opacities, 0.0)
    a = proj.cov2d[:, 0, 0]
    d = proj.cov2d[:, 1, 1]
    sigma = sqrt_rn((a + d) / 2.0 + 1e-8)
    if phases is None:
        phases = (wls.new_tensor(TWO_PI) / wls[1]) \
            * torch.abs(proj.depths - focal_depth)
    s2 = sigma.double() ** 2
    A = _spectral_factor(fftfreq(H, device=dev), proj.means2d[:, 1], s2)
    B = _spectral_factor(fftfreq(W, device=dev), proj.means2d[:, 0], s2) \
        * (TWO_PI * s2)[:, None]
    phc = phases[:, None] * (wls[1] / wls)[None, :]             # (N, 3)
    amp = (opac[:, None] * colors) * torch.polar(torch.ones_like(phc), phc)
    A = A.to(ct)
    B = B.to(ct)
    freq = torch.matmul(A.t()[None] * amp.t()[:, None, :], B)  # (3, H, W)
    field = torch.fft.ifft2(freq) * (H * W)
    intensity = torch.abs(field)
    image = intensity / torch.maximum(torch.amax(intensity),
                                      intensity.new_tensor(1e-8))
    total = torch.sum(image, dim=0, keepdim=True)
    bg = torch.tensor(background, dtype=dt, device=dev)
    image = jclip(image + bg[:, None, None] * jclip(1.0 - total, 0.0, 1.0),
                  0.0, 1.0)
    if return_depth:
        return image, torch.zeros((H, W), dtype=dt, device=dev)
    return image


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
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B clouds (B, N, ...) -> (images (B, 3, H, W), depth (B, H, W) of
    zeros) in the spatial mode; `cameras` one Camera or a sequence of B of
    one size.  One K5 (and K6) launch for the batch on the card."""
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
                   camera: Camera, phases=None, wavelengths=None,
                   background=(0.0, 0.0, 0.0), return_depth: bool = False,
                   mode: str = "spatial", chunk: int = 64,
                   focal_depth: float = 0.5):
    """Render one cloud to (3, H, W) [, depth (H, W) of zeros].  The
    spatial mode reads neither `phases` (which the renderers' common
    signature carries) nor `wavelengths`; `chunk` is the JAX scans' step,
    kept for the signature."""
    _check_mode(mode)
    if mode == "fourier":
        return render_fourier_true(positions, scales, rotations, colors,
                                   opacities, camera, phases, wavelengths,
                                   background, return_depth, focal_depth)
    img, depth = render_fourier_batched(
        positions[None], scales[None], rotations[None], colors[None],
        opacities[None], camera, background)
    return (img[0], depth[0]) if return_depth else img[0]
