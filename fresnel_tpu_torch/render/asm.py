"""Angular Spectrum Method propagation and the plane-binned wave renderer.

Counterpart of fresnel_tpu/render/asm.py:
  * `AngularSpectrumPropagator`: H(f) = exp(i 2 pi z sqrt(1 / lambda^2 -
    fx^2 - fy^2)), evanescent frequencies band-limited to kz = 0, over
    the frequency grids of `fftfreq(n, d=pixel_pitch)`; the transfer
    function broadcasts over leading dimensions of z and lambda, and
    `propagate` is ifft2(fft2(field) H) through torch.fft (cuFFT on the
    card, as XLA's FFT is the JAX package's).
  * `render_asm_wave_field`: each Gaussian is assigned to the nearest of
    16 depth planes (linspace(0.1, 2.0), ties to the lower plane), splatted
    as a complex amplitude onto its plane inside its 3-sigma box, every
    plane is propagated to the focal depth per RGB wavelength by one
    batched FFT over (planes, 3, H, W), the fields are summed and the
    image is sqrt(|U|^2 + 1e-8) normalised by max(max, 1), with the
    background where the channels' summed |U| is below 1.
The per-plane splats are the dense splat in WAVE mode (`render.splat`:
K5 forward and K6 backward on CUDA tensors, the JAX scan as the plain
version on CPU tensors), one launch for the planes as a batch of P
images.  Each plane holds only its own Gaussians, packed (P, n_max, 8)
with a sentinel row (opacity 0, no box, far off the image) in the spare
slots: K5 skips opacity 0 but K6 walks every Gaussian's window, so
zeroing the opacity off-plane in P copies of the cloud would cost K6 P x
the work.

The frequency grids and the planes are core/ops.py's `fftfreq` and
`linspace`, in the bits the jitted JAX functions give them; sqrt goes
through float64, which rounds it correctly.  The transfer function's phases reach ~240 rad at
the default sizes, where XLA:CPU's float32 cos / sin is ~3e-5 from the
correctly rounded value and torch's is not: the tests bound the port by
JAX's own distance from a float64 evaluation.  Differentiating with
respect to the wavelengths gives NaN where a frequency is evanescent, as
jax.grad does: sqrt's infinite derivative at the band limit times the
band limit's zero (ROADMAP Queue 3, reference behaviours).
"""

from __future__ import annotations

import dataclasses

import torch

from fresnel_tpu_torch.core.camera import Camera
from fresnel_tpu_torch.core.ops import fftfreq, linspace
from fresnel_tpu_torch.physics.fresnel_zones import sqrt_rn
from fresnel_tpu_torch.render import splat
from fresnel_tpu_torch.render.projection import project_gaussians
from fresnel_tpu_torch.render.wave import jclip

TWO_PI = 6.283185307179586


class _BandLimit(torch.autograd.Function):
    """max(x, 0), its gradient a product with jnp.maximum's factor (1, 0.5
    at a tie, 0), so that an infinite cotangent becomes NaN as in jax.grad
    (torch.maximum masks it to 0)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.clamp(x, min=0.0)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.where(x > 0, 1.0, torch.where(x == 0, 0.5, 0.0)
                               ).to(g.dtype)


@dataclasses.dataclass(frozen=True)
class AngularSpectrumPropagator:
    height: int
    width: int
    pixel_pitch: float = 1.0 / 256.0
    wavelength: float = 0.05
    band_limit: bool = True

    def _freq_grids(self, device=None, dtype=torch.float32):
        fx = fftfreq(self.width, self.pixel_pitch, device).to(dtype)
        fy = fftfreq(self.height, self.pixel_pitch, device).to(dtype)
        FY, FX = torch.meshgrid(fy, fx, indexing="ij")
        return FX, FY

    def transfer_function(self, z_distance, wavelength=None, device=None,
                          dtype=torch.float32) -> torch.Tensor:
        """(H, W) complex64 transfer function for propagation distance z.
        Broadcasts over leading dims of z_distance / wavelength.  `dtype`
        float64 evaluates the same formula in double precision (complex128)
        on the float32 grids."""
        wl = self.wavelength if wavelength is None else wavelength
        if device is None:
            device = next((t.device for t in (wl, z_distance)
                           if torch.is_tensor(t)), None)
        wl = torch.as_tensor(wl, dtype=dtype, device=device)
        z = torch.as_tensor(z_distance, dtype=dtype, device=device)
        FX, FY = self._freq_grids(device, dtype)
        inv = torch.ones_like(wl) / (wl * wl)   # one rounding, as XLA
        kz_sq = (inv[..., None, None] if wl.dim() else inv) - FX * FX \
            - FY * FY
        if self.band_limit:
            kz_sq = _BandLimit.apply(kz_sq)
        kz = sqrt_rn(kz_sq)
        zz = TWO_PI * z
        phase = (zz[..., None, None] if z.dim() else zz) * kz
        return torch.polar(torch.ones_like(phase), phase)

    def propagate(self, field: torch.Tensor, z_distance, wavelength=None
                  ) -> torch.Tensor:
        """Propagate a complex field (..., H, W) by z via FFT."""
        H_tf = self.transfer_function(z_distance, wavelength, field.device,
                                      field.real.dtype)
        return torch.fft.ifft2(torch.fft.fft2(field) * H_tf)

    def __call__(self, field, z_distance, wavelength=None):
        return self.propagate(field, z_distance, wavelength)


def _plane_pack(params: torch.Tensor, V: torch.Tensor,
                plane_idx: torch.Tensor, P: int):
    """(P, n_max, 8) params and (P, n_max, 8) values: each plane's
    Gaussians in index order, the spare slots a sentinel (opacity 0, a
    radius of -1 far off the image)."""
    N = params.shape[0]
    dev = params.device
    order = torch.argsort(plane_idx, stable=True)
    counts = torch.bincount(plane_idx, minlength=P)
    n_max = max(1, int(counts.max().item())) if N else 1
    start = torch.cumsum(counts, 0) - counts
    sorted_plane = plane_idx[order]
    slot = torch.arange(N, device=dev) - start[sorted_plane]
    idx = torch.full((P, n_max), N, dtype=torch.long, device=dev)
    idx[sorted_plane, slot] = order
    sentinel = torch.zeros((1, splat.NP), dtype=params.dtype, device=dev)
    sentinel[0, 0:2] = -1e6
    sentinel[0, 5] = -1.0
    params_ext = torch.cat([params, sentinel])
    V_ext = torch.cat([V, torch.zeros_like(V[:1])])
    # index_select: its backward is one index_add (each Gaussian sits in
    # one slot), where advanced indexing's sorts its indices first.
    flat = idx.reshape(-1)
    return (params_ext.index_select(0, flat).view(P, n_max, -1),
            V_ext.index_select(0, flat).view(P, n_max, -1))


def render_asm_wave_field(positions, scales, rotations, colors, opacities,
                          camera: Camera, phases: torch.Tensor,
                          wavelengths_rgb=None, background=(0.0, 0.0, 0.0),
                          return_depth: bool = False,
                          max_radius: float = 64.0, chunk: int = 64,
                          num_depth_planes: int = 16,
                          depth_range=(0.1, 2.0), focal_depth: float = 0.5,
                          pixel_pitch: float = 1.0 / 256.0,
                          wavelength: float = 0.05):
    """Render one cloud to (3, H, W) [, depth (H, W) of zeros].  Requires
    phases (N,) in radians.  `chunk` is the JAX scan's step, kept for the
    signature: it changes nothing here.  float64 inputs evaluate the same
    formula in double precision on the same float32 planes and grids."""
    H, W = camera.height, camera.width
    P = num_depth_planes
    dev, dt = positions.device, positions.dtype
    proj = project_gaussians(positions, scales, rotations, camera,
                             max_radius=max_radius)
    opac = torch.where(proj.visible, opacities, 0.0)
    planes = linspace(depth_range[0], depth_range[1], P, dev).to(dt)
    plane_idx = torch.argmin(torch.abs(proj.depths[:, None] - planes[None]),
                             dim=1)
    zero = torch.zeros_like(opac)
    # The radius only gates the box test: it carries no gradient.
    params = torch.stack([proj.means2d[:, 0], proj.means2d[:, 1],
                          proj.conic[:, 0], proj.conic[:, 1],
                          proj.conic[:, 2], proj.radii.detach(), opac, zero],
                         dim=-1)
    V = torch.cat([torch.cos(phases)[:, None] * colors,
                   torch.sin(phases)[:, None] * colors,
                   zero[:, None], zero[:, None]], dim=-1)
    pp, pv = _plane_pack(params, V, plane_idx, P)
    acc = splat.dense_splat(pp, pv, H, W, splat.WAVE)       # (P, H, W, 8)
    field = torch.complex(acc[..., 0:3], acc[..., 3:6]).permute(0, 3, 1, 2)

    prop = AngularSpectrumPropagator(H, W, pixel_pitch, wavelength)
    wls = (torch.full((3,), wavelength, dtype=torch.float32,
                      device=dev).to(dt)
           if wavelengths_rgb is None
           else torch.as_tensor(wavelengths_rgb, dtype=dt, device=dev))
    z_prop = focal_depth - planes
    H_tf = prop.transfer_function(z_prop[:, None].expand(P, 3),
                                  wls[None, :].expand(P, 3), dev, dt)
    total = torch.sum(torch.fft.ifft2(torch.fft.fft2(field) * H_tf), dim=0)

    intensity = total.real ** 2 + total.imag ** 2
    rendered = torch.sqrt(intensity + 1e-8)
    rendered = rendered / torch.maximum(torch.amax(rendered),
                                        rendered.new_tensor(1.0))
    rendered = jclip(rendered, 0.0, 1.0)
    total_amp = jclip(torch.sum(torch.abs(total), dim=0, keepdim=True),
                      0.0, 1.0)
    bg = torch.tensor(background, dtype=dt, device=dev)
    image = jclip(rendered + bg[:, None, None] * (1.0 - total_amp), 0.0, 1.0)
    if return_depth:
        return image, torch.zeros((H, W), dtype=dt, device=dev)
    return image
