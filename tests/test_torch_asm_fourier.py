"""Port parity: the angular-spectrum propagator and renderer and the
Fourier renderer's frequency-domain mode ("fourier_true") against the JAX
package on the CPU.

* The frequency grids (`fftfreq`, d = 1 and the ASM pixel pitch) and the
  16 depth planes (`linspace(0.1, 2.0)`) equal the jitted JAX functions'
  bit for bit: one ulp of a plane moves a Gaussian to another plane.
* `AngularSpectrumPropagator`: the transfer function is exactly 1 at
  z = 0; at other distances, broadcast over (P, 3) distances and
  wavelengths, and through `propagate`, within 1e-5 (of the largest
  magnitude) of JAX's.
* `render_asm_wave_field` with a scalar and with per-RGB wavelengths, and
  `render_fourier(mode="fourier")` with and without phases and
  wavelengths.  The bound is JAX's own distance from a float64 numpy
  evaluation of the JAX formula (the image) or from the port's float64
  evaluation (the gradients of a seeded weighted sum of the image with
  respect to all inputs): the port's float32 within 2 x that distance
  (floored at 1e-6) of the same float64 evaluation, and within 3 x of
  JAX's float32.  Measured: ASM images ~2e-6 and gradients ~5e-6 from
  float64 on both sides (~7e-7 apart); fourier_true with phases given,
  JAX 1.3e-6 / 8e-6, the port 7e-7 / 2.3e-6 (its separable synthesis
  never rounds u x0 + v y0 in float32); with the phases computed from the
  depth, both ~1.6e-5 / 3-8e-5 off, the float32 phase (2 pi / lambda)
  |depth - focal|, up to ~10^2 rad, setting it.
* The wavelengths' gradient through the band limit is NaN where a
  frequency is evanescent, as jax.grad gives it (ROADMAP Queue 3).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fresnel_tpu.core.camera import Camera as JCamera
from fresnel_tpu.render import asm as jasm
from fresnel_tpu.render.fourier import HFGS_WAVELENGTHS
from fresnel_tpu.render.fourier import render_fourier as jfourier

from fresnel_tpu_torch.core import ops
from fresnel_tpu_torch.core.camera import Camera as TCamera
from fresnel_tpu_torch.render import asm as tasm
from fresnel_tpu_torch.render.factory import make_renderer
from fresnel_tpu_torch.render.fourier import render_fourier
from test_torch_threads import _few_threads  # noqa: F401

TOL = 1e-5
F64_FACTOR, JAX_FACTOR, FLOOR = 2.0, 3.0, 1e-6
S = 48
PITCH = 1.0 / 256.0
RGB = np.array([0.055, 0.05, 0.045], np.float32)


def _rel(got, want):
    want = np.asarray(want, np.complex128)
    return float(np.abs(np.asarray(got, np.complex128) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _cloud(seed, n=200):
    rng = np.random.default_rng(seed)
    pos = np.c_[rng.uniform(-0.8, 0.8, (n, 2)),
                rng.uniform(-2.5, -1.5, n)].astype(np.float32)
    sc = rng.uniform(0.02, 0.12, (n, 3)).astype(np.float32)
    rot = rng.normal(size=(n, 4)).astype(np.float32)
    rot /= np.linalg.norm(rot, axis=1, keepdims=True)
    col = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    op = rng.uniform(0.1, 0.9, n).astype(np.float32)
    ph = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
    return [pos, sc, rot, col, op], ph


@pytest.mark.parametrize("n", [48, 64, 96, 100])
@pytest.mark.parametrize("d", [1.0, PITCH])
def test_fftfreq_bits_match_jit(n, d):
    want = np.asarray(jax.jit(lambda: jnp.fft.fftfreq(n, d=d))())
    got = ops.fftfreq(n, d).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("P", [16, 8, 5, 32])
def test_depth_plane_bits_match_jit(P):
    want = np.asarray(jax.jit(lambda: jnp.linspace(0.1, 2.0, P))())
    got = ops.linspace(0.1, 2.0, P).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_transfer_function_matches_jax():
    jprop = jasm.AngularSpectrumPropagator(S, 64, PITCH, 0.05)
    tprop = tasm.AngularSpectrumPropagator(S, 64, PITCH, 0.05)
    one = tprop.transfer_function(0.0)
    assert one.dtype == torch.complex64 and one.shape == (S, 64)
    assert torch.equal(one, torch.ones_like(one))
    assert np.all(np.asarray(jprop.transfer_function(0.0)) == 1)
    z = np.linspace(-1.9, 0.4, 6).astype(np.float32)[:, None].repeat(3, 1)
    wl = np.broadcast_to(RGB, (6, 3)).copy()
    want = np.asarray(jprop.transfer_function(jnp.asarray(z),
                                              jnp.asarray(wl)))
    got = tprop.transfer_function(torch.from_numpy(z), torch.from_numpy(wl))
    assert got.shape == (6, 3, S, 64)
    assert _rel(got.numpy(), want) <= TOL
    rng = np.random.default_rng(0)
    field = (rng.normal(size=(2, 3, S, 64))
             + 1j * rng.normal(size=(2, 3, S, 64))).astype(np.complex64)
    want = np.asarray(jprop.propagate(jnp.asarray(field), 0.7))
    got = tprop.propagate(torch.from_numpy(field), 0.7)
    assert _rel(got.numpy(), want) <= TOL
    assert torch.allclose(tprop(torch.from_numpy(field), 0.0),
                          torch.from_numpy(field), atol=1e-5)


def _asm_f64(arrays, ph, wls, size=S, P=16, focal=0.5):
    """The JAX formula of render_asm_wave_field in float64 numpy (black
    background), from a float64 projection of the cloud (the planes and
    frequency grids are JAX's float32 values)."""
    pos, sc, rot, col, op = [np.asarray(a, np.float64) for a in arrays]
    cam = TCamera.default_training(size)
    proj = tasm.project_gaussians(*[torch.from_numpy(a) for a in
                                    (pos, sc, rot)], cam, max_radius=64.0)
    m2d, conic = proj.means2d.numpy(), proj.conic.numpy()
    rad, dep = proj.radii.numpy(), proj.depths.numpy()
    opac = np.where(proj.visible.numpy(), op, 0.0)
    planes = np.asarray(jax.jit(lambda: jnp.linspace(0.1, 2.0, P))(),
                        np.float64)
    pidx = np.argmin(np.abs(dep[:, None] - planes[None]), axis=1)
    Y, X = np.meshgrid(np.arange(size, dtype=np.float64),
                       np.arange(size, dtype=np.float64), indexing="ij")
    field = np.zeros((P, 3, size, size), np.complex128)
    for g in range(pos.shape[0]):
        dx, dy = X - m2d[g, 0], Y - m2d[g, 1]
        m = conic[g, 0] * dx * dx + 2 * conic[g, 1] * dx * dy \
            + conic[g, 2] * dy * dy
        amp = np.exp(-0.5 * m) * opac[g]
        amp = np.where((np.abs(dx) <= rad[g]) & (np.abs(dy) <= rad[g]),
                       amp, 0.0)
        field[pidx[g]] += (amp[None] * col[g][:, None, None]
                           * np.exp(1j * np.float64(ph[g])))
    f = np.asarray(jax.jit(lambda: jnp.fft.fftfreq(size, d=PITCH))(),
                   np.float64)
    FY, FX = np.meshgrid(f, f, indexing="ij")
    z = focal - planes
    kz = np.sqrt(np.maximum(1.0 / np.asarray(wls, np.float64)[None, :, None,
                                                             None] ** 2
                            - FX ** 2 - FY ** 2, 0.0))
    Htf = np.exp(1j * 2 * np.pi * z[:, None, None, None] * kz)
    total = np.fft.ifft2(np.fft.fft2(field) * Htf).sum(0)
    rendered = np.sqrt(np.abs(total) ** 2 + 1e-8)
    rendered = np.clip(rendered / max(rendered.max(), 1.0), 0, 1)
    return np.clip(rendered, 0, 1)


def _fourier_f64(arrays, ph, wls, size=S, focal=0.5):
    """The JAX formula of render_fourier mode "fourier" in float64 numpy
    (black background), summed directly (not separably) over the
    Gaussians."""
    pos, sc, rot, col, op = [np.asarray(a, np.float64) for a in arrays]
    cam = TCamera.default_training(size)
    proj = tasm.project_gaussians(*[torch.from_numpy(a) for a in
                                    (pos, sc, rot)], cam,
                                  visibility_margin=float(size))
    m2d, cov = proj.means2d.numpy(), proj.cov2d.numpy()
    opac = np.where(proj.visible.numpy(), op, 0.0)
    sig2 = (cov[:, 0, 0] + cov[:, 1, 1]) / 2 + 1e-8
    wls = np.asarray(np.float32(HFGS_WAVELENGTHS) if wls is None else wls,
                     np.float64)
    if ph is None:
        ph = 2 * np.pi / wls[1] * np.abs(proj.depths.numpy() - focal)
    f = np.asarray(jax.jit(lambda: jnp.fft.fftfreq(size))(), np.float64)
    V, U = np.meshgrid(f, f, indexing="ij")
    freq = np.zeros((3, size, size), np.complex128)
    for g in range(pos.shape[0]):
        spec = (2 * np.pi * sig2[g] * np.exp(-2 * np.pi ** 2 * sig2[g]
                                             * (U * U + V * V))
                * np.exp(-2j * np.pi * (U * m2d[g, 0] + V * m2d[g, 1])))
        amp = opac[g] * col[g] * np.exp(1j * np.float64(ph[g]) * wls[1]
                                        / wls)
        freq += amp[:, None, None] * spec[None]
    inten = np.abs(np.fft.ifft2(freq) * size * size)
    return np.clip(inten / max(inten.max(), 1e-8), 0, 1)


def _grads(render, arrays, wts, dtype):
    targs = [torch.from_numpy(a).to(dtype).requires_grad_() for a in arrays]
    out = render(*targs)
    loss = (out * torch.from_numpy(wts).to(dtype)).sum()
    return out.detach().double().numpy(), [
        g.double().numpy() for g in torch.autograd.grad(loss, targs)]


def _jax_grads(render, arrays, wts):
    jargs = [jnp.asarray(a) for a in arrays]
    out = render(*jargs)
    g = jax.grad(lambda *a: jnp.sum(render(*a) * wts),
                 argnums=tuple(range(len(arrays))))(*jargs)
    return np.asarray(out), [np.asarray(x) for x in g]


def _check(jo, jg, to, tg, t64, tg64, ref):
    d_jax = _rel(jo, ref)
    assert _rel(to, ref) <= max(F64_FACTOR * d_jax, FLOOR)
    assert _rel(to, jo) <= max(JAX_FACTOR * d_jax, FLOOR)
    assert _rel(t64, ref) <= 1e-7          # the port's float64 is the formula
    for i, (g, w, r) in enumerate(zip(tg, jg, tg64)):
        assert np.abs(w).max() > 0, i
        d = _rel(w, r)
        assert _rel(g, r) <= max(F64_FACTOR * d, FLOOR), (i, _rel(g, r), d)
        assert _rel(g, w) <= max(JAX_FACTOR * d, FLOOR), (i, _rel(g, w), d)


@pytest.mark.parametrize("rgb", [False, True])
def test_asm_renderer_matches_jax(rgb):
    arrays, ph = _cloud(0)
    wls = RGB if rgb else None
    jcam, tcam = JCamera.default_training(S), TCamera.default_training(S)

    def jr(p, s, r, c, o, phs):
        return jasm.render_asm_wave_field(
            p, s, r, c, o, jcam, phs,
            None if wls is None else jnp.asarray(wls))

    def tr(p, s, r, c, o, phs):
        return tasm.render_asm_wave_field(
            p, s, r, c, o, tcam, phs,
            None if wls is None else torch.from_numpy(wls).to(p.dtype))

    wts = np.random.default_rng(1).normal(size=(3, S, S)).astype(np.float32)
    jo, jg = _jax_grads(jr, arrays + [ph], wts)
    to, tg = _grads(tr, arrays + [ph], wts, torch.float32)
    t64, tg64 = _grads(tr, arrays + [ph], wts, torch.float64)
    ref = _asm_f64(arrays, ph, RGB if rgb else np.full(3, 0.05, np.float32))
    _check(jo, jg, to, tg, t64, tg64, ref)
    # make_renderer passes the keywords through, and needs phases.
    r = make_renderer("asm", wavelengths_rgb=None if wls is None
                      else torch.from_numpy(wls))
    img = r(*[torch.from_numpy(a) for a in arrays], tcam,
            phases=torch.from_numpy(ph))
    assert torch.equal(img, torch.from_numpy(to).float())
    with pytest.raises(ValueError, match="requires phases"):
        r(*[torch.from_numpy(a) for a in arrays], tcam)


def test_asm_wavelength_gradient_is_nan_where_jax_is():
    arrays, ph = _cloud(2, n=40)
    jcam, tcam = JCamera.default_training(32), TCamera.default_training(32)
    wts = np.random.default_rng(3).normal(size=(3, 32, 32)).astype(
        np.float32)
    jargs = [jnp.asarray(a) for a in arrays + [ph]]
    jg = np.asarray(jax.grad(lambda wl: jnp.sum(jasm.render_asm_wave_field(
        *jargs[:5], jcam, jargs[5], wl) * wts))(jnp.asarray(RGB)))
    wl = torch.from_numpy(RGB).requires_grad_()
    out = tasm.render_asm_wave_field(
        *[torch.from_numpy(a) for a in arrays], tcam, torch.from_numpy(ph),
        wl)
    (tg,) = torch.autograd.grad((out * torch.from_numpy(wts)).sum(), wl)
    assert np.isnan(jg).all()
    assert torch.isnan(tg).all()


@pytest.mark.parametrize("phases", [False, True])
@pytest.mark.parametrize("wavelengths", [False, True])
def test_fourier_true_matches_jax(phases, wavelengths):
    arrays, ph = _cloud(4)
    extra = ([ph] if phases else []) + ([RGB] if wavelengths else [])
    jcam, tcam = JCamera.default_training(S), TCamera.default_training(S)

    def split(rest):
        rest = list(rest)
        return (rest.pop(0) if phases else None,
                rest.pop(0) if wavelengths else None)

    def jr(p, s, r, c, o, *rest):
        phs, wl = split(rest)
        return jfourier(p, s, r, c, o, jcam, phases=phs, wavelengths=wl,
                        mode="fourier")

    def tr(p, s, r, c, o, *rest):
        phs, wl = split(rest)
        return render_fourier(p, s, r, c, o, tcam, phases=phs,
                              wavelengths=wl, mode="fourier")

    wts = np.random.default_rng(5).normal(size=(3, S, S)).astype(np.float32)
    jo, jg = _jax_grads(jr, arrays + extra, wts)
    to, tg = _grads(tr, arrays + extra, wts, torch.float32)
    t64, tg64 = _grads(tr, arrays + extra, wts, torch.float64)
    ref = _fourier_f64(arrays, ph if phases else None,
                       RGB if wavelengths else None)
    _check(jo, jg, to, tg, t64, tg64, ref)


def test_fourier_true_through_make_renderer():
    arrays, ph = _cloud(6, n=60)
    tcam = TCamera.default_training(32)
    r = make_renderer("fourier_true", focal_depth=0.6)
    img, depth = r(*[torch.from_numpy(a) for a in arrays], tcam,
                   return_depth=True)
    want = np.asarray(jfourier(*[jnp.asarray(a) for a in arrays],
                               JCamera.default_training(32), mode="fourier",
                               focal_depth=0.6))
    assert img.shape == (3, 32, 32) and torch.all(depth == 0)
    assert _rel(img.numpy(), want) <= 1e-4
    assert not r.supports_overflow


@pytest.mark.parametrize("h,w", [(48, 64), (100, 96)])
def test_frequency_loss_masks_match_jit(h, w):
    """losses.physics builds its radial masks on the same grids: the JAX
    step's, jitted, bit for bit (a non-power-of-two size included)."""
    from fresnel_tpu.losses import physics as jphys
    from fresnel_tpu_torch.losses import physics as tphys

    want = [np.asarray(m) for m in jax.jit(
        lambda: jphys._radial_masks(h, w, 0.1))()]
    got = tphys._radial_masks(h, w, 0.1, None)
    for g, m in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), m)
