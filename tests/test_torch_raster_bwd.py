"""Port parity: the compositor's backward (K2's plain version) and the
autograd Function around both compositors, on the CPU.

* `composite_tiles_bwd_plain` against `jax.vjp` of the JAX package's
  composite_tiles_pallas_packed in interpret mode, with random cotangents
  on all three outputs, at atol 3e-5 / rtol 2e-3: ten times tighter than
  the bound tests/test_pallas_raster.py holds the Pallas gradients to
  against XLA (atol 3e-4, rtol 2e-2).  Both sides are float32 and differ
  only in summation order.
* The Function's gradient against autograd of the plain forward in
  float64 (rtol 1e-9: the same formulas, only rounding differs) and
  `torch.autograd.gradcheck` (fast mode: random projections of the
  Jacobian) at a tiny size, with opacities below the 0.99 clamp and radii
  past the tile, so no box edge or clamp is crossed.
* Zero gradient in the radius and pad columns and in slots >= count.
* No second derivative: it raises, as it must on the card.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fresnel_tpu.render.pallas_raster import composite_tiles_pallas_packed

from fresnel_tpu_torch.render import raster
from test_torch_threads import _few_threads  # noqa: F401


def _pack(T, M, ntx, counts, seed, op_hi=1.0, r_lo=2.0, r_hi=20.0):
    rng = np.random.default_rng(seed)
    pack = np.zeros((T, M, 12), np.float32)
    pack[..., 0] = rng.uniform(-4, ntx * 16 + 4, (T, M))
    pack[..., 1] = rng.uniform(-4, (-(-T // ntx)) * 16 + 4, (T, M))
    pack[..., 2] = rng.uniform(0.01, 0.2, (T, M))
    pack[..., 3] = rng.uniform(-0.01, 0.01, (T, M))
    pack[..., 4] = rng.uniform(0.01, 0.2, (T, M))
    pack[..., 5] = rng.uniform(r_lo, r_hi, (T, M))
    pack[..., 6:9] = rng.uniform(0, 1, (T, M, 3))
    pack[..., 9] = rng.uniform(0, op_hi, (T, M))
    pack[..., 10] = rng.uniform(1, 3, (T, M))
    pack[..., 11] = rng.uniform(-1, 1, (T, M))      # pad: never read
    counts = np.asarray(counts, np.int32)
    dead = np.arange(M)[None, :] >= counts[:, None]
    pack[dead] = 0.0
    pack[dead, 5] = -1.0
    return pack, counts


def _cotangents(T, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(T, 256, 3)).astype(dtype),
            rng.normal(size=(T, 256)).astype(dtype),
            rng.normal(size=(T, 256)).astype(dtype))


@pytest.mark.parametrize("T,M,ntx,counts,chunk", [
    (6, 64, 3, [0, 1, 17, 63, 64, 40], 32),
    (4, 128, 2, [128, 70, 5, 100], 64),
])
def test_bwd_plain_matches_pallas_vjp(T, M, ntx, counts, chunk):
    pack, counts = _pack(T, M, ntx, counts, seed=T + M)
    gc, gd, gt = _cotangents(T, seed=M)
    outs, vjp = jax.vjp(
        lambda p: composite_tiles_pallas_packed(
            p, ntx, interpret=True, counts=jnp.asarray(counts)),
        jnp.asarray(pack))
    (ref,) = vjp((jnp.asarray(gc), jnp.asarray(gd), jnp.asarray(gt)))

    tp, tc = torch.from_numpy(pack), torch.from_numpy(counts)
    color, depth, trans = raster.composite_tiles_plain(tp, tc, ntx, chunk)
    got = raster.composite_tiles_bwd_plain(
        tp, tc, ntx, color, depth, trans, torch.from_numpy(gc),
        torch.from_numpy(gd), torch.from_numpy(gt), chunk=chunk)
    assert got.shape == (T, M, 12) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=3e-5,
                               rtol=2e-3)
    assert np.abs(np.asarray(ref)).max() > 1.0     # a real gradient


def _loss(outs, cots):
    return sum((o * c).sum() for o, c in zip(outs, cots))


def test_function_grad_matches_autograd_of_plain_f64():
    T, M, ntx = 4, 64, 2
    pack, counts = _pack(T, M, ntx, [64, 30, 1, 0], seed=3)
    cots = [torch.from_numpy(c) for c in _cotangents(T, 4, np.float64)]
    tc = torch.from_numpy(counts)

    p1 = torch.from_numpy(pack).double().requires_grad_()
    outs = raster.composite_tiles_packed(p1, tc, ntx)
    assert all(o.grad_fn is not None for o in outs)
    _loss(outs, cots).backward()

    p2 = torch.from_numpy(pack).double().requires_grad_()
    _loss(raster.composite_tiles_plain(p2, tc, ntx), cots).backward()
    torch.testing.assert_close(p1.grad, p2.grad, rtol=1e-9, atol=1e-12)
    assert raster.launches == 0 and raster.launches_bwd == 0


def test_gradcheck_tiny():
    T, M, ntx = 2, 8, 2
    pack, counts = _pack(T, M, ntx, [8, 5], seed=5, op_hi=0.8,
                         r_lo=40.0, r_hi=50.0)
    p = torch.from_numpy(pack).double().requires_grad_()
    tc = torch.from_numpy(counts)
    assert torch.autograd.gradcheck(
        lambda x: raster.composite_tiles_packed(x, tc, ntx, chunk=4), (p,),
        eps=1e-6, atol=1e-6, rtol=1e-4, fast_mode=True)


def test_second_derivative_raises():
    """K2 has no derivative, so the Function's backward is once
    differentiable on both devices: a second derivative raises on the CPU
    too, rather than differentiating the plain backward."""
    T, M, ntx = 2, 32, 2
    pack, counts = _pack(T, M, ntx, [32, 9], seed=10)
    p = torch.from_numpy(pack).double().requires_grad_()
    outs = raster.composite_tiles_packed(p, torch.from_numpy(counts), ntx)
    (g,) = torch.autograd.grad(sum((o * o).sum() for o in outs), p,
                               create_graph=True)
    with pytest.raises(RuntimeError, match="differentiate twice"):
        g.sum().backward()


def test_zero_gradient_in_radius_pad_and_dead_slots():
    T, M, ntx = 3, 64, 3
    pack, counts = _pack(T, M, ntx, [64, 20, 0], seed=6)
    p = torch.from_numpy(pack).requires_grad_()
    outs = raster.composite_tiles_packed(p, torch.from_numpy(counts), ntx)
    _loss(outs, [torch.from_numpy(c) for c in _cotangents(T, 7)]).backward()
    g = p.grad
    assert torch.all(g[..., 5] == 0) and torch.all(g[..., 11] == 0)
    dead = torch.arange(M)[None, :] >= torch.from_numpy(counts)[:, None]
    assert torch.all(g[dead] == 0)
    assert torch.all(g[~dead][:, [0, 1, 6, 9]].abs().sum(0) > 0)


def test_unused_outputs_take_zero_cotangents():
    """A loss on the colour alone gives the gradient of zero cotangents for
    depth and transmittance."""
    T, M, ntx = 2, 32, 2
    pack, counts = _pack(T, M, ntx, [32, 9], seed=8)
    tc = torch.from_numpy(counts)
    gc = torch.from_numpy(_cotangents(T, 9)[0])
    p1 = torch.from_numpy(pack).requires_grad_()
    (raster.composite_tiles_packed(p1, tc, ntx)[0] * gc).sum().backward()
    c, d, t = raster.composite_tiles_plain(torch.from_numpy(pack), tc, ntx)
    ref = raster.composite_tiles_bwd_plain(
        torch.from_numpy(pack), tc, ntx, c, d, t, gc, torch.zeros_like(d),
        torch.zeros_like(t))
    torch.testing.assert_close(p1.grad, ref, rtol=0, atol=0)


def test_render_grad_with_background_matches_jax():
    """render_tiled's gradient in every cloud field, with a background and
    depth and transmittance in the loss, against the JAX renderer with its
    Pallas compositor (interpret), at tests/test_pallas_raster.py's bound.
    Pins the suffix sums starting at the composite BEFORE the background:
    the background enters only through the transmittance."""
    from fresnel_tpu.core.camera import Camera as JCamera
    from fresnel_tpu.core.gaussians import GaussianCloud as JCloud
    from fresnel_tpu.render import tile as jt

    from fresnel_tpu_torch.core.camera import Camera
    from fresnel_tpu_torch.render import tile as tt

    c = JCloud.test_cloud(60, seed=4, spread=0.4, z_offset=-2.0)
    arrs = [np.array(a) for a in (c.positions, c.scales, c.rotations,
                                  c.colors, c.opacities)]
    arrs[4] = np.random.default_rng(4).uniform(0.2, 0.95, 60).astype(
        np.float32)
    bg, res = (0.2, 0.4, 0.6), 32
    w = np.random.default_rng(5).normal(size=(3, res, res)).astype(np.float32)
    kw = dict(background=bg, return_depth=True, return_transmittance=True)

    def jloss(*a):
        img, d, t = jt.render_tiled(
            *a, JCamera.default_training(res), config=jt.TileRendererConfig(
                max_per_tile=64, backend="pallas", pallas_interpret=True),
            **kw)
        return jnp.sum(img * w) + jnp.mean(d) + jnp.sum(t)

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        *[jnp.asarray(a) for a in arrs])
    targs = [torch.from_numpy(a.copy()).requires_grad_() for a in arrs]
    img, d, t = tt.render_tiled(
        *targs, Camera.default_training(res),
        config=tt.TileRendererConfig(max_per_tile=64), **kw)
    ((img * torch.from_numpy(w)).sum() + d.mean() + t.sum()).backward()
    for name, a, b in zip(("positions", "scales", "rotations", "colors",
                           "opacities"), targs, jg):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), atol=3e-4,
                                   rtol=2e-2, err_msg=name)
