"""Port parity: pair binning, tile totals and the tiled renderer.

Binning tables and tile totals are fed the same depth-sorted inputs on
both sides and must be bit-identical.  Renders run the JAX renderer with
its Pallas compositor in interpret mode (max_per_tile=128, as
tests/test_pallas_raster.py does) against the port's plain compositor on
the CPU, at atol 2e-5: the bound that file holds Pallas to against XLA
(depth at 1e-4, its depth bound).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fresnel_tpu.core.camera import Camera as JCamera
from fresnel_tpu.core.gaussians import GaussianCloud
from fresnel_tpu.render import projection as jp
from fresnel_tpu.render import tile as jt

from fresnel_tpu_torch.core.camera import Camera as TCamera
from fresnel_tpu_torch.render import raster
from fresnel_tpu_torch.render import tile as tt
from test_torch_threads import _few_threads  # noqa: F401


PALLAS_CFG = jt.TileRendererConfig(max_per_tile=128, backend="pallas",
                                   pallas_interpret=True)
PORT_CFG = tt.TileRendererConfig(max_per_tile=128)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cloud_arrays(n, seed, spread=0.5, z_offset=-2.0, anisotropic=False):
    c = GaussianCloud.test_cloud(n, seed=seed, spread=spread,
                                 z_offset=z_offset)
    arrs = [np.array(a) for a in (c.positions, c.scales, c.rotations,
                                  c.colors, c.opacities)]
    if anisotropic:
        rng = np.random.default_rng(seed + 100)
        arrs[1] = rng.uniform(0.02, 0.15, size=(n, 3)).astype(np.float32)
        arrs[2] = rng.normal(size=(n, 4)).astype(np.float32)
        arrs[4] = rng.uniform(0.1, 1.0, size=n).astype(np.float32)
    return arrs


def _sorted_projection(arrs, res, max_radius):
    """JAX projection + exact depth sort, as render_tiled feeds binning."""
    pos, sc, rot, _, op = arrs
    proj = jp.project_gaussians(jnp.asarray(pos), jnp.asarray(sc),
                                jnp.asarray(rot), JCamera.default_training(res),
                                max_radius=max_radius)
    visible = np.asarray(proj.visible) & (op > 0)
    key = np.where(visible, np.asarray(proj.depths), np.inf)
    order = np.argsort(key, kind="stable")
    return (np.asarray(proj.means2d)[order], np.asarray(proj.radii)[order],
            visible[order])


def _render_both(arrs, res, **kw):
    jc, tc = JCamera.default_training(res), TCamera.default_training(res)
    ref = jt.render_tiled(*[jnp.asarray(a) for a in arrs], jc,
                          config=PALLAS_CFG, **kw)
    out = tt.render_tiled(*[_t(a) for a in arrs], tc, config=PORT_CFG, **kw)
    return ref, out


class TestBinning:
    @pytest.mark.parametrize("n,res,m,aniso", [
        (60, 32, 16, False), (300, 64, 128, False), (600, 64, 32, True),
        (1500, 96, 64, True)])
    def test_tables_bit_identical(self, n, res, m, aniso):
        arrs = _cloud_arrays(n, seed=n, spread=0.6, anisotropic=aniso)
        means2d, radii, visible = _sorted_projection(arrs, res, 32.0)
        ntx = nty = -(-res // 16)
        ji, jv = jax.jit(jt._bin_gaussians, static_argnums=(3, 4, 5, 6))(
            jnp.asarray(means2d), jnp.asarray(radii), jnp.asarray(visible),
            ntx, nty, 16, m)
        ti, tv = tt._bin_gaussians(_t(means2d), _t(radii), _t(visible),
                                   ntx, nty, 16, m)
        assert ti.dtype == torch.int32
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        if m <= 32:
            assert tv.all(dim=1).any(), "case should overflow some tile"

    @pytest.mark.parametrize("n,res", [(300, 64), (1500, 96)])
    def test_tile_totals_identical(self, n, res):
        arrs = _cloud_arrays(n, seed=n, anisotropic=True)
        means2d, radii, visible = _sorted_projection(arrs, res, 32.0)
        ntx = nty = -(-res // 16)
        jtot = jax.jit(jt._tile_totals, static_argnums=(3, 4, 5))(
            jnp.asarray(means2d), jnp.asarray(radii), jnp.asarray(visible),
            ntx, nty, 16)
        ttot = tt._tile_totals(_t(means2d), _t(radii), _t(visible),
                               ntx, nty, 16)
        assert ttot.dtype == torch.int32
        np.testing.assert_array_equal(ttot.numpy(), np.asarray(jtot))


class TestRender:
    @pytest.mark.parametrize("n,res", [(1, 32), (80, 48), (300, 64)])
    def test_matches_jax_pallas(self, n, res):
        arrs = _cloud_arrays(n, seed=n)
        ref, out = _render_both(arrs, res)
        assert out.shape == (3, res, res)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)

    def test_anisotropic_cloud(self):
        arrs = _cloud_arrays(200, seed=4, anisotropic=True)
        ref, out = _render_both(arrs, 64)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)

    def test_depth_transmittance_overflow(self):
        arrs = _cloud_arrays(300, seed=3)
        (ri, rd, rt, ro), (oi, od, ot, oo) = _render_both(
            arrs, 48, return_depth=True, return_transmittance=True,
            return_overflow=True)
        np.testing.assert_allclose(oi.numpy(), np.asarray(ri), atol=2e-5)
        np.testing.assert_allclose(od.numpy(), np.asarray(rd), atol=1e-4)
        np.testing.assert_allclose(ot.numpy(), np.asarray(rt), atol=2e-5)
        np.testing.assert_array_equal(oo.numpy(), np.asarray(ro))
        assert oo[0] > 0, "case should drop pairs past max_per_tile"

    def test_background(self):
        arrs = _cloud_arrays(10, seed=1, z_offset=+5.0)   # behind the camera
        ref, out = _render_both(arrs, 32, background=(0.2, 0.4, 0.6))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)
        np.testing.assert_allclose(out[0].numpy(), 0.2, atol=1e-6)
        np.testing.assert_allclose(out[2].numpy(), 0.6, atol=1e-6)

    def test_background_blends_with_transmittance(self):
        arrs = _cloud_arrays(80, seed=2)
        ref, out = _render_both(arrs, 32, background=(0.3, 0.1, 0.9))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)


class TestCompositor:
    def test_packed_plain_matches_jax_packed(self):
        """The port's plain compositor on a random pack against the JAX
        package's composite_tiles_pallas_packed (interpret) on the same
        pack: the kernel's contract, (T, 256, 3), (T, 256), (T, 256)."""
        from fresnel_tpu.render.pallas_raster import (
            composite_tiles_pallas_packed)
        rng = np.random.default_rng(0)
        T, M, ntx = 6, 64, 3
        pack = np.zeros((T, M, 12), np.float32)
        pack[..., 0] = rng.uniform(0, 48, (T, M))
        pack[..., 1] = rng.uniform(0, 32, (T, M))
        pack[..., 2] = rng.uniform(0.01, 0.2, (T, M))
        pack[..., 3] = rng.uniform(-0.01, 0.01, (T, M))
        pack[..., 4] = rng.uniform(0.01, 0.2, (T, M))
        pack[..., 5] = rng.uniform(2, 20, (T, M))
        pack[..., 6:9] = rng.uniform(0, 1, (T, M, 3))
        pack[..., 9] = rng.uniform(0, 1, (T, M))
        pack[..., 10] = rng.uniform(1, 3, (T, M))
        counts = np.array([0, 1, 17, 63, 64, 40], np.int32)
        dead = np.arange(M)[None, :] >= counts[:, None]
        pack[dead] = 0.0
        pack[dead, 5] = -1.0
        jc, jd, jtr = composite_tiles_pallas_packed(
            jnp.asarray(pack), ntx, interpret=True, counts=jnp.asarray(counts))
        c, d, tr = raster.composite_tiles_packed(_t(pack), _t(counts), ntx)
        assert c.shape == (T, 256, 3) and d.shape == tr.shape == (T, 256)
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=2e-5)
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-4)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jtr), atol=2e-5)
        assert raster.launches == 0     # CPU tensors never launch the kernel


class TestNotPorted:
    # The depth sorts "counting" and "packed" and hard_cutoff=False are
    # ported (tests/test_torch_dense_render.py, test_torch_wave_render.py),
    # and so are the tile sizes these cases held raising: each case keeps
    # its id and checks that its size renders on the CPU as the JAX
    # package's XLA scan does (tests/test_torch_tile_sizes.py holds every
    # size and route).
    @pytest.mark.parametrize("cfg", [
        tt.TileRendererConfig(tile_size=32),
        tt.TileRendererConfig(tile_size=8),
        tt.TileRendererConfig(tile_size=4),
    ])
    def test_options_raise(self, cfg):
        arrs = _cloud_arrays(60, seed=0)
        ref = jt.render_tiled(*[jnp.asarray(a) for a in arrs],
                              JCamera.default_training(32),
                              config=jt.TileRendererConfig(
                                  tile_size=cfg.tile_size, backend="xla"))
        out = tt.render_tiled(*[_t(a) for a in arrs],
                              TCamera.default_training(32), config=cfg)
        assert out.shape == (3, 32, 32)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)

    def test_phase_blending_raises(self):
        """Phase blending (tests/test_torch_wave_render.py) and the four
        renderers this case held raising are ported: the case keeps its
        name and checks that each renderer now builds and renders."""
        from fresnel_tpu_torch.render.factory import make_renderer

        arrs = [_t(a) for a in _cloud_arrays(20, seed=0)]
        phases = torch.linspace(0.0, 6.0, 20)
        for name in ("asm", "fourier_true", "dense", "simplified"):
            img = make_renderer(name)(*arrs, TCamera.default_training(32),
                                      phases=phases)
            assert img.shape == (3, 32, 32), name
            assert torch.isfinite(img).all(), name
