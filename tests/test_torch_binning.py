"""Port parity: the search, stream, rows and chunked binnings.

Every binning is an integer function, so every comparison here is bit for
bit.  Both sides get the same depth-sorted inputs (the JAX package's
projection and sort, as numpy), never each side's own projection, whose
last-bit differences could move a Gaussian across a tile edge.  The JAX
side runs as its own tests run it on the CPU: the Pallas rank-table kernel
with table="pallas", pallas_interpret=True, the Pallas stream kernel with
interpret=True and the shrunk constants chunk=128, cpc=2, tile_block=8,
win=16.  On CPU tensors the port's wrappers run the plain versions of its
CUDA kernels, and no kernel is launched.

Renders: the port's `render_tiled` under each binning against the JAX
image, atol 2e-5, the tolerance test_torch_tile.py holds for the
compositor (the plain compositor sums in another order than XLA's scan);
the port's binnings against each other bit for bit.  The cloud's seed is
one at which no Gaussian's cutoff box flips a pixel between the two
projections: `test_cloud` is isotropic, where the radius's
sqrt(trace^2 - 4 det) cancels and XLA's fused multiply-adds move it by up
to 1e-3 px; `test_isotropic_box_edge_flip` pins what a flip costs.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fresnel_tpu.core.camera import Camera as JCamera
from fresnel_tpu.core.gaussians import GaussianCloud as JCloud
from fresnel_tpu.render import pallas_binning as jbin
from fresnel_tpu.render import pallas_stream_binning as jstream
from fresnel_tpu.render import projection as jp
from fresnel_tpu.render import tile as jt

from fresnel_tpu_torch.core.camera import Camera as TCamera
from fresnel_tpu_torch.core.gaussians import GaussianCloud as TCloud
from fresnel_tpu_torch.render import binning as tbin
from fresnel_tpu_torch.render import stream_binning as tstream
from fresnel_tpu_torch.render import tile as tt

STREAM_KW = dict(interpret=True, chunk=128, cpc=2, tile_block=8, win=16)


def _t(a):
    return torch.from_numpy(np.array(a))


def _wide_camera():
    """128 x 96: the 8 x 6 tile grid."""
    view = jnp.eye(4, dtype=jnp.float32).at[2, 3].set(-2.0)
    return JCamera.create(fx=102.4, fy=102.4, cx=64.0, cy=48.0, width=128,
                          height=96, view=view)


def _sorted_inputs(n, seed, cam=None):
    """The JAX side's sorted means2d, radii, visible, as numpy."""
    cam = cam or JCamera.default_training(128)
    cloud = JCloud.test_cloud(n, seed=seed, spread=0.6, z_offset=-2.0,
                              scale=0.05)
    proj = jp.project_gaussians(cloud.positions, cloud.scales,
                                cloud.rotations, cam, max_radius=32.0)
    proj = dataclasses.replace(
        proj, visible=proj.visible & (cloud.opacities > 0.0))
    order = jp.depth_sort_indices(proj)
    return tuple(np.asarray(a[order]) for a in (proj.means2d, proj.radii,
                                                proj.visible))


def _assert_tables_equal(port, ref):
    (ti, tv), (ji, jv) = port, ref
    assert ti.dtype == torch.int32 and tv.dtype == torch.bool
    ji, jv = np.asarray(ji), np.asarray(jv)
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(np.where(tv.numpy(), ti.numpy(), -1),
                                  np.where(jv, ji, -1))
    # Dead slots hold index 0 on both sides.
    np.testing.assert_array_equal(ti.numpy(), ji)


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    before = (tbin.launches, tstream.launches)
    yield
    assert (tbin.launches, tstream.launches) == before


class TestSearch:
    @pytest.mark.parametrize("table", ["pallas", "xla"])
    @pytest.mark.parametrize("n", [77, 300, 5000])
    def test_tables_identical(self, n, table):
        m2, rad, vis = _sorted_inputs(n, seed=n)
        ref = jt._bin_gaussians_search(jnp.asarray(m2), jnp.asarray(rad),
                                       jnp.asarray(vis), 8, 8, 16, 64)
        out = tt._bin_gaussians_search(_t(m2), _t(rad), _t(vis), 8, 8, 16,
                                       64, table=table)
        _assert_tables_equal(out, ref)
        if n == 5000:
            assert out[1].all(dim=1).any(), "case should overflow some tile"

    @pytest.mark.parametrize("table", ["pallas", "xla"])
    def test_nonsquare_grid(self, table):
        m2, rad, vis = _sorted_inputs(3000, seed=12, cam=_wide_camera())
        ref = jt._bin_gaussians_search(jnp.asarray(m2), jnp.asarray(rad),
                                       jnp.asarray(vis), 8, 6, 16, 64)
        out = tt._bin_gaussians_search(_t(m2), _t(rad), _t(vis), 8, 6, 16,
                                       64, table=table)
        assert out[0].shape == (48, 64)
        _assert_tables_equal(out, ref)

    @pytest.mark.parametrize("table", ["pallas", "xla"])
    @pytest.mark.parametrize("groups", [2, 4, 8])
    def test_grouped_identical(self, groups, table):
        m2, rad, vis = _sorted_inputs(5000, seed=9)
        ref = jt._bin_gaussians_search(jnp.asarray(m2), jnp.asarray(rad),
                                       jnp.asarray(vis), 8, 8, 16, 64,
                                       groups=groups)
        out = tt._bin_gaussians_search(_t(m2), _t(rad), _t(vis), 8, 8, 16,
                                       64, groups=groups, table=table)
        _assert_tables_equal(out, ref)

    @pytest.mark.parametrize("table", ["pallas", "xla"])
    def test_grouped_nondivisible_rows(self, table):
        # 6 tile rows in 4 groups: rows padded to 8, 2 per group.
        m2, rad, vis = _sorted_inputs(3000, seed=11, cam=_wide_camera())
        ref = jt._bin_gaussians_search(jnp.asarray(m2), jnp.asarray(rad),
                                       jnp.asarray(vis), 8, 6, 16, 64,
                                       groups=4)
        out = tt._bin_gaussians_search(_t(m2), _t(rad), _t(vis), 8, 6, 16,
                                       64, groups=4, table=table)
        assert out[0].shape == (48, 64)
        _assert_tables_equal(out, ref)

    def test_matches_pair_binning(self):
        m2, rad, vis = (_t(a) for a in _sorted_inputs(5000, seed=7))
        pi, pv = tt._bin_gaussians(m2, rad, vis, 8, 8, 16, 64)
        si, sv = tt._bin_gaussians_search(m2, rad, vis, 8, 8, 16, 64)
        assert torch.equal(pv, sv) and torch.equal(pi, si)

    def test_unknown_table_build_raises(self):
        m2, rad, vis = (_t(a) for a in _sorted_inputs(77, seed=1))
        with pytest.raises(ValueError, match="table_build"):
            tt._bin_gaussians_search(m2, rad, vis, 8, 8, 16, 64,
                                     table="mosaic")

    @pytest.mark.parametrize("n,ntx,nty,groups", [
        (1_000_000, 32, 32, 1), (1_100_000, 32, 32, 2),
        (5_000_000, 32, 32, 8), (5000, 8, 8, 1),
        (600_000_000, 2, 2, 2)])
    def test_search_groups(self, n, ntx, nty, groups):
        """The slab rule of the JAX renderer: groups double while a
        group's table passes 2^30 elements, up to the tile rows."""
        n2 = -(-n // 256) * 256
        want = 1
        while (n2 * ntx * nty) // want > (1 << 30) and want < nty:
            want *= 2
        assert tt.search_groups(n, ntx, nty) == want == groups


class TestRankTable:
    """K3's plain version against the Pallas kernel in interpret mode."""

    def _bounds(self, m2, rad, vis):
        cxlo, cxhi, cylo, cyhi, vis, n2 = tt._padded_intervals(
            _t(m2), _t(rad), _t(vis), 16)
        return (cxlo, torch.where(vis, cxhi, -1), cylo,
                torch.where(vis, cyhi, -1)), n2

    @pytest.mark.parametrize("groups", [1, 4])
    def test_table_and_cumtot_identical(self, groups):
        m2, rad, vis = _sorted_inputs(5000, seed=13)
        bounds, n2 = self._bounds(m2, rad, vis)
        assert n2 == 5120
        nty_g = 8 // groups
        for g in range(groups):
            jtab, jcum = jbin.build_rank_table(
                *[jnp.asarray(b.numpy()) for b in bounds], 8, nty_g, n2,
                y_offset=g * nty_g, interpret=True)
            tab, cum = tbin.build_rank_table(*bounds, 8, nty_g, n2,
                                             y_offset=g * nty_g)
            assert tab.dtype == torch.bfloat16 and tab.shape == (8 * nty_g, n2)
            assert cum.dtype == torch.int32 and cum.shape == (8 * nty_g, 20)
            # The JAX table is padded to its grid's 2048 span; the port's
            # stops at n2.
            np.testing.assert_array_equal(
                tab.float().numpy(),
                np.asarray(jtab[:, :n2].astype(jnp.float32)))
            np.testing.assert_array_equal(cum.numpy(),
                                          np.asarray(jcum)[:, :n2 // 256])

    def test_matches_mask_build(self):
        """The two table builds of the port: same table, same totals."""
        m2, rad, vis = _sorted_inputs(3000, seed=5, cam=_wide_camera())
        bounds, n2 = self._bounds(m2, rad, vis)
        tab, cum = tbin.build_rank_table(*bounds, 8, 6, n2)
        ax = torch.arange(8, dtype=torch.int32)[:, None]
        ay = torch.arange(6, dtype=torch.int32)[:, None]
        hx = (ax >= bounds[0][None]) & (ax <= bounds[1][None])
        hy = (ay >= bounds[2][None]) & (ay <= bounds[3][None])
        hit_t = (hy[:, None, :] & hx[None, :, :]).reshape(48, n2)
        tab2, cum2 = tt._rank_table_from_hits(hit_t)
        assert torch.equal(tab, tab2) and torch.equal(cum, cum2)

    def test_full_chunk_count_is_exact(self):
        """256 hits in one chunk: the largest count, exact in bfloat16."""
        n2 = 512
        lo = torch.zeros(n2, dtype=torch.int32)
        hi = torch.zeros(n2, dtype=torch.int32)
        tab, cum = tbin.build_rank_table(lo, hi, lo, hi, 2, 1, n2)
        assert tab[0, 255].item() == 256.0 and tab[0, 256].item() == 1.0
        assert cum.tolist() == [[256, 512], [0, 0]]

    def test_rejects_bad_inputs(self):
        v = torch.zeros(256, dtype=torch.int32)
        with pytest.raises(TypeError):
            tbin.build_rank_table(v.long(), v, v, v, 2, 2, 256)
        with pytest.raises(ValueError):
            tbin.build_rank_table(v[:100], v[:100], v[:100], v[:100], 2, 2,
                                  100)
        with pytest.raises(ValueError):
            tbin.build_rank_table(v, v[:128], v, v, 2, 2, 256)


class TestStream:
    @pytest.mark.parametrize("n,M", [(900, 64), (3000, 256)])
    def test_tables_identical(self, n, M):
        m2, rad, vis = _sorted_inputs(n, seed=n + 5)
        ref = jstream.bin_gaussians_stream(
            jnp.asarray(m2), jnp.asarray(rad), jnp.asarray(vis), 8, 8, 16, M,
            **STREAM_KW)
        out = tstream.bin_gaussians_stream(_t(m2), _t(rad), _t(vis), 8, 8,
                                           16, M)
        _assert_tables_equal(out, ref)

    def test_matches_search_on_nonsquare_grid(self):
        m2, rad, vis = (_t(a) for a in _sorted_inputs(
            3000, seed=21, cam=_wide_camera()))
        si, sv = tt._bin_gaussians_search(m2, rad, vis, 8, 6, 16, 64)
        ti, tv = tstream.bin_gaussians_stream(m2, rad, vis, 8, 6, 16, 64)
        assert torch.equal(tv, sv) and torch.equal(ti, si)

    def test_intervals_clamped_and_visibility_folded(self):
        m2 = torch.tensor([[-40.0, 8.0], [200.0, 8.0], [8.0, 8.0]])
        rad = torch.tensor([30.0, 100.0, 4.0])
        vis = torch.tensor([True, True, False])
        iv = tstream.stream_intervals(m2, rad, vis, 8, 8, 16)
        assert iv.dtype == torch.int32
        assert iv.tolist() == [[0, -1, 0, 2], [6, 7, 0, 6], [0, -1, 0, 0]]

    def test_empty_stream(self):
        ti, tv = tstream.bin_gaussians_stream(
            torch.zeros((0, 2)), torch.zeros(0),
            torch.zeros(0, dtype=torch.bool), 2, 2, 16, 32)
        assert ti.shape == tv.shape == (4, 32)
        assert not tv.any() and not ti.any()


class TestRows:
    @pytest.mark.parametrize("n", [900, 5000])
    def test_tables_identical(self, n):
        m2, rad, vis = _sorted_inputs(n, seed=n + 3)
        ref = jt._bin_gaussians_rows(jnp.asarray(m2), jnp.asarray(rad),
                                     jnp.asarray(vis), 8, 8, 16, 64,
                                     row_capacity=8192)
        out = tt._bin_gaussians_rows(_t(m2), _t(rad), _t(vis), 8, 8, 16, 64,
                                     row_capacity=8192)
        _assert_tables_equal(out, ref)

    def test_nonsquare_grid(self):
        m2, rad, vis = _sorted_inputs(3000, seed=12, cam=_wide_camera())
        ref = jt._bin_gaussians_rows(jnp.asarray(m2), jnp.asarray(rad),
                                     jnp.asarray(vis), 8, 6, 16, 64,
                                     row_capacity=4096)
        out = tt._bin_gaussians_rows(_t(m2), _t(rad), _t(vis), 8, 6, 16, 64,
                                     row_capacity=4096)
        _assert_tables_equal(out, ref)

    @pytest.mark.parametrize("row_capacity", [0, 300])
    def test_auto_and_overflowing_capacity(self, row_capacity):
        """The auto capacity (rounded up to 256), and a capacity that rows
        overflow (their deepest entries go): same tables as JAX either
        way."""
        m2, rad, vis = _sorted_inputs(5000, seed=17)
        ref = jt._bin_gaussians_rows(jnp.asarray(m2), jnp.asarray(rad),
                                     jnp.asarray(vis), 8, 8, 16, 32,
                                     row_capacity=row_capacity)
        out = tt._bin_gaussians_rows(_t(m2), _t(rad), _t(vis), 8, 8, 16, 32,
                                     row_capacity=row_capacity)
        _assert_tables_equal(out, ref)


class TestChunked:
    @pytest.mark.parametrize("n", [300, 5000])
    def test_tables_identical(self, n):
        m2, rad, vis = _sorted_inputs(n, seed=n + 1)
        ref = jt._bin_gaussians_chunked(jnp.asarray(m2), jnp.asarray(rad),
                                        jnp.asarray(vis), 8, 8, 16, 64)
        out = tt._bin_gaussians_chunked(_t(m2), _t(rad), _t(vis), 8, 8, 16,
                                        64)
        _assert_tables_equal(out, ref)

    def test_large_grid_raises(self):
        m2, rad, vis = (_t(a) for a in _sorted_inputs(77, seed=1))
        with pytest.raises(ValueError, match="254"):
            tt._bin_gaussians_chunked(m2, rad, vis, 255, 8, 16, 64)


BINNING_CFGS = {
    "pairs": dict(binning="pairs"),
    "search-pallas": dict(binning="search", table_build="pallas"),
    "search-xla": dict(binning="search", table_build="xla"),
    "search-auto": dict(binning="search"),
    "stream": dict(binning="stream"),
    "rows": dict(binning="rows"),
    "chunked": dict(binning="chunked"),
}


class TestRenderBinnings:
    N, RES, SEED = 4000, 128, 4

    def _jax_render(self, seed):
        cloud = JCloud.test_cloud(self.N, seed=seed, spread=0.6,
                                  z_offset=-2.0, scale=0.05)
        cfg = jt.TileRendererConfig(backend="xla", binning="search")
        return np.asarray(jt.render_tiled(
            cloud.positions, cloud.scales, cloud.rotations, cloud.colors,
            cloud.opacities, JCamera.default_training(self.RES), config=cfg))

    @pytest.fixture(scope="class")
    def jax_image(self):
        return self._jax_render(self.SEED)

    def _render(self, seed=SEED, **cfg_kw):
        cloud = TCloud.test_cloud(self.N, seed=seed, spread=0.6,
                                  z_offset=-2.0, scale=0.05)
        return tt.render_tiled(
            cloud.positions, cloud.scales, cloud.rotations, cloud.colors,
            cloud.opacities, TCamera.default_training(self.RES),
            config=tt.TileRendererConfig(**cfg_kw))

    @pytest.mark.parametrize("name", list(BINNING_CFGS))
    def test_matches_jax_image(self, jax_image, name):
        out = self._render(**BINNING_CFGS[name])
        assert out.shape == (3, self.RES, self.RES)
        np.testing.assert_allclose(out.numpy(), jax_image, atol=2e-5)

    @pytest.mark.parametrize("name", [k for k in BINNING_CFGS if k != "pairs"])
    def test_port_binnings_bitwise_equal(self, name):
        assert torch.equal(self._render(**BINNING_CFGS[name]),
                           self._render(binning="pairs"))

    def test_isotropic_box_edge_flip(self):
        """Seed 3: one Gaussian's cutoff box ends on a pixel column, and
        the radius (which differs by 7e-4 px between the projections)
        puts that column inside on one side only: 22 of 49 152 values
        differ, by at most 2.3e-4; every other value is within 2e-5."""
        diff = np.abs(self._render(seed=3).numpy() - self._jax_render(3))
        assert (diff > 2e-5).sum() <= 32
        assert diff.max() <= 5e-4

    def test_capacity_rounds_up_to_chunk(self):
        """max_per_tile 100 becomes m_cap 128 before binning, on every
        route."""
        cloud = TCloud.test_cloud(2000, seed=4, spread=0.4, z_offset=-2.0,
                                  scale=0.05)
        packs = []
        for name in ("pairs", "search-auto", "stream"):
            tp = tt.pack_tiles(
                cloud.positions, cloud.scales, cloud.rotations, cloud.colors,
                cloud.opacities, TCamera.default_training(64),
                tt.TileRendererConfig(max_per_tile=100, **BINNING_CFGS[name]))
            assert tp.m_cap == 128 and tp.pack.shape == (16, 128, 12)
            packs.append(tp.pack)
        assert torch.equal(packs[0], packs[1])
        assert torch.equal(packs[0], packs[2])

    def test_auto_picks_search_at_threshold(self, monkeypatch):
        """binning="auto" goes to the search binning from 98 304 Gaussians
        and to the pair binning below."""
        calls = []
        real_search, real_pairs = tt._bin_gaussians_search, tt._bin_gaussians
        monkeypatch.setattr(tt, "_SEARCH_MIN_N", 1000)
        monkeypatch.setattr(
            tt, "_bin_gaussians_search",
            lambda *a, **k: calls.append("search") or real_search(*a, **k))
        monkeypatch.setattr(
            tt, "_bin_gaussians",
            lambda *a, **k: calls.append("pairs") or real_pairs(*a, **k))
        for n in (999, 1000):
            m2, rad, vis = (_t(a) for a in _sorted_inputs(n, seed=2))
            tt.bin_tiles(m2, rad, vis, 8, 8, 64, tt.TileRendererConfig())
        assert calls == ["pairs", "search"]

    def test_unknown_binning_raises(self):
        with pytest.raises(ValueError, match="binning"):
            self._render(binning="quadtree")
        with pytest.raises(ValueError, match="table_build"):
            self._render(table_build="mosaic")
