"""Port parity: the tiled renderer at tile sizes other than 16, on the CPU.

The JAX package renders any `tile_size` through its XLA scan compositor
(`backend="xla"`; a tile other than 16 never reaches its Pallas kernel),
and its stream binning in interpret mode.  At 64^2, against it:

* `render_tiled` at tile sizes 4, 8, 12 and 32 under the "pairs" and
  "search" binnings, and at 8 and 32 under "stream" (32 to 300
  Gaussians): the image and the
  transmittance within 2e-5, depth within 1e-4 (tests/test_torch_tile.py's
  bounds at 16), the overflow telemetry equal;
* at 8 and 32, the gradients of all five inputs of a seeded weighted sum
  of image and depth within 1e-4 of each one's largest gradient, and the
  phase-blended route (unit-interval phases): image and depth within
  1e-5 of their largest value, the gradients of all six inputs within
  1e-4 (tests/test_torch_wave_render.py's bounds at 16);
* `render_with_stats` at 8: the tile count and the overflow integers
  equal to the JAX function's;
* `render_tiled_batched` at 8 equal, bit for bit, to one `render_tiled`
  per image;
* a tile size below 1 raises ValueError (the JAX package divides by zero).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fresnel_tpu.core.camera import Camera as JCamera
from fresnel_tpu.render import tile as jt
from fresnel_tpu.utils import profiling as jprof

from fresnel_tpu_torch.core.camera import Camera as TCamera
from fresnel_tpu_torch.render import raster, tile as tt
from fresnel_tpu_torch.utils import profiling as tprof
from test_torch_threads import _few_threads  # noqa: F401

S = 64
TOL, GRAD_TOL = 1e-5, 1e-4


def _cloud(n, seed):
    """A seeded cloud in front of the default camera and unit-interval
    phases: ([positions, scales, rotations, colors, opacities], phases)."""
    rng = np.random.default_rng(seed)
    pos = np.c_[rng.uniform(-0.8, 0.8, (n, 2)),
                rng.uniform(-2.5, -1.5, n)].astype(np.float32)
    sc = rng.uniform(0.02, 0.12, (n, 3)).astype(np.float32)
    rot = rng.normal(size=(n, 4)).astype(np.float32)
    rot /= np.linalg.norm(rot, axis=1, keepdims=True)
    col = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    op = rng.uniform(0.1, 0.9, n).astype(np.float32)
    ph = rng.uniform(0, 1, n).astype(np.float32)
    return [pos, sc, rot, col, op], ph


def _configs(**kw):
    return (jt.TileRendererConfig(backend="xla", pallas_interpret=True, **kw),
            tt.TileRendererConfig(**kw))


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


# (tile size, binning, Gaussians): every size under "pairs" and "search",
# and "stream" (JAX's Pallas kernel in interpret mode, ~6 s a render) at 8
# and 32; N from 32 to 300; max_per_tile 64 so that some tiles overflow.
RENDER_CASES = ([(ts, b, n) for ts, n in ((4, 32), (8, 300), (12, 120),
                                          (32, 300))
                 for b in ("pairs", "search")]
                + [(8, "stream", 300), (32, "stream", 300)])


@pytest.mark.parametrize("ts,binning,n", RENDER_CASES)
def test_render_tiled_matches_jax(ts, binning, n):
    arrays, _ = _cloud(n, seed=ts + n)
    jcfg, tcfg = _configs(tile_size=ts, binning=binning, max_per_tile=64)
    kw = dict(return_depth=True, return_transmittance=True,
              return_overflow=True)
    ji, jd, jtr, jo = jt.render_tiled(*[jnp.asarray(a) for a in arrays],
                                      JCamera.default_training(S),
                                      config=jcfg, **kw)
    ti, td, ttr, to = tt.render_tiled(*[torch.from_numpy(a) for a in arrays],
                                      TCamera.default_training(S),
                                      config=tcfg, **kw)
    assert ti.shape == (3, S, S) and td.shape == ttr.shape == (S, S)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=2e-5)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-4)
    np.testing.assert_allclose(ttr.numpy(), np.asarray(jtr), atol=2e-5)
    assert to.tolist() == np.asarray(jo).tolist()
    assert raster.launches == 0      # CPU tensors never launch a kernel


def _jax_and_port(ts, arrays, phased, seed):
    """JAX's and the port's (image, depth) and the gradients of
    sum(w_k * out_k) with respect to every input, at tile size ts."""
    jcfg, tcfg = _configs(tile_size=ts, max_per_tile=64,
                          use_phase_blending=phased, phase_amplitude=0.3)
    jcam, tcam = JCamera.default_training(S), TCamera.default_training(S)
    rng = np.random.default_rng(seed)
    wts = [rng.normal(size=(3, S, S)).astype(np.float32),
           rng.normal(size=(S, S)).astype(np.float32)]

    def jr(*a):
        return jt.render_tiled(*a[:5], jcam, phases=a[5] if phased else None,
                               return_depth=True, config=jcfg)

    def jl(*a):
        return sum(jnp.sum(o * w) for o, w in zip(jr(*a), wts))

    jargs = [jnp.asarray(a) for a in arrays]
    jout = jr(*jargs)
    jg = jax.grad(jl, argnums=tuple(range(len(arrays))))(*jargs)
    targs = [torch.from_numpy(a).requires_grad_() for a in arrays]
    tout = tt.render_tiled(*targs[:5], tcam,
                           phases=targs[5] if phased else None,
                           return_depth=True, config=tcfg)
    tg = torch.autograd.grad(
        sum((o * torch.from_numpy(w)).sum() for o, w in zip(tout, wts)),
        targs)
    return ([np.asarray(o) for o in jout], [o.detach().numpy() for o in tout],
            [np.asarray(g) for g in jg], [g.numpy() for g in tg])


@pytest.mark.parametrize("ts", [8, 32])
def test_gradients_match_jax(ts):
    arrays, _ = _cloud(200, seed=ts)
    jo, to, jg, tg = _jax_and_port(ts, arrays, False, ts + 1)
    np.testing.assert_allclose(to[0], jo[0], atol=2e-5)
    np.testing.assert_allclose(to[1], jo[1], atol=1e-4)
    assert len(tg) == 5
    for i, (g, w) in enumerate(zip(tg, jg)):
        assert np.abs(w).max() > 0, i
        assert _rel(g, w) <= GRAD_TOL, (i, _rel(g, w))


@pytest.mark.parametrize("ts", [8, 32])
def test_phase_blended_matches_jax(ts):
    arrays, ph = _cloud(150, seed=ts + 2)
    jo, to, jg, tg = _jax_and_port(ts, arrays + [ph], True, ts + 3)
    for name, g, w in zip(("image", "depth"), to, jo):
        assert _rel(g, w) <= TOL, (name, _rel(g, w))
    for i, (g, w) in enumerate(zip(tg, jg)):
        assert _rel(g, w) <= GRAD_TOL, (i, _rel(g, w))
    # The phases change the image: the route is not the plain one.
    plain = tt.render_tiled(*[torch.from_numpy(a) for a in arrays],
                            TCamera.default_training(S),
                            config=tt.TileRendererConfig(tile_size=ts,
                                                         max_per_tile=64))
    assert not np.allclose(plain.numpy(), to[0])


def test_render_with_stats_tile_count():
    arrays, _ = _cloud(300, seed=5)
    jcfg, tcfg = _configs(tile_size=8, max_per_tile=32)
    jimg, js = jprof.render_with_stats(*[jnp.asarray(a) for a in arrays],
                                       JCamera.default_training(S),
                                       config=jcfg)
    img, st = tprof.render_with_stats(*[torch.from_numpy(a) for a in arrays],
                                      TCamera.default_training(S),
                                      config=tcfg)
    assert st.num_tiles == js.num_tiles == (S // 8) ** 2
    fields = ("num_visible", "dropped_pairs", "total_pairs",
              "overflow_tiles", "max_tile_hits")
    assert {f: getattr(st, f) for f in fields} == {
        f: getattr(js, f) for f in fields}
    assert st.dropped_pairs > 0
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), atol=2e-5)


def test_batched_equals_per_image():
    B, n = 3, 120
    clouds = [_cloud(n, seed=30 + b) for b in range(B)]
    stacked = [torch.from_numpy(np.stack([c[0][i] for c in clouds]))
               for i in range(5)]
    phases = torch.from_numpy(np.stack([c[1] for c in clouds]))
    cam = TCamera.default_training(40)      # 5 x 5 tiles of 8
    for phased in (False, True):
        cfg = tt.TileRendererConfig(tile_size=8, max_per_tile=64,
                                    use_phase_blending=phased)
        imgs, depths, ovf = tt.render_tiled_batched(*stacked, cam, config=cfg,
                                                    phases=phases)
        assert imgs.shape == (B, 3, 40, 40)
        for b in range(B):
            img, depth, o = tt.render_tiled(
                *[x[b] for x in stacked], cam, phases=phases[b],
                return_depth=True, return_overflow=True, config=cfg)
            assert torch.equal(imgs[b], img) and torch.equal(depths[b], depth)
            assert torch.equal(ovf[b], o)


@pytest.mark.parametrize("ts", [0, -4])
def test_tile_size_below_one_raises(ts):
    arrays, _ = _cloud(8, seed=0)
    with pytest.raises(ValueError, match="tile_size"):
        tt.render_tiled(*[torch.from_numpy(a) for a in arrays],
                        TCamera.default_training(32),
                        config=tt.TileRendererConfig(tile_size=ts))
