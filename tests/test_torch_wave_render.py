"""Port parity: the wave-optics renderers against the JAX package on the
CPU.

* `render_tiled` with phase blending, scalar and per-RGB phases, with and
  without the box test (hard_cutoff), and with `hard_cutoff=False` alone.
  With phases in [0, 1) (the unit interval the JAX compositor reads them
  in): images and depth within 1e-5 of each field's largest value, the
  gradients of a seeded weighted sum of image and depth with respect to
  every input within 1e-4 of each one's largest gradient.  The decoders
  emit radians in [0, 2 pi), which the reference blends as unit-interval
  fractions (`min(d, 1 - d)` of radian differences, tile.py:698-699): the
  interference's cos then takes arguments up to ~40, where XLA:CPU's
  float32 cos is up to 2.8e-5 off, and the running phase amplifies it.
  There both float32 renders lie ~5e-3 (of the largest gradient) from the
  port's float64 render, about 10x further than from each other, so the
  radian case holds the port's float32 within 1e-4 (images), 1e-3 (depth
  and gradients) of JAX's, and no further from float64 than JAX's own
  float32 is (times 1.25).
* `render_wave_field` (scalar and per-RGB phases) and `render_fourier`
  "spatial": images and depth within 1e-5, gradients within 1e-4; their
  batched entries equal one render per cloud bit for bit.
* The renderer factory's routes, and the four renderers that raised
  until they were ported (tests/test_torch_dense_render.py,
  test_torch_asm_fourier.py) through it.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fresnel_tpu.core.camera import Camera as JCamera
from fresnel_tpu.render import tile as jt
from fresnel_tpu.render.fourier import render_fourier as jfourier
from fresnel_tpu.render.wave import render_wave_field as jwave
from fresnel_tpu.train import config as jconfig

from fresnel_tpu_torch.core.camera import Camera as TCamera
from fresnel_tpu_torch.render import factory, fourier, tile as tt, wave
from fresnel_tpu_torch.train import config as tconfig
from test_torch_threads import _few_threads  # noqa: F401

TOL, GRAD_TOL = 1e-5, 1e-4
RADIAN_TOL = dict(image=1e-4, depth=1e-3, grad=1e-3)
S = 48


def _cloud(seed, n=300, phmax=1.0):
    rng = np.random.default_rng(seed)
    pos = np.c_[rng.uniform(-0.8, 0.8, (n, 2)),
                rng.uniform(-2.5, -1.5, n)].astype(np.float32)
    sc = rng.uniform(0.02, 0.12, (n, 3)).astype(np.float32)
    rot = rng.normal(size=(n, 4)).astype(np.float32)
    rot /= np.linalg.norm(rot, axis=1, keepdims=True)
    col = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    op = rng.uniform(0.1, 0.9, n).astype(np.float32)
    ph = rng.uniform(0, phmax, (n, 3)).astype(np.float32)
    return [pos, sc, rot, col, op], ph


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _jax_and_port(jrender, trender, arrays, wts, dtype=torch.float32):
    """(jax outputs, port outputs, jax grads, port grads) of
    sum(w_k * out_k) over the renderers' (image, depth)."""
    jargs = [jnp.asarray(a) for a in arrays]

    def jl(*a):
        outs = jrender(*a)
        return sum(jnp.sum(o * w) for o, w in zip(outs, wts))

    jout = jrender(*jargs)
    jg = jax.grad(jl, argnums=tuple(range(len(arrays))))(*jargs)
    targs = [torch.from_numpy(a).to(dtype).requires_grad_() for a in arrays]
    tout = trender(*targs)
    loss = sum((o * torch.from_numpy(w).to(dtype)).sum()
               for o, w in zip(tout, wts))
    tg = torch.autograd.grad(loss, targs)
    return ([np.asarray(o) for o in jout],
            [o.detach().double().numpy() for o in tout],
            [np.asarray(g) for g in jg], [g.double().numpy() for g in tg])


def _weights(seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(3, S, S)).astype(np.float32),
            rng.normal(size=(S, S)).astype(np.float32)]


def _tiled(phased, rgb, hard_cutoff):
    kw = dict(use_phase_blending=phased, phase_amplitude=0.3,
              hard_cutoff=hard_cutoff, max_per_tile=64)
    jcfg, tcfg = jt.TileRendererConfig(**kw), tt.TileRendererConfig(**kw)
    jcam, tcam = JCamera.default_training(S), TCamera.default_training(S)

    def pick(ph):
        return ph if rgb else ph[..., 0]

    def jr(p, s, r, c, o, ph=None):
        return jt.render_tiled(p, s, r, c, o, jcam,
                               phases=None if ph is None else pick(ph),
                               return_depth=True, config=jcfg)

    def tr(p, s, r, c, o, ph=None):
        return tt.render_tiled(p, s, r, c, o, tcam,
                               phases=None if ph is None else pick(ph),
                               return_depth=True, config=tcfg)
    return jr, tr


@pytest.mark.parametrize("rgb", [False, True])
@pytest.mark.parametrize("hard_cutoff", [True, False])
def test_phase_blended_render_tiled_matches_jax(rgb, hard_cutoff):
    arrays, ph = _cloud(0)
    jr, tr = _tiled(True, rgb, hard_cutoff)
    jo, to, jg, tg = _jax_and_port(jr, tr, arrays + [ph], _weights(1))
    for name, g, w in zip(("image", "depth"), to, jo):
        assert _rel(g, w) <= TOL, (name, _rel(g, w))
    for i, (g, w) in enumerate(zip(tg, jg)):
        assert _rel(g, w) <= GRAD_TOL, (i, _rel(g, w))
    if not rgb:
        assert not np.any(tg[5][:, 1:])   # only the first channel blends


def test_phase_blended_radian_phases_match_jax():
    arrays, ph = _cloud(2, phmax=2 * np.pi)
    jr, tr = _tiled(True, True, True)
    wts = _weights(3)
    jo, to, jg, tg = _jax_and_port(jr, tr, arrays + [ph], wts)
    _, t64, _, tg64 = _jax_and_port(jr, tr, arrays + [ph], wts,
                                    dtype=torch.float64)
    assert _rel(to[0], jo[0]) <= RADIAN_TOL["image"]
    assert _rel(to[1], jo[1]) <= RADIAN_TOL["depth"]
    for i, (g, w, ref) in enumerate(zip(tg, jg, tg64)):
        assert _rel(g, w) <= RADIAN_TOL["grad"], (i, _rel(g, w))
        assert _rel(g, ref) <= 1.25 * _rel(w, ref), (i, _rel(g, ref),
                                                     _rel(w, ref))


def test_hard_cutoff_false_matches_jax_scan():
    """No box test, as the JAX package's XLA scan composites it (its TPU
    kernel would keep the box)."""
    arrays, _ = _cloud(4)
    jr, tr = _tiled(False, False, False)
    jo, to, jg, tg = _jax_and_port(jr, tr, arrays, _weights(5))
    for g, w in zip(to, jo):
        assert _rel(g, w) <= TOL
    for g, w in zip(tg, jg):
        assert _rel(g, w) <= GRAD_TOL
    _, boxed = _tiled(False, False, True)
    img_box = boxed(*[torch.from_numpy(a) for a in arrays])[0]
    assert not np.allclose(img_box.numpy(), to[0])


def test_phase_blending_without_phases_is_plain():
    arrays, _ = _cloud(6)
    _, tr = _tiled(True, False, True)
    _, plain = _tiled(False, False, True)
    a = [torch.from_numpy(x) for x in arrays]
    for g, w in zip(tr(*a), plain(*a)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("rgb", [False, True])
def test_render_wave_field_matches_jax(rgb):
    arrays, ph = _cloud(7, phmax=2 * np.pi)
    jcam, tcam = JCamera.default_training(S), TCamera.default_training(S)

    def pick(p):
        return p if rgb else p[:, 0]

    jo, to, jg, tg = _jax_and_port(
        lambda *a: jwave(*a[:5], jcam, pick(a[5]), return_depth=True),
        lambda *a: wave.render_wave_field(*a[:5], tcam, pick(a[5]),
                                          return_depth=True),
        arrays + [ph], _weights(8))
    for g, w in zip(to, jo):
        assert _rel(g, w) <= TOL
    for i, (g, w) in enumerate(zip(tg, jg)):
        assert _rel(g, w) <= GRAD_TOL, (i, _rel(g, w))


def test_render_fourier_spatial_matches_jax():
    arrays, _ = _cloud(9)
    jcam, tcam = JCamera.default_training(S), TCamera.default_training(S)
    jo, to, jg, tg = _jax_and_port(
        lambda *a: jfourier(*a, jcam, return_depth=True),
        lambda *a: fourier.render_fourier(*a, tcam, return_depth=True),
        arrays, _weights(10))
    assert _rel(to[0], jo[0]) <= TOL
    assert not np.any(to[1]) and not np.any(jo[1])
    for i, (g, w) in enumerate(zip(tg, jg)):
        assert _rel(g, w) <= GRAD_TOL, (i, _rel(g, w))


def _batch(seed, B=3):
    clouds = [_cloud(seed + b, n=200, phmax=2 * np.pi) for b in range(B)]
    fields = [torch.from_numpy(np.stack([c[0][k] for c in clouds]))
              for k in range(5)]
    return fields, torch.from_numpy(np.stack([c[1] for c in clouds]))


def test_batched_renders_equal_one_by_one():
    """Each image of a batch is its own render: the wave field's and the
    Fourier renderer's normalisation by each image's largest value, and
    the phase-blended tiled render, with a camera per image."""
    fields, ph = _batch(11)
    cams = [TCamera.from_pose(0.0, a, S) for a in (0.0, 0.3, -0.2)]
    img, depth = wave.render_wave_field_batched(*fields, cams, ph)
    for b in range(3):
        one = wave.render_wave_field(*(f[b] for f in fields), cams[b], ph[b],
                                     return_depth=True)
        assert torch.equal(img[b], one[0]) and torch.equal(depth[b], one[1])
    img, depth = fourier.render_fourier_batched(*fields, cams)
    for b in range(3):
        one = fourier.render_fourier(*(f[b] for f in fields), cams[b])
        assert torch.equal(img[b], one)
    cfg = tt.TileRendererConfig(use_phase_blending=True, max_per_tile=64)
    img, depth, _ = tt.render_tiled_batched(*fields, cams, config=cfg,
                                            phases=ph)
    for b in range(3):
        one = tt.render_tiled(*(f[b] for f in fields), cams[b],
                              phases=ph[b], return_depth=True, config=cfg)
        assert torch.equal(img[b], one[0]) and torch.equal(depth[b], one[1])


@pytest.mark.parametrize("over,physics,hfgs,route", [
    (dict(), dict(), dict(), ("TileRenderer", False, 0.25)),
    (dict(use_phase_blending=True, phase_amplitude=0.4), dict(), dict(),
     ("TileRenderer", True, 0.4)),
    (dict(use_phase_blending=True), dict(), dict(use_fourier_renderer=True),
     ("TileRenderer", True, 0.3)),
    (dict(experiment=4, use_phase_blending=True), dict(), dict(),
     ("FourierRenderer",)),
    (dict(experiment=4, use_phase_blending=True),
     dict(use_wave_rendering=True), dict(), ("FourierRenderer",)),
    (dict(), dict(use_wave_rendering=True), dict(), ("WaveRenderer",)),
    (dict(use_phase_blending=True), dict(use_wave_rendering=True), dict(),
     ("WaveRenderer",))])
def test_training_renderer_routes_follow_jax(over, physics, hfgs, route):
    from fresnel_tpu.render.factory import select_training_renderer as jsel

    args_t = (tconfig.TrainingConfig(**over), tconfig.PhysicsConfig(**physics),
              tconfig.HFGSConfig(**hfgs))
    args_j = (jconfig.TrainingConfig(**over), jconfig.PhysicsConfig(**physics),
              jconfig.HFGSConfig(**hfgs))
    r = factory.select_training_renderer(*args_t)
    assert type(r).__name__ == route[0]
    assert r.supports_overflow == getattr(jsel(*args_j), "supports_overflow",
                                          False)
    if route[0] == "TileRenderer":
        assert (r.config.use_phase_blending, r.config.phase_amplitude) == \
            route[1:]


@pytest.mark.parametrize("name", ["dense", "asm", "simplified",
                                  "fourier_true"])
def test_unported_renderers_raise(name):
    """The four renderers these cases held raising are ported
    (tests/test_torch_dense_render.py, test_torch_asm_fourier.py): each
    case keeps its id and checks that its renderer now renders through
    make_renderer, and that the one option of item 5 left, a tile size
    other than 16, still raises naming it."""
    arrays, ph = _cloud(0, n=4)
    targs = [torch.from_numpy(a) for a in arrays]
    cam = TCamera.default_training(16)
    img, depth = factory.make_renderer(name)(
        *targs, cam, phases=torch.from_numpy(ph[:, 0]), return_depth=True)
    assert img.shape == (3, 16, 16) and depth.shape == (16, 16)
    assert torch.isfinite(img).all() and torch.isfinite(depth).all()
    if name == "fourier_true":
        assert torch.equal(img, fourier.render_fourier(
            *targs, cam, phases=torch.from_numpy(ph[:, 0]), mode="fourier"))
    with pytest.raises(NotImplementedError, match="item 5"):
        tt.render_tiled(*targs, cam,
                        config=tt.TileRendererConfig(tile_size=8))


def test_wave_renderer_needs_phases():
    arrays, _ = _cloud(0, n=4)
    with pytest.raises(ValueError, match="requires phases"):
        factory.make_renderer("wave")(*[torch.from_numpy(a) for a in arrays],
                                      TCamera.default_training(16))
