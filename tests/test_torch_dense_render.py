"""Port parity: the dense and simplified renderers and the quantised depth
sorts against the JAX package on the CPU.

* `render_dense` and `render_simplified` (the plain versions of K7 / K8,
  the JAX scans' chunked cumprod): image and depth within 1e-5 of each
  field's largest value, and the gradients of a seeded weighted sum of
  image and depth with respect to all five inputs within 1e-4 of each
  one's largest gradient, on 300 Gaussians (more than one chunk of 256 /
  128).  XLA:CPU runs `cumprod` as a scan over blocks of 16 and contracts
  multiply-adds, so the two float32 renders are not bit-exact: they lie
  ~4e-7 (image and depth) and ~6e-7 (gradients) apart, each ~1e-6 and
  ~3e-6 from the port's float64 render, which each case also checks (the
  port's float32 no further from float64 than 2 x JAX's own distance,
  floored at 1e-6).
* A single red Gaussian renders red at the centre and black at the corner
  (tests/test_render.py's check), on both renderers.
* Depth ties in the simplified renderer: Gaussians at one depth in one
  chunk and across chunks, where jax.grad splits the least depth's
  gradient evenly within a chunk (jnp.min) and in halves across them
  (jnp.minimum): the port's depth gradient equals JAX's to 1e-6.
* Alpha at its clip (0.99 dense, 1 simplified): gradients split as
  jnp.clip's.
* The plain compositing over bands of rows gives the whole image's rows
  and, summed, its gradients (how the card's check holds K8 at 512^2).
* The depth sorts "counting" and "packed": the same permutation as JAX's,
  exactly, with ties, invisible Gaussians and N not a multiple of 256;
  "packed" raises above 2^20 Gaussians; `render_tiled` with each.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fresnel_tpu.core.camera import Camera as JCamera
from fresnel_tpu.render import projection as jp
from fresnel_tpu.render import tile as jt
from fresnel_tpu.render.dense import render_dense as jdense
from fresnel_tpu.render.simplified import render_simplified as jsimple

from fresnel_tpu_torch.core.camera import Camera as TCamera
from fresnel_tpu_torch.render import dense_composite as dc
from fresnel_tpu_torch.render import projection as tp
from fresnel_tpu_torch.render import tile as tt
from fresnel_tpu_torch.render.dense import dense_inputs, render_dense
from fresnel_tpu_torch.render.factory import make_renderer
from fresnel_tpu_torch.render.simplified import (
    render_simplified, simplified_inputs)
from test_torch_threads import _few_threads  # noqa: F401

TOL, GRAD_TOL = 1e-5, 1e-4
F64_FACTOR, F64_FLOOR = 2.0, 1e-6
S = 48


def _cloud(seed, n=300, scale=(0.02, 0.12)):
    rng = np.random.default_rng(seed)
    pos = np.c_[rng.uniform(-0.8, 0.8, (n, 2)),
                rng.uniform(-2.5, -1.5, n)].astype(np.float32)
    sc = rng.uniform(*scale, (n, 3)).astype(np.float32)
    rot = rng.normal(size=(n, 4)).astype(np.float32)
    rot /= np.linalg.norm(rot, axis=1, keepdims=True)
    col = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    op = rng.uniform(0.1, 0.9, n).astype(np.float32)
    return [pos, sc, rot, col, op]


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _weights(seed, size=S):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(3, size, size)).astype(np.float32),
            rng.normal(size=(size, size)).astype(np.float32)]


def _run_jax(jrender, arrays, wts):
    jargs = [jnp.asarray(a) for a in arrays]

    def jl(*a):
        return sum(jnp.sum(o * w) for o, w in zip(jrender(*a), wts))

    out = jax.jit(jrender)(*jargs)
    grads = jax.jit(jax.grad(jl, argnums=tuple(range(len(arrays)))))(*jargs)
    return [np.asarray(o) for o in out], [np.asarray(g) for g in grads]


def _run_port(trender, arrays, wts, dtype=torch.float32):
    targs = [torch.from_numpy(a).to(dtype).requires_grad_() for a in arrays]
    out = trender(*targs)
    loss = sum((o * torch.from_numpy(w).to(dtype)).sum()
               for o, w in zip(out, wts))
    grads = torch.autograd.grad(loss, targs, allow_unused=True)
    return ([o.detach().double().numpy() for o in out],
            [np.zeros(a.shape) if g is None else g.double().numpy()
             for a, g in zip(arrays, grads)])


RENDERERS = {
    "dense": (jdense, render_dense),
    "simplified": (jsimple, render_simplified),
}


def _pair(name, size=S, **kw):
    jf, tf = RENDERERS[name]
    jcam, tcam = JCamera.default_training(size), TCamera.default_training(size)

    def jr(p, s, r, c, o):
        return jf(p, s, r, c, o, jcam, return_depth=True, **kw)

    def tr(p, s, r, c, o):
        return tf(p, s, r, c, o, tcam, return_depth=True, **kw)
    return jr, tr


@pytest.mark.parametrize("name", ["dense", "simplified"])
def test_renderer_matches_jax(name):
    # The simplified renderer's radii are clipped to [1, 20] px: larger
    # scales keep most of them inside, where the scales get a gradient.
    arrays = (_cloud(0) if name == "dense"
              else _cloud(1, scale=(0.1, 0.6)))
    wts = _weights(2)
    jr, tr = _pair(name)
    jo, jg = _run_jax(jr, arrays, wts)
    to, tg = _run_port(tr, arrays, wts)
    t64, tg64 = _run_port(tr, arrays, wts, dtype=torch.float64)
    assert jo[0].shape == (3, S, S) and jo[1].shape == (S, S)
    for field, g, w, ref in zip(("image", "depth"), to, jo, t64):
        assert _rel(g, w) <= TOL, (field, _rel(g, w))
        assert _rel(g, ref) <= max(F64_FACTOR * _rel(w, ref), F64_FLOOR)
    for i, (g, w, ref) in enumerate(zip(tg, jg, tg64)):
        # (the simplified renderer is isotropic: no rotation gradient)
        assert np.abs(w).max() > 0 or (name, i) == ("simplified", 2), i
        assert _rel(g, w) <= GRAD_TOL, (i, _rel(g, w))
        assert _rel(g, ref) <= max(F64_FACTOR * _rel(w, ref), F64_FLOOR), i


@pytest.mark.parametrize("name", ["dense", "simplified"])
def test_single_red_gaussian(name):
    arrays = [np.zeros((1, 3), np.float32), np.full((1, 3), 0.3, np.float32),
              np.array([[1.0, 0, 0, 0]], np.float32),
              np.array([[1.0, 0, 0]], np.float32),
              np.array([0.95], np.float32)]
    jf, tf = RENDERERS[name]
    img = tf(*[torch.from_numpy(a) for a in arrays],
             TCamera.default_training(64))
    ref = np.asarray(jf(*[jnp.asarray(a) for a in arrays],
                        JCamera.default_training(64)))
    assert img.shape == (3, 64, 64)
    assert img[0, 32, 32] > 0.5 and img[1, 32, 32] < 0.1
    assert img[2, 32, 32] < 0.1 and img[:, 0, 0].max() < 0.05
    assert _rel(img.numpy(), ref) <= TOL


@pytest.mark.parametrize("chunk", [16, 128])
def test_simplified_depth_ties_follow_jax(chunk):
    """Several Gaussians at one depth, in one chunk and across chunks:
    the least depth's gradient splits as jax.grad splits it."""
    n = 72
    rng = np.random.default_rng(5)
    pos = np.c_[rng.uniform(-0.3, 0.3, (n, 2)),
                rng.uniform(-2.4, -1.6, n)].astype(np.float32)
    # Depth-locked patches: three groups share one z each, spread over
    # the index range so that a group straddles chunks of 16.
    for g, idx in enumerate((np.arange(0, 72, 6), np.arange(3, 40, 9),
                             np.arange(10, 20))):
        pos[idx, 2] = np.float32(-1.7 - 0.1 * g)
    sc = rng.uniform(0.04, 0.1, (n, 3)).astype(np.float32)
    rot = np.tile(np.array([[1.0, 0, 0, 0]], np.float32), (n, 1))
    col = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    op = rng.uniform(0.5, 0.95, n).astype(np.float32)
    arrays = [pos, sc, rot, col, op]
    size = 48
    wts = [np.zeros((3, size, size), np.float32),
           rng.normal(size=(size, size)).astype(np.float32)]
    jr, tr = _pair("simplified", size=size, chunk=chunk)
    jo, jg = _run_jax(jr, arrays, wts)
    to, tg = _run_port(tr, arrays, wts)
    assert _rel(to[1], jo[1]) == 0.0
    # The ties are there: pixels whose least depth is shared by hits in
    # one chunk and by hits in several.
    params, _ = simplified_inputs(*[torch.from_numpy(a) for a in
                                    (pos, sc, col, op)],
                                  TCamera.default_training(size))
    Y, X = torch.meshgrid(torch.arange(size, dtype=torch.float32),
                          torch.arange(size, dtype=torch.float32),
                          indexing="ij")
    hit = dc.composite_alpha(params, X, Y, dc.SIMPLE) > dc.HIT_ALPHA
    tied = hit & (params[:, 7, None, None] == torch.from_numpy(to[1]).float())
    chunks = torch.arange(n)[:, None, None] // chunk
    n_tied = tied.sum(0)
    spread = torch.where(tied, chunks, -1).amax(0) \
        - torch.where(tied, chunks, n).amin(0)
    assert (n_tied >= 2).any()
    if chunk == 16:
        assert (spread > 0).any()
    np.testing.assert_allclose(tg[0], jg[0], rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["dense", "simplified"])
def test_alpha_at_its_clip_splits_the_gradient(name):
    """A Gaussian on the optical axis projects onto the centre pixel,
    where opacity 0.99 (dense) or 1 (simplified) puts alpha exactly on the
    clip's bound; a second one has opacity 0, alpha on the lower bound.
    jax.grad splits jnp.clip's gradient at both: the port follows."""
    top = 0.99 if name == "dense" else 1.0
    arrays = [np.array([[0, 0, -2.0], [0.02, 0.01, -2.1], [0.05, -0.03,
                                                           -2.2]],
                       np.float32),
              np.full((3, 3), 0.05, np.float32),
              np.tile(np.array([[1.0, 0, 0, 0]], np.float32), (3, 1)),
              np.array([[1.0, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32),
              np.array([top, 0.0, 0.5], np.float32)]
    wts = _weights(8, size=32)
    jr, tr = _pair(name, size=32)
    jo, jg = _run_jax(jr, arrays, wts)
    to, tg = _run_port(tr, arrays, wts)
    cam = TCamera.default_training(32)
    uv, _ = cam.project(torch.from_numpy(arrays[0][:1]))
    assert uv[0].tolist() == [16.0, 16.0]      # on the centre pixel
    for g, w in zip(to, jo):
        assert _rel(g, w) <= TOL
    for i, (g, w) in enumerate(zip(tg, jg)):
        assert _rel(g, w) <= GRAD_TOL, (i, _rel(g, w))
    assert jg[4][1] != 0.0       # opacity 0 still has a gradient


@pytest.mark.parametrize("mode", [dc.DENSE, dc.SIMPLE])
def test_plain_composite_in_row_bands_sums_to_the_whole(mode):
    """The plain K7 / K8 over bands of rows (`row0`), the way the card's
    check holds K8 at full width, give the whole image's rows and, summed
    over the bands, its gradients: within 1e-6 and 1e-5 of each output's
    and field's largest value (the sums round apart)."""
    arrays = [torch.from_numpy(a) for a in _cloud(13)]
    cam = TCamera.default_training(S)
    with torch.no_grad():
        params, cols = (dense_inputs(*arrays, cam) if mode == dc.DENSE
                        else simplified_inputs(arrays[0], arrays[1],
                                               arrays[3], arrays[4], cam))
        whole, whole_t = dc.dense_composite_plain(params, cols, S, S, mode)
    g_out, g_t = (torch.from_numpy(w) for w in _weights(21))
    g_out = torch.cat([g_out.permute(1, 2, 0), g_t[..., None]], dim=-1)
    if mode == dc.SIMPLE:
        g_out[..., 3] = torch.where(torch.isinf(whole[..., 3]), 0.0,
                                    g_out[..., 3])
    gp, gc = dc.dense_composite_bwd_plain(params, cols, S, S, mode, None,
                                          g_out, g_t)
    sp, sc = torch.zeros_like(gp), torch.zeros_like(gc)
    band = 20                       # S = 48: two bands and a short one
    for y0 in range(0, S, band):
        h = min(band, S - y0)
        with torch.no_grad():
            out, t = dc.dense_composite_plain(params, cols, h, S, mode,
                                              row0=y0)
        fin = torch.isfinite(whole[y0:y0 + h])
        assert torch.equal(fin, torch.isfinite(out))
        assert _rel(out[fin], whole[y0:y0 + h][fin]) <= 1e-6
        assert _rel(t, whole_t[y0:y0 + h]) <= 1e-6
        bp, bc = dc.dense_composite_bwd_plain(
            params, cols, h, S, mode, None,
            g_out[y0:y0 + h].contiguous(), g_t[y0:y0 + h].contiguous(),
            row0=y0)
        sp, sc = sp + bp, sc + bc
    for got, want in ((sp, gp), (sc, gc)):
        for f in range(want.shape[1]):
            if want[:, f].abs().max() > 0:
                assert _rel(got[:, f], want[:, f]) <= 1e-5, f


_jsort = jax.jit(jp.depth_sort_indices, static_argnames="method")


def _sort_case(seed, n):
    rng = np.random.default_rng(seed)
    pos = np.c_[rng.uniform(-0.8, 0.8, (n, 2)),
                rng.uniform(-2.5, -1.5, n)].astype(np.float32)
    pos[10:40, 2] = pos[0, 2]            # ties keep submission order
    pos[40:60, 2] = np.float32(5.0)      # behind the camera: invisible
    sc = rng.uniform(0.02, 0.1, (n, 3)).astype(np.float32)
    rot = rng.normal(size=(n, 4)).astype(np.float32)
    rot /= np.linalg.norm(rot, axis=1, keepdims=True)
    jc = JCamera.default_training(64)
    tc = TCamera.default_training(64)
    pj = jp.project_gaussians(jnp.asarray(pos), jnp.asarray(sc),
                              jnp.asarray(rot), jc)
    pt = tp.project_gaussians(*[torch.from_numpy(a) for a in (pos, sc, rot)],
                              tc)
    return pj, pt


def test_kernel_scratch_sizes():
    """What K7 leaves for K8, as the module's docstring sizes it: per 32 x
    16 tile a run of 512 transmittances for every 16 Gaussians it could
    list (359 MB at 512^2 with the decoded cloud's 5 476), and one int32
    buffer of the lists, the tile boxes, the lists' lengths and the tie
    record."""
    assert dc.n_tiles(512, 512) == 512 and dc.n_tiles(33, 47) == 2 * 3
    assert dc.checkpoint_shape(5476, 512, 512) == (512, 343, 512)
    assert 4 * int(np.prod(dc.checkpoint_shape(5476, 512, 512))) \
        == 359_661_568
    assert dc.checkpoint_shape(0, 33, 47) == (6, 0, 512)
    assert dc.aux_numel(5476, 512, 512) == \
        512 * 5476 + 2 * 5476 + 512 + 3 * 512 * 512
    assert dc.aux_numel(1, 33, 47) == 6 + 2 + 6 + 3 * 33 * 47


@pytest.mark.parametrize("method", ["counting", "packed"])
@pytest.mark.parametrize("n", [300, 700])
def test_quantized_depth_sorts_match_jax(method, n):
    pj, pt = _sort_case(3, n)
    assert not pt.visible.all()
    got = tp.depth_sort_indices(pt, method=method).numpy()
    want = np.asarray(_jsort(pj, method))
    np.testing.assert_array_equal(got, want)
    assert sorted(got.tolist()) == list(range(n))


def test_quantized_depth_sorts_with_none_visible_match_jax():
    pj, pt = _sort_case(4, 100)
    pj = jp.GaussianProjection(**{**pj.__dict__,
                                  "visible": jnp.zeros(100, bool)})
    pt = pt.replace(visible=torch.zeros(100, dtype=torch.bool))
    for method in ("counting", "packed", "other"):
        np.testing.assert_array_equal(
            tp.depth_sort_indices(pt, method=method).numpy(),
            np.asarray(_jsort(pj, method)))


def test_packed_sort_refuses_more_than_2_20():
    n = (1 << 20) + 1
    proj = tp.GaussianProjection(
        means2d=torch.zeros((n, 2)), cov2d=torch.zeros((n, 2, 2)),
        conic=torch.zeros((n, 3)), depths=torch.ones(n),
        radii=torch.ones(n), visible=torch.ones(n, dtype=torch.bool))
    with pytest.raises(ValueError, match="2\\^20"):
        tp.depth_sort_indices(proj, method="packed")


@pytest.mark.parametrize("method", ["counting", "packed"])
def test_render_tiled_with_quantized_sort_matches_jax(method):
    arrays = _cloud(6, n=200)
    kw = dict(depth_sort=method, max_per_tile=64)
    jcfg, tcfg = jt.TileRendererConfig(**kw), tt.TileRendererConfig(**kw)
    j = jt.render_tiled(*[jnp.asarray(a) for a in arrays],
                        JCamera.default_training(48), return_depth=True,
                        config=jcfg)
    t = tt.render_tiled(*[torch.from_numpy(a) for a in arrays],
                        TCamera.default_training(48), return_depth=True,
                        config=tcfg)
    for g, w in zip(t, j):
        assert _rel(g.numpy(), np.asarray(w)) <= TOL


@pytest.mark.parametrize("name", ["dense", "simplified"])
def test_make_renderer_renders_on_the_cpu(name):
    arrays = _cloud(7, n=50)
    r = make_renderer(name)
    img, depth = r(*[torch.from_numpy(a) for a in arrays],
                   TCamera.default_training(32), return_depth=True)
    ref = RENDERERS[name][1](*[torch.from_numpy(a) for a in arrays],
                             TCamera.default_training(32), return_depth=True)
    assert torch.equal(img, ref[0]) and torch.equal(depth, ref[1])
    assert not r.supports_overflow
