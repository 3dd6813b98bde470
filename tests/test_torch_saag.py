"""Port parity: SAAG geometry (fresnel_tpu_torch/geometry/saag.py) and the
rest of core/gaussians.py against the JAX package, on the CPU, the JAX
side run eagerly as its `infer --saag` and viewer paths run it.

Inputs (64^2, made with numpy from seeds): a step (a silhouette), a ramp
with a step, a tilted plane, a flat background with a raised disc (flat
regions and silhouettes) and the procedural gradient depth of a seeded
image.

* The hash `_pseudo_random`: bit for bit at every pixel of a 512^2 grid,
  for draw indices 0-11 and the size draws 100-111, four seeds.
* `surface_info`, `pointcloud_from_depth` (subsample 1 and 4, with and
  without colour), `PointCloud.normalize` and `pointcloud_to_gaussians`:
  bit for bit.
* `to_surface_gaussians` with every stage on, each stage off, all off,
  and non-default parameters: the masks (opacity > 0 per entry) compared
  directly; an entry active on one side only must sit within 4 ulp of a
  threshold it is tested against (z against 0.01 * depth_scale,
  confidence against min_confidence, the normalised gradient against the
  edge, shell, wrap and density thresholds, the wall tangent and
  gradient-direction lengths against 0.1); measured: no entry parts.
  Every other value: positions, scales, colours and opacities bit for bit
  (measured), rotations within 1e-6.  torch's arccos, cos and sin differ
  from XLA:CPU's by 1-2 ulp; at an angle a the quaternion moves by about
  ulp / sin(a) of the input, but the inputs here are bit for bit, so only
  the outputs' own ulps remain (measured 4.1e-7 at most).
* `feature_guided_surface_gaussians` with random modulation maps (every
  field an (N,) tensor): the same tolerances.
* The GaussianCloud helpers and quaternion_multiply: within 1e-7.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fresnel_tpu.core import gaussians as jg
from fresnel_tpu.geometry import saag as J
from fresnel_tpu.models.encoders import gradient_depth_estimate

from fresnel_tpu_torch.core import gaussians as tg
from fresnel_tpu_torch.geometry import saag as T
from test_torch_threads import _few_threads  # noqa: F401

S = 64
CLOUD_FIELDS = ("positions", "scales", "rotations", "colors", "opacities")


def _depths():
    x = np.linspace(0.0, 1.0, S, dtype=np.float32)
    step = np.full((S, S), 0.2, np.float32)
    step[:, S // 2:] = 0.8
    ramp = (0.3 + 0.35 * x[None, :].repeat(S, 0)).astype(np.float32)
    ramp[:, S // 2:] += 0.25
    tilted = np.broadcast_to(0.2 + 0.6 * x[None, :], (S, S)).astype(
        np.float32)
    yy, xx = np.mgrid[0:S, 0:S]
    disc = np.where((yy - 30) ** 2 + (xx - 34) ** 2 < 15 ** 2, 0.9,
                    0.1).astype(np.float32)
    rng = np.random.default_rng(11)
    img = rng.uniform(size=(16, 16, 3)).astype(np.float32)
    img = jax.image.resize(jnp.asarray(img), (128, 128, 3), "linear")
    proc = np.asarray(gradient_depth_estimate(img, S), np.float32)
    return {"step": step, "ramp_step": ramp, "tilted": np.ascontiguousarray(
        tilted), "disc": disc, "procedural": proc}


DEPTHS = _depths()
COLOR = np.random.default_rng(3).uniform(size=(S, S, 3)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(got, want, key=""):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                  err_msg=key)


def test_hash_bitwise():
    ys, xs = np.mgrid[0:512, 0:512]
    px, py = xs.ravel().astype(np.int32), ys.ravel().astype(np.int32)
    for seed in (12345, 0, 7, 2 ** 32 - 1):
        for i in list(range(12)) + list(range(100, 112)):
            want = J._pseudo_random(jnp.asarray(px), jnp.asarray(py), i, seed)
            got = T._pseudo_random(_t(px), _t(py), i, seed)
            assert got.dtype == torch.float32
            _eq(got, want, (seed, i))


@pytest.mark.parametrize("name", sorted(DEPTHS))
def test_surface_info_bitwise(name):
    d = DEPTHS[name]
    want = J.surface_info(jnp.asarray(d), 50.0)
    got = T.surface_info(_t(d), 50.0)
    assert set(got) == set(want)
    for k, w in want.items():
        _eq(got[k], w, k)


@pytest.mark.parametrize("subsample,with_color", [(1, True), (4, False)])
def test_pointcloud_from_depth_bitwise(subsample, with_color):
    d = DEPTHS["procedural"]
    kw = dict(depth_scale=2.0, subsample=subsample)
    want = J.pointcloud_from_depth(
        jnp.asarray(d), color=jnp.asarray(COLOR) if with_color else None, **kw)
    got = T.pointcloud_from_depth(
        _t(d), color=_t(COLOR) if with_color else None, **kw)
    for k in ("positions", "colors", "confidence", "pixel_xy", "valid"):
        _eq(getattr(got, k), getattr(want, k), k)
    wn, gn = want.normalize(3.0), got.normalize(3.0)
    _eq(gn.positions, wn.positions)
    for a, b in zip(got.bounds(), want.bounds()):
        _eq(a, b)
    wg = J.pointcloud_to_gaussians(wn)
    gg = T.pointcloud_to_gaussians(gn)
    for k in CLOUD_FIELDS:
        _eq(getattr(gg, k), getattr(wg, k), k)


STAGES = {
    "all": {},
    "no_shell": dict(shell=False),
    "no_walls": dict(walls=False),
    "no_wrap": dict(wrap=False),
    "no_density": dict(density=False),
    "none": dict(shell=False, wrap=False, density=False),
    "tuned": dict(normal_strength=0.5, base_size=0.01, edge_threshold=0.3,
                  wall_segments=2, wrap_layers=2, extra_count=2),
}


def _params(mod, stages):
    st = STAGES[stages]
    return (
        mod.SurfaceGaussianParams(
            base_size=st.get("base_size", 0.008),
            edge_threshold=st.get("edge_threshold", 0.15),
            normal_strength=st.get("normal_strength", 1.0)),
        mod.SilhouetteWrapParams(enabled=st.get("wrap", True),
                                 wrap_layers=st.get("wrap_layers", 3)),
        mod.VolumetricShellParams(enabled=st.get("shell", True),
                                  connect_walls=st.get("walls", True),
                                  wall_segments=st.get("wall_segments", 3)),
        mod.AdaptiveDensityParams(enabled=st.get("density", True),
                                  extra_count=st.get("extra_count", 4)))


def _ulps(a, b):
    """|a - b| in float32 ulps of the threshold b (a float or a tensor)."""
    b = np.asarray(b.numpy() if torch.is_tensor(b) else b, np.float32)
    return np.abs(a.astype(np.float64) - b) / np.spacing(np.abs(b))


def _margins(pc, depth, sp, wp, shp, dp, depth_scale):
    """Per point, the smallest distance (in ulps) from any value its
    masks test to that test's threshold (the port's values)."""
    px = pc.pixel_xy[:, 0].long()
    py = pc.pixel_xy[:, 1].long()
    info = T.surface_info(depth, sp.gradient_scale)
    gm = info["gradient_mag"][py, px]
    gd = info["gradient_dir"][py, px]
    ng = (gm / torch.clamp(torch.where(pc.valid, gm, 0.0).max(),
                           min=1e-6)).numpy()
    conf = pc.confidence.numpy()
    z = (1.0 - conf) * np.float32(depth_scale)
    m = [_ulps(z, 0.01 * depth_scale), _ulps(conf, sp.min_confidence)]
    for thr in (sp.edge_threshold, shp.edge_threshold, wp.edge_threshold,
                dp.gradient_threshold):
        m.append(_ulps(ng, thr))
    m.append(_ulps(torch.linalg.norm(gd, dim=-1).numpy(), 0.1))
    return np.min(m, axis=0)


def _compare_clouds(got, want, margins, n):
    gm = got.opacities.numpy() > 0
    wm = np.asarray(want.opacities) > 0
    parted = np.nonzero(gm != wm)[0]
    assert (margins[parted % n] <= 4).all(), parted
    keep = np.ones(gm.shape, bool)
    keep[parted] = False
    for k in CLOUD_FIELDS:
        a, b = getattr(got, k).numpy(), np.asarray(getattr(want, k))
        assert a.shape == b.shape, k
        tol = 1e-6 if k == "rotations" else 0.0
        np.testing.assert_allclose(a[keep], b[keep], rtol=0, atol=tol,
                                   err_msg=k)
    return len(parted)


@pytest.mark.parametrize("stages", sorted(STAGES))
@pytest.mark.parametrize("name", ["disc", "procedural", "ramp_step"])
def test_to_surface_gaussians(name, stages):
    d = DEPTHS[name]
    ds = 2.0
    wpc = J.pointcloud_from_depth(jnp.asarray(d), color=jnp.asarray(COLOR),
                                  depth_scale=ds).normalize(3.0)
    tpc = T.pointcloud_from_depth(_t(d), color=_t(COLOR),
                                  depth_scale=ds).normalize(3.0)
    want = J.to_surface_gaussians(wpc, jnp.asarray(d),
                                  *_params(J, stages), opacity=0.8)
    tparams = _params(T, stages)
    got = T.to_surface_gaussians(tpc, _t(d), *tparams, opacity=0.8)
    margins = _margins(tpc, _t(d), *tparams, ds)
    assert _compare_clouds(got, want, margins, S * S) == 0


def test_subsampled_cloud_reads_the_full_resolution_maps():
    """A cloud subsampled by 8 (the training prior's) indexes the 64^2
    surface maps at its own pixels."""
    d = DEPTHS["procedural"]
    wpc = J.pointcloud_from_depth(jnp.asarray(d), depth_scale=2.0,
                                  subsample=8).normalize(3.0)
    tpc = T.pointcloud_from_depth(_t(d), depth_scale=2.0,
                                  subsample=8).normalize(3.0)
    want = J.to_surface_gaussians(wpc, jnp.asarray(d))
    got = T.to_surface_gaussians(tpc, _t(d))
    params = _params(T, "all")
    assert got.num_gaussians == 12 * 64
    _compare_clouds(got, want, _margins(tpc, _t(d), *params, 2.0), 64)


def test_batched_equals_one_at_a_time():
    d = np.stack([DEPTHS["disc"], DEPTHS["procedural"]])
    col = np.stack([COLOR, COLOR[::-1]])
    pc = T.pointcloud_from_depth(_t(d), color=_t(col), depth_scale=2.0,
                                 subsample=2).normalize(3.0)
    both = T.to_surface_gaussians(pc, _t(d))
    for b in range(2):
        one_pc = T.pointcloud_from_depth(_t(d[b]), color=_t(col[b]),
                                         depth_scale=2.0,
                                         subsample=2).normalize(3.0)
        one = T.to_surface_gaussians(one_pc, _t(d[b]))
        for k in CLOUD_FIELDS:
            assert torch.equal(getattr(both, k)[b], getattr(one, k)), k


def test_feature_guided_surface_gaussians():
    d = DEPTHS["disc"]
    rng = np.random.default_rng(8)
    mods = {"base_size_mult": 1.0 + 0.5 * rng.uniform(-1, 1, (37, 37)),
            "aspect_ratio_mult": 1.0 + 0.5 * rng.uniform(-1, 1, (37, 37)),
            "edge_threshold_add": 0.1 * rng.uniform(-1, 1, (37, 37)),
            "edge_shrink_mult": 1.0 + 0.3 * rng.uniform(-1, 1, (37, 37)),
            "normal_strength_mult": 1.0 + 0.3 * rng.uniform(-1, 1, (37, 37)),
            "opacity_mult": 1.0 + 0.3 * rng.uniform(-1, 1, (37, 37))}
    mods = {k: v.astype(np.float32) for k, v in mods.items()}
    wpc = J.pointcloud_from_depth(jnp.asarray(d), color=jnp.asarray(COLOR),
                                  depth_scale=2.0).normalize(3.0)
    tpc = T.pointcloud_from_depth(_t(d), color=_t(COLOR),
                                  depth_scale=2.0).normalize(3.0)
    want = J.feature_guided_surface_gaussians(
        wpc, jnp.asarray(d), {k: jnp.asarray(v) for k, v in mods.items()})
    got = T.feature_guided_surface_gaussians(
        tpc, _t(d), {k: _t(v) for k, v in mods.items()})
    wp = J.modulated_surface_params(J.SurfaceGaussianParams(),
                                    {k: jnp.asarray(v)
                                     for k, v in mods.items()},
                                    wpc.pixel_xy, (S, S))
    tp = T.modulated_surface_params(T.SurfaceGaussianParams(),
                                    {k: _t(v) for k, v in mods.items()},
                                    tpc.pixel_xy, (S, S))
    for f in ("base_size", "aspect_ratio", "edge_threshold", "edge_shrink",
              "normal_strength"):
        _eq(getattr(tp, f), getattr(wp, f), f)
    margins = _margins(tpc, _t(d), tp, *_params(T, "all")[1:], 2.0)
    assert _compare_clouds(got, want, margins, S * S) == 0


def test_rotation_helpers():
    rng = np.random.default_rng(4)
    n = rng.normal(size=(2000, 3)).astype(np.float32)
    n[:500, :2] *= 1e-3                       # near +-Z (small angles)
    n[500:510] = [0.0, 0.0, 1.0]
    n[510:520] = [0.0, 0.0, -1.0]
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    wq = J.quaternion_from_normal(jnp.asarray(n))
    tq = T.quaternion_from_normal(_t(n))
    np.testing.assert_allclose(tq.numpy(), np.asarray(wq), rtol=0, atol=1e-6)
    for t in (1.0, 0.5, 0.0):
        np.testing.assert_allclose(
            T.slerp_from_identity(tq, t).numpy(),
            np.asarray(J.slerp_from_identity(wq, t)), rtol=0, atol=1e-6)


def test_gaussian_cloud_helpers_match_jax():
    rng = np.random.default_rng(6)

    def cloud(mod, n, seed):
        r = np.random.default_rng(seed)
        q = r.normal(size=(n, 4)).astype(np.float32)
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        f = (r.normal(size=(n, 3)), r.uniform(0.01, 0.2, (n, 3)), q,
             r.uniform(size=(n, 3)), r.uniform(size=n))
        conv = (lambda a: jnp.asarray(np.float32(a))) if mod is jg else (
            lambda a: _t(np.float32(a)))
        return mod.GaussianCloud(*map(conv, f))

    a, b = cloud(jg, 50, 1), cloud(tg, 50, 1)
    np.testing.assert_allclose(b.covariance_3d().numpy(),
                               np.asarray(a.covariance_3d()), atol=1e-7)
    for x, y in zip(b.bounds(), a.bounds()):
        _eq(x, y)
    _eq(b.center().positions, a.center().positions)
    na, nb = a.normalize(2.0), b.normalize(2.0)
    for k in ("positions", "scales"):
        np.testing.assert_allclose(getattr(nb, k).numpy(),
                                   np.asarray(getattr(na, k)), atol=1e-7)
    ca, cb = a.concatenate(cloud(jg, 7, 2)), b.concatenate(cloud(tg, 7, 2))
    assert len(cb) == 57
    for k in CLOUD_FIELDS:
        _eq(getattr(cb, k), getattr(ca, k), k)
    assert torch.equal(b.replace(opacities=b.opacities * 0).opacities,
                       torch.zeros(50))
    q1 = rng.normal(size=(100, 4)).astype(np.float32)
    q2 = rng.normal(size=(100, 4)).astype(np.float32)
    np.testing.assert_allclose(
        tg.quaternion_multiply(_t(q1), _t(q2)).numpy(),
        np.asarray(jg.quaternion_multiply(jnp.asarray(q1), jnp.asarray(q2))),
        atol=1e-7)
