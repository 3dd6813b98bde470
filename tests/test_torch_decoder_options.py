"""Port parity: the decoders' options against the JAX package on the CPU.

The modules `FresnelEdgeDetector`, `PoseEncoder` (with
`sinusoidal_encode`) and `DepthEncoder` (with `adaptive_average_pool`),
`head_transform` with Fresnel zones and phase output, and
`DirectPatchDecoder` and `FibonacciPatchDecoder` with each option, are
held against Flax with the Flax init's params converted by
`weights.decoder_state_dict` and loaded strictly.  Tolerances, of each
field's largest value: 1e-5 (measured below 2e-6), except the
pose-modulated opacities at 1e-4: XLA's float32 sin and cos of the
encoding's 2^7 x angle are up to 2.8e-5 from the correctly rounded value
(torch's are within an ulp), which the two Dense layers carry into the
opacity factor.  The Fresnel zones quantise the depth: a Gaussian whose
zone differs between the packages must have its depth within 4 ulp of a
zone boundary (none does at these inputs), and is left out of the
positions' comparison.

Two Trainer steps with the options are held by
tests/test_torch_option_trainer.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.traverse_util import flatten_dict

from fresnel_tpu.models import blocks as jblocks
from fresnel_tpu.models import decoders as jdec
from fresnel_tpu.models.fibonacci import FibonacciPatchDecoder as JFib
from fresnel_tpu.physics.edge_detector import FresnelEdgeDetector as JEdge

from fresnel_tpu_torch.models import blocks as tblocks
from fresnel_tpu_torch.models import decoders as tdec
from fresnel_tpu_torch.models.fibonacci import FibonacciPatchDecoder
from fresnel_tpu_torch.physics.edge_detector import FresnelEdgeDetector
from fresnel_tpu_torch.physics.fresnel_zones import FresnelZones
from fresnel_tpu_torch.weights import _convert, decoder_state_dict
from test_torch_threads import _few_threads  # noqa: F401

TOL, POSE_OPACITY_TOL, ZONE_ULPS = 1e-5, 1e-4, 4
FIELDS = ("positions", "scales", "rotations", "colors", "opacities")


def _flat(params):
    return {k: np.asarray(v) for k, v in
            flatten_dict(params["params"], sep="/").items()}


def _load(module, state):
    missing, unexpected = module.load_state_dict(state, strict=True)
    assert not missing and not unexpected
    return module.eval()


def _close(got, want, tol, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (name, err, scale)


def _inputs(seed, B=2, g=5, C=16, hd=32):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(B, g, g, C)).astype(np.float32)
    depth = rng.uniform(size=(B, hd, hd)).astype(np.float32)
    el = rng.uniform(-0.5, 0.5, B).astype(np.float32)
    az = rng.uniform(-3.0, 3.0, B).astype(np.float32)
    return feats, depth, el, az


def test_edge_detector_matches_flax():
    depth = np.random.default_rng(0).uniform(size=(2, 9, 11)).astype(
        np.float32)
    j = JEdge()
    params = j.init(jax.random.PRNGKey(0), jnp.asarray(depth))
    want = j.apply(params, jnp.asarray(depth))
    t = _load(FresnelEdgeDetector(), _convert(
        _flat(params), renames=((r"^Conv_(\d)\.", r"conv\1."),)))
    with torch.no_grad():
        got = t(torch.from_numpy(depth))
        got4 = t(torch.from_numpy(depth)[..., None])
    assert got.shape == (2, 9, 11, 1)
    _close(got, want, TOL)
    assert torch.equal(got, got4)


def test_pose_encoder_matches_flax():
    _, _, el, az = _inputs(1, B=4)
    np.testing.assert_allclose(
        tblocks.sinusoidal_encode(torch.from_numpy(az)).numpy(),
        np.asarray(jblocks.sinusoidal_encode(jnp.asarray(az))), atol=5e-5)
    j = jblocks.PoseEncoder()
    params = j.init(jax.random.PRNGKey(1), jnp.asarray(el), jnp.asarray(az))
    want = j.apply(params, jnp.asarray(el), jnp.asarray(az))
    t = _load(tblocks.PoseEncoder(), _convert(
        _flat(params), renames=((r"^Dense_(\d)\.", r"dense\1."),)))
    with torch.no_grad():
        got = t(torch.from_numpy(el), torch.from_numpy(az))
    assert got.shape == (4, 64)
    _close(got, want, POSE_OPACITY_TOL)


@pytest.mark.parametrize("hd,grid", [(32, 5), (64, 37), (20, 20)])
def test_depth_encoder_matches_flax(hd, grid):
    _, depth, _, _ = _inputs(2, hd=hd)
    x = np.random.default_rng(3).normal(size=(2, hd, hd, 6)).astype(
        np.float32)
    _close(tblocks.adaptive_average_pool(torch.from_numpy(x), (grid, grid)),
           jblocks.adaptive_average_pool(jnp.asarray(x), (grid, grid)), TOL)
    j = jblocks.DepthEncoder(8, grid_size=grid)
    params = j.init(jax.random.PRNGKey(2), jnp.asarray(depth))
    want = j.apply(params, jnp.asarray(depth))
    t = _load(tblocks.DepthEncoder(8, grid_size=grid), _convert(
        _flat(params), renames=((r"^Conv_(\d)\.", r"conv\1."),)))
    with torch.no_grad():
        got = t(torch.from_numpy(depth))
    assert got.shape == (2, grid, grid, 8)
    _close(got, want, TOL)


def _zone_flips(depth_grid, num_zones=8):
    """Indices (flat over B, H, W) whose zone differs between the two
    packages' quantisations, and each one's distance in ulp to the
    nearest inner zone boundary."""
    d = np.asarray(depth_grid, np.float32)
    zt = FresnelZones(num_zones=num_zones).quantize_depth(
        torch.from_numpy(d)).numpy().ravel()
    from fresnel_tpu.physics.fresnel_zones import FresnelZones as JZones
    zj = np.asarray(JZones(num_zones=num_zones).quantize_depth(
        jnp.asarray(d))).ravel()
    flips = np.nonzero(zt != zj)[0]
    bounds = np.linspace(0, 1, num_zones + 1, dtype=np.float32)[1:-1]
    dist = np.abs(d.ravel()[flips, None] - bounds[None]).min(-1)
    return flips, dist / np.spacing(np.float32(1.0))


@pytest.mark.parametrize("zones,phase", [(True, False), (False, True),
                                         (True, True)])
def test_head_transform_zones_and_phases(zones, phase):
    rng = np.random.default_rng(4)
    B, H, W, K = 2, 6, 6, 3
    raw = rng.normal(size=(B, H, W, K, 19 if phase else 16)).astype(
        np.float32)
    depth = rng.uniform(size=(B, 24, 24)).astype(np.float32)
    kw = dict(use_fresnel_zones=zones, use_phase_output=phase)
    want = jdec.head_transform(jnp.asarray(raw), jnp.asarray(depth),
                               jnp.asarray(-1.5), **kw)
    got = tdec.head_transform(torch.from_numpy(raw), torch.from_numpy(depth),
                              torch.tensor(-1.5), **kw)
    assert set(got) == set(want)
    assert ("phases" in got) == phase
    grid = tdec._resize_depth_to_grid(torch.from_numpy(depth), H, W)
    flips, ulps = _zone_flips(grid)
    assert (ulps <= ZONE_ULPS).all(), ulps
    keep = np.ones(B * H * W, bool)
    keep[flips] = False
    keep = np.repeat(keep, K)
    for k in got:
        g, w = got[k].numpy(), np.asarray(want[k])
        if k == "positions":
            g, w = g.reshape(-1, 3)[keep], w.reshape(-1, 3)[keep]
        _close(g, w, TOL, k)
    if phase:
        ph = got["phases"].numpy()
        assert ph.min() >= 0.0 and ph.max() <= 2 * np.pi


def test_head_transform_edge_aware_needs_its_detector():
    raw = torch.zeros(1, 2, 2, 1, 16)
    with pytest.raises(ValueError, match="edge detector"):
        tdec.head_transform(raw, torch.rand(1, 8, 8), torch.tensor(-2.0),
                            use_edge_aware=True)
    out = tdec.head_transform(raw, None, torch.tensor(-2.0),
                              use_edge_aware=True)
    assert "edge_strength" not in out


DIRECT_OPTIONS = [
    dict(use_fresnel_zones=True), dict(use_edge_aware=True),
    dict(use_phase_output=True), dict(use_pose_encoding=True),
    dict(use_depth_fusion=True),
    dict(use_fresnel_zones=True, use_edge_aware=True, use_phase_output=True,
         use_pose_encoding=True, use_depth_fusion=True),
    dict(feature_upsample=2, use_depth_fusion=True, use_edge_aware=True)]


def _compare_outputs(got, want, flips_keep=None, pose=False):
    assert set(got) == set(want), (set(got), set(want))
    for k in got:
        g, w = got[k].numpy(), np.asarray(want[k])
        if k == "positions" and flips_keep is not None:
            g, w = g.reshape(-1, 3)[flips_keep], w.reshape(-1, 3)[flips_keep]
        tol = POSE_OPACITY_TOL if (pose and k == "opacities") else TOL
        _close(g, w, tol, k)


@pytest.mark.parametrize("opts", DIRECT_OPTIONS,
                         ids=["zones", "edge", "phase", "pose", "fusion",
                              "all", "upsample"])
def test_direct_decoder_options_match_flax(opts):
    feats, depth, el, az = _inputs(5)
    kw = dict(feature_dim=16, gaussians_per_patch=2, hidden_dims=(32,),
              dropout=0.0, depth_feature_dim=8, **opts)
    j = jdec.DirectPatchDecoder(**kw)
    args = (jnp.asarray(feats), jnp.asarray(depth))
    pose = dict(elevation=jnp.asarray(el), azimuth=jnp.asarray(az))
    params = j.init(jax.random.PRNGKey(6), *args, **pose)
    want = j.apply(params, *args, **pose)
    t = _load(tdec.DirectPatchDecoder(**kw),
              decoder_state_dict(_flat(params)))
    with torch.no_grad():
        got = t(torch.from_numpy(feats), torch.from_numpy(depth),
                elevation=torch.from_numpy(el),
                azimuth=torch.from_numpy(az))
    if opts.get("use_pose_encoding"):
        assert t.opacity_out.weight.shape == (1, 128)
        assert t.opacity_hidden.weight.shape == (128, 64)
    keep = None
    if opts.get("use_fresnel_zones"):
        g = 5 * opts.get("feature_upsample", 1)
        flips, ulps = _zone_flips(tdec._resize_depth_to_grid(
            torch.from_numpy(depth), g, g))
        assert (ulps <= ZONE_ULPS).all(), ulps
        keep = np.repeat(~np.isin(np.arange(2 * g * g), flips), 2)
    _compare_outputs(got, want, keep, pose=opts.get("use_pose_encoding",
                                                    False))
    if opts.get("use_edge_aware"):
        e = got["edge_strength"]
        assert e.shape[-1] == 1 and (e >= 0).all() and (e <= 1).all()


@pytest.mark.parametrize("opts", [
    dict(use_fresnel_zones=True), dict(use_phase_output=True),
    dict(use_pose_encoding=True),
    dict(use_fresnel_zones=True, use_phase_output=True,
         use_pose_encoding=True)], ids=["zones", "phase", "pose", "all"])
def test_fibonacci_options_match_flax(opts):
    feats, depth, el, az = _inputs(7)
    kw = dict(feature_dim=16, n_points=55, hidden_dims=(32,), dropout=0.0,
              **opts)
    j = JFib(**kw)
    args = (jnp.asarray(feats), jnp.asarray(depth))
    pose = dict(elevation=jnp.asarray(el), azimuth=jnp.asarray(az))
    params = jax.jit(j.init)(jax.random.PRNGKey(8), *args, **pose)
    want = jax.jit(j.apply)(params, *args, **pose)
    t = _load(FibonacciPatchDecoder(**kw), decoder_state_dict(_flat(params)))
    with torch.no_grad():
        got = t(torch.from_numpy(feats), torch.from_numpy(depth),
                elevation=torch.from_numpy(el),
                azimuth=torch.from_numpy(az))
    if opts.get("use_pose_encoding"):
        assert t.opacity_out.weight.shape == (1, 64)
    _compare_outputs(got, want, pose=opts.get("use_pose_encoding", False))


def test_pose_options_without_a_pose_leave_opacity():
    feats, depth, _, _ = _inputs(9)
    t = tdec.DirectPatchDecoder(feature_dim=16, gaussians_per_patch=2,
                                hidden_dims=(32,), use_pose_encoding=True)
    plain = tdec.DirectPatchDecoder(feature_dim=16, gaussians_per_patch=2,
                                    hidden_dims=(32,))
    plain.load_state_dict({k: v for k, v in t.state_dict().items()
                           if k in plain.state_dict()})
    f, d = torch.from_numpy(feats), torch.from_numpy(depth)
    with torch.no_grad():
        assert torch.equal(t(f, d)["opacities"], plain(f, d)["opacities"])
    with pytest.raises(ValueError, match="depth"):
        tdec.DirectPatchDecoder(feature_dim=16, hidden_dims=(8,),
                                use_depth_fusion=True)(f)
