"""Port parity: the wave-optics physics and the physics decoder.

`constrain_wavelength`, `PhysicsFresnelZones`, `MultiWavelengthPhysics`
and `FresnelDiffraction` are held against the JAX package's jitted
functions on XLA:CPU bit for bit.  `PhysicsDirectPatchDecoder` is held
against Flax with the Flax init's params converted by
`weights.decoder_state_dict` and loaded strictly: outputs within 1e-5 of
each field's largest value, and the gradients of a seeded weighted sum of
the outputs with respect to every parameter within 1e-4 of each leaf's
largest gradient.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.traverse_util import flatten_dict

from fresnel_tpu.models import decoders as jdec
from fresnel_tpu.physics import diffraction as jd
from fresnel_tpu.physics import fresnel_zones as jz

from fresnel_tpu_torch.models import decoders as tdec
from fresnel_tpu_torch.physics import diffraction as td
from fresnel_tpu_torch.physics import fresnel_zones as tz
from fresnel_tpu_torch.weights import decoder_state_dict
from test_torch_threads import _few_threads  # noqa: F401

TOL, GRAD_TOL = 1e-5, 1e-4
FIELDS = ("positions", "scales", "rotations", "colors", "opacities",
          "phases")


def _bits(got, want, name=""):
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=name)


def _close(got, want, tol, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (name, err, scale)


def _depth(seed, shape=(3, 37, 37), lo=-0.5, hi=1.5):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


@pytest.mark.parametrize("wavelength", [None, 0.037, 0.004, 0.9])
def test_physics_zones_bitwise(wavelength):
    d = _depth(0)
    jp, tp = jz.PhysicsFresnelZones(), tz.PhysicsFresnelZones()
    if wavelength is None:
        want = jax.jit(lambda x: jp(x, None, return_all=True))(jnp.asarray(d))
        got = tp(torch.from_numpy(d), None, return_all=True)
    else:
        w = np.float32(wavelength)
        want = jax.jit(lambda x, wl: jp(x, wl, return_all=True))(
            jnp.asarray(d), jnp.asarray(w))
        got = tp(torch.from_numpy(d), torch.tensor(w), return_all=True)
    assert set(got) == set(want)
    for k in want:
        _bits(got[k], want[k], k)


@pytest.mark.parametrize("wavelengths", [None, (0.06, 0.04, 0.03),
                                         (-0.2, 0.7, 0.001)])
@pytest.mark.parametrize("ratios", [True, False])
def test_multi_wavelength_bitwise(wavelengths, ratios):
    d = _depth(1)
    ws = None if wavelengths is None else np.float32(wavelengths)
    jm = jz.MultiWavelengthPhysics(use_physical_ratios=ratios)
    tm = tz.MultiWavelengthPhysics(use_physical_ratios=ratios)
    tw = None if ws is None else torch.from_numpy(ws)
    want = jax.jit(lambda x: jm(x, ws, return_all=True))(jnp.asarray(d))
    got = tm(torch.from_numpy(d), tw, return_all=True)
    for k in want:
        _bits(got[k], want[k], k)
    _bits(tm.init_wavelengths(), jm.init_wavelengths(), "init")
    for c in "rgb":
        _bits(tm.depth_to_phase_single(torch.from_numpy(d), c, tw),
              jax.jit(lambda x: jm.depth_to_phase_single(x, c, ws))(
                  jnp.asarray(d)), c)


def test_constrain_wavelength_bitwise():
    d = _depth(2, lo=-1.0, hi=1.0)
    _bits(tz.constrain_wavelength(torch.from_numpy(d)),
          jax.jit(jz.constrain_wavelength)(jnp.asarray(d)))


def test_diffraction_bitwise():
    """The host tables, the interpolation (the index rounded as XLA folds
    it, then truncated), the intensity profile, the Fresnel parameter,
    the edge density and the fringe positions."""
    rng = np.random.default_rng(3)
    w = rng.uniform(-1.0, 6.0, (4, 37, 37)).astype(np.float32)
    w[0, 0, :5] = [0.0, 5.0, 4.999, 0.005, 2.5]
    jf, tf = jd.FresnelDiffraction(), td.FresnelDiffraction()
    for a, b in zip(tf._lut(), jf._lut()):
        _bits(a, b, "lut")
    for k in ("fresnel_C", "fresnel_S", "fresnel_intensity"):
        _bits(getattr(tf, k)(torch.from_numpy(w)),
              jax.jit(getattr(jf, k))(jnp.asarray(w)), k)
    d = _depth(4)
    dist = rng.uniform(-0.5, 0.5, d.shape).astype(np.float32)
    em = rng.uniform(0.0, 1.0, d.shape).astype(np.float32)
    _bits(tf.compute_fresnel_parameter(torch.from_numpy(dist),
                                       torch.from_numpy(d)),
          jax.jit(jf.compute_fresnel_parameter)(jnp.asarray(dist),
                                                jnp.asarray(d)), "w")
    _bits(tf(torch.from_numpy(d), torch.from_numpy(em),
             torch.from_numpy(dist)),
          jax.jit(jf.__call__)(jnp.asarray(d), jnp.asarray(em),
                               jnp.asarray(dist)), "density")
    _bits(tf.get_fringe_positions(1.3), jf.get_fringe_positions(1.3),
          "fringe")


@pytest.mark.parametrize("x", [
    [0.0, 6.2831855, 6.2831850, -1e-7, -6.2831855, 12.566371, 3.0e4, -7.5],
])
def test_wrap_phase_matches_jnp_mod(x):
    x = np.float32(x)
    _bits(tdec.wrap_phase(torch.from_numpy(x)),
          jax.jit(lambda v: jnp.mod(v, jdec.TWO_PI))(jnp.asarray(x)))


def _decoder_pair(learnable, placement, K=4, C=16):
    kw = dict(feature_dim=C, gaussians_per_patch=K, hidden_dims=(32, 24),
              wavelength=0.05, learnable_wavelength=learnable,
              focal_depth=0.5, use_diffraction_placement=placement,
              scale_bias=-0.3, opacity_bias=0.4)
    return (jdec.PhysicsDirectPatchDecoder(**kw),
            tdec.PhysicsDirectPatchDecoder(**kw))


def _inputs(seed, B=2, g=5, C=16, hd=32):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(B, g, g, C)).astype(np.float32)
    # Steps and a ramp, so the diffraction placement sees edges.
    depth = rng.uniform(size=(B, hd, hd)).astype(np.float32) * 0.2
    depth[:, :, hd // 2:] += 0.6
    return feats, depth


@pytest.mark.parametrize("learnable,placement,with_depth,K", [
    (True, False, True, 4), (True, True, True, 4), (False, True, True, 3),
    (True, False, False, 4)])
def test_physics_decoder_matches_flax(learnable, placement, with_depth, K):
    jm, tm = _decoder_pair(learnable, placement)
    feats, depth = _inputs(5)
    jargs = (jnp.asarray(feats),) + ((jnp.asarray(depth),) if with_depth
                                     else ())
    params = jm.init(jax.random.PRNGKey(1), *jargs)
    flat = {k: np.asarray(v) for k, v in
            flatten_dict(params["params"], sep="/").items()}
    missing, unexpected = tm.load_state_dict(decoder_state_dict(flat),
                                             strict=True)
    assert not missing and not unexpected
    tm.eval()
    want = jax.jit(lambda p, *a: jm.apply(p, *a, num_gaussians=K))(
        params, *jargs)
    targs = (torch.from_numpy(feats),) + ((torch.from_numpy(depth),)
                                          if with_depth else ())
    with torch.no_grad():
        got = tm(*targs, num_gaussians=K)
    assert set(got) == set(want)
    for k in FIELDS:
        _close(got[k], want[k], TOL, k)
    assert got["phases"].shape == (2, 25 * K)
    assert float(got["phases"].min()) >= 0.0
    assert float(got["phases"].max()) < 2 * np.pi


@pytest.mark.parametrize("placement", [False, True])
def test_physics_decoder_gradients_match_flax(placement):
    """d/dparams of sum(w_k * out_k) over every output field, the
    weights w_k seeded: through the MLP, the head, the placement's
    opacity factor and the phase's min / max normalisation, the
    wavelength and the wrap."""
    jm, tm = _decoder_pair(True, placement)
    feats, depth = _inputs(6)
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(feats),
                     jnp.asarray(depth))
    flat = {k: np.asarray(v) for k, v in
            flatten_dict(params["params"], sep="/").items()}
    tm.load_state_dict(decoder_state_dict(flat), strict=True)
    tm.eval()
    probe = jm.apply(params, jnp.asarray(feats), jnp.asarray(depth))
    rng = np.random.default_rng(7)
    wts = {k: rng.normal(size=np.shape(probe[k])).astype(np.float32)
           for k in FIELDS}

    def jloss(p):
        out = jm.apply(p, jnp.asarray(feats), jnp.asarray(depth))
        return sum(jnp.sum(out[k] * wts[k]) for k in FIELDS)

    jg = {k: np.asarray(v) for k, v in flatten_dict(
        jax.jit(jax.grad(jloss))(params)["params"], sep="/").items()}
    out = tm(torch.from_numpy(feats), torch.from_numpy(depth))
    loss = sum((out[k] * torch.from_numpy(wts[k])).sum() for k in FIELDS)
    names = [n for n, _ in tm.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in tm.named_parameters()])
    want = decoder_state_dict(jg)
    assert set(names) == set(want)
    for n, g in zip(names, grads):
        _close(g, want[n].numpy(), GRAD_TOL, n)
