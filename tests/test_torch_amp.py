"""Port parity: bf16 mixed precision (`use_amp`) against the JAX package's
`utils.precision` on the CPU.

* `cast_floats` / `to_bf16` / `to_f32` on nested trees: the same leaves
  cast and the same left alone as JAX's; `amp_apply` hands the module bf16
  parameters and positional inputs, keyword inputs as they are, and
  returns float32 outputs with float32 gradients.
* Each module the decoder Trainer runs under `use_amp` (the ImageEncoder,
  plain and with pooled attention; DirectPatchDecoder plain, with every
  option, with feature_upsample and the z residual; the physics decoder
  with diffraction placement, its wavelength learnable and fixed;
  FibonacciPatchDecoder with its options; SAAGRefinementNet with its
  float32 prior as keywords; FeatureGuidedSAAG; the NCA), on the same
  parameters (JAX's init, moved off it): the bf16 output of each field,
  and the float32 gradient of each parameter under a seeded cotangent,
  against `jax.jit` of `amp_apply(module.apply, ...)`, as the JAX
  trainer runs it.  Bound: within 2 x the larger of the JAX package's own
  bf16-against-float32 difference and one bf16 ulp of the field's
  (leaf's) largest float32 value, and within 5e-2 of that value for a
  field, 0.25 for a gradient leaf.  The floor: under jit XLA:CPU keeps
  the elementwise ops that end in the float32 cast in float32 (excess
  precision), so some of its bf16 fields land within less than an ulp of
  float32, where the port's, rounded to bf16, may land an ulp away; and a
  leaf of a few entries can land near its float32 value by chance.  The
  leaves whose gradient is zero in exact arithmetic (the residual blocks'
  first conv biases, each feeding a GroupNorm of one channel per group
  at these widths, and the attention key biases) are rounding noise in
  either package and held by the first bound only.  The bf16 dtype of
  each output field is JAX's.
* kNN ties: `knn_indices` on lattice positions (many equal distances) in
  bf16 and float32 picks `lax.top_k`'s neighbours.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.traverse_util import flatten_dict
from torch.func import functional_call

from fresnel_tpu.models import decoders as jdec
from fresnel_tpu.models.fibonacci import FibonacciPatchDecoder as JFib
from fresnel_tpu.models.image_encoder import ImageEncoder as JEncoder
from fresnel_tpu.models.nca import NCAGaussianDecoder as JNCA
from fresnel_tpu.models.saag_refine import (
    FeatureGuidedSAAG as JFG, SAAGRefinementNet as JRefine)
from fresnel_tpu.train.harness import saag_prior_from_depth as jprior
from fresnel_tpu.utils import precision as jprec

from fresnel_tpu_torch.models import decoders as tdec
from fresnel_tpu_torch.models.fibonacci import FibonacciPatchDecoder
from fresnel_tpu_torch.models.image_encoder import ImageEncoder
from fresnel_tpu_torch.models.nca import NCAGaussianDecoder, knn_indices
from fresnel_tpu_torch.models.saag_refine import (
    FeatureGuidedSAAG, SAAGRefinementNet)
from fresnel_tpu_torch.utils import precision as tprec
from fresnel_tpu_torch.weights import (
    decoder_state_dict, image_encoder_state_dict)
from test_torch_threads import _few_threads  # noqa: F401

GAP = 2.0              # x the JAX package's own bf16 - f32 difference
CEILING = 5e-2         # of the field's largest float32 value
GRAD_CEILING = 0.25    # of the leaf's largest float32 gradient
BF16_ULP = 2.0 ** -7   # one bf16 ulp, relative to the leaf's largest value
ZERO_GRAD = ("res.0.conv1.bias", "res.1.conv1.bias", "res.2.conv1.bias",
             "res.3.conv1.bias", "res.4.conv1.bias", "attn.k.bias")


def _flat(tree):
    return {k: np.asarray(v, np.float32)
            for k, v in flatten_dict(tree, sep="/").items()}


def _fields(out):
    return {k: v for k, v in (out if isinstance(out, dict)
                              else {"out": out}).items()
            if k != "residuals"}


def _inputs():
    rng = np.random.default_rng(0)
    return dict(
        image=rng.uniform(size=(2, 3, 32, 32)).astype(np.float32),
        image40=rng.uniform(size=(2, 3, 40, 40)).astype(np.float32),
        feats=rng.normal(size=(2, 5, 5, 48)).astype(np.float32),
        feats8=rng.normal(size=(2, 8, 8, 48)).astype(np.float32),
        depth=rng.uniform(size=(2, 32, 32)).astype(np.float32),
        depth64=rng.uniform(size=(2, 64, 64)).astype(np.float32),
        el=np.array([0.1, -0.3], np.float32),
        az=np.array([0.5, 1.0], np.float32))


D = dict(feature_dim=48, gaussians_per_patch=2, hidden_dims=(64, 32))
OPTIONS = dict(D, use_fresnel_zones=True, use_edge_aware=True,
               use_phase_output=True, use_pose_encoding=True,
               use_depth_fusion=True, depth_feature_dim=8)
FIB = dict(feature_dim=48, n_points=55, hidden_dims=(64, 32))


def _case(name):
    """(JAX module, port module, params converter, positional input
    names, keyword input names, perturbation of the init)."""
    pose = ("el", "az")
    return {
        "encoder": (JEncoder(feature_dim=48, grid=5, width=8),
                    ImageEncoder(feature_dim=48, grid=5, width=8),
                    image_encoder_state_dict, ("image",), (), 0.0),
        "encoder_attn_pool": (
            JEncoder(feature_dim=48, grid=6, width=8, attn_pool=2),
            ImageEncoder(feature_dim=48, grid=6, width=8, attn_pool=2),
            lambda f: image_encoder_state_dict(f, 2), ("image40",), (),
            0.0),
        "direct": (jdec.DirectPatchDecoder(**D), tdec.DirectPatchDecoder(**D),
                   decoder_state_dict, ("feats", "depth"), (), 0.0),
        "direct_options": (jdec.DirectPatchDecoder(**OPTIONS),
                           tdec.DirectPatchDecoder(**OPTIONS),
                           decoder_state_dict, ("feats", "depth"), pose,
                           0.02),
        "direct_upsample": (
            jdec.DirectPatchDecoder(**D, feature_upsample=2,
                                    z_offset_scale=0.2, scale_bias=-2.6,
                                    opacity_bias=1.5),
            tdec.DirectPatchDecoder(**D, feature_upsample=2,
                                    z_offset_scale=0.2, scale_bias=-2.6,
                                    opacity_bias=1.5),
            decoder_state_dict, ("feats", "depth"), (), 0.02),
        "physics": (
            jdec.PhysicsDirectPatchDecoder(**D,
                                           use_diffraction_placement=True),
            tdec.PhysicsDirectPatchDecoder(**D,
                                           use_diffraction_placement=True),
            decoder_state_dict, ("feats", "depth"), (), 0.0),
        "physics_fixed_wavelength": (
            jdec.PhysicsDirectPatchDecoder(**D, learnable_wavelength=False),
            tdec.PhysicsDirectPatchDecoder(**D, learnable_wavelength=False),
            decoder_state_dict, ("feats", "depth"), (), 0.0),
        "fibonacci": (
            JFib(**FIB, use_fresnel_zones=True, use_phase_output=True,
                 use_pose_encoding=True),
            FibonacciPatchDecoder(**FIB, use_fresnel_zones=True,
                                  use_phase_output=True,
                                  use_pose_encoding=True),
            decoder_state_dict, ("feats", "depth"), pose, 0.02),
        "saag_refine": (JRefine(feature_dim=48, dropout=0.0),
                        SAAGRefinementNet(feature_dim=48, dropout=0.0),
                        decoder_state_dict, ("feats8",), ("prior",), 0.02),
        "feature_guided": (JFG(feature_dim=48), FeatureGuidedSAAG(
            feature_dim=48), decoder_state_dict, ("feats",), (), 0.05),
        "nca": (JNCA(feature_dim=48, n_points=55, n_steps=3, hidden_dim=32),
                NCAGaussianDecoder(feature_dim=48, n_points=55, n_steps=3,
                                   hidden_dim=32),
                decoder_state_dict, ("feats", "depth"), (), 0.05),
    }[name]


def _kwargs(names, x, to):
    kw = {}
    for n in names:
        if n == "prior":
            kw.update({k: to(np.asarray(v)) for k, v in
                       jprior(jnp.asarray(x["depth64"])).items()})
        else:
            kw[dict(el="elevation", az="azimuth")[n]] = to(x[n])
    return kw


def _perturb(params, scale, seed=1):
    if not scale:
        return params
    leaves, tree = jax.tree.flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
    return jax.tree.unflatten(tree, [
        x + scale * jax.random.normal(k, jnp.shape(x))
        for x, k in zip(leaves, keys)])


@pytest.fixture(scope="module")
def x():
    return _inputs()


def _jax_side(jm, args, kwargs, perturb):
    """JAX's init (moved off it), and its float32 and bf16 outputs and
    gradients under seeded cotangents (each jitted: eager JAX takes a
    minute a module here)."""
    params = jax.jit(lambda key: _perturb(
        jm.init(key, *args, **kwargs), perturb))(jax.random.PRNGKey(0))
    shapes = jax.eval_shape(lambda p: _fields(jm.apply(p, *args, **kwargs)),
                            params)
    rng = np.random.default_rng(5)
    cots = {k: rng.normal(size=v.shape).astype(np.float32)
            for k, v in sorted(shapes.items())}

    def fwd_bwd(p, amp):
        out, vjp = jax.vjp(lambda q: _fields(jprec.amp_apply(
            jm.apply, q, *args, use_amp=amp, **kwargs)), p)
        return out, vjp({k: jnp.asarray(c) for k, c in cots.items()})[0]

    outs, grads = {}, {}
    for amp in (False, True):
        o, g = jax.jit(lambda p: fwd_bwd(p, amp))(params)
        outs[amp] = {k: np.asarray(v) for k, v in o.items()}
        grads[amp] = _flat(g["params"])
    raw = jax.eval_shape(lambda p: _fields(jm.apply(
        jprec.to_bf16(p), *jprec.to_bf16(args), **kwargs)), params)
    dtypes = {k: str(v.dtype) for k, v in raw.items()}
    return params, outs, cots, grads, dtypes


@pytest.mark.parametrize("name", [
    "encoder", "encoder_attn_pool", "direct", "direct_options",
    "direct_upsample", "physics", "physics_fixed_wavelength", "fibonacci",
    "saag_refine", "feature_guided", "nca"])
def test_module_matches_jax_amp(name, x):
    jm, tm, conv, pos, kw, perturb = _case(name)
    jargs = [jnp.asarray(x[n]) for n in pos]
    params, outs, cots, jgrads, jdtypes = _jax_side(
        jm, jargs, _kwargs(kw, x, jnp.asarray), perturb)
    sd = conv(_flat(params["params"]))
    tm.load_state_dict(sd, strict=True)
    p = {k: v.clone().requires_grad_() for k, v in sd.items()}
    targs = [torch.from_numpy(x[n]) for n in pos]
    tkw = _kwargs(kw, x, torch.from_numpy)
    out = _fields(tprec.amp_apply(tm, p, *targs, **tkw))
    assert set(out) == set(cots)
    for k, c in cots.items():
        got, want, f32 = (out[k].detach().numpy(), outs[True][k],
                          outs[False][k])
        assert out[k].dtype == torch.float32
        scale = np.abs(f32).max()
        err = np.abs(got - want).max()
        gap = max(np.abs(want - f32).max(), BF16_ULP * scale)
        assert err <= GAP * gap, (k, err, gap)
        assert err <= CEILING * scale, (k, err)
    with torch.no_grad():
        raw = _fields(functional_call(tm, tprec.to_bf16(sd),
                                      tuple(tprec.to_bf16(targs)), tkw))
    assert {k: str(v.dtype).replace("torch.", "") for k, v in raw.items()
            } == jdtypes
    loss = sum((out[k] * torch.from_numpy(c)).sum() for k, c in cots.items())
    names = list(p)
    grads = torch.autograd.grad(loss, [p[k] for k in names],
                                allow_unused=True)
    want_g = {amp: conv(g) for amp, g in jgrads.items()}
    for k, g in zip(names, grads):
        got = (torch.zeros_like(p[k]) if g is None else g)
        assert got.dtype == torch.float32
        got, want, f32 = (got.numpy(), want_g[True][k].numpy(),
                          want_g[False][k].numpy())
        scale = np.abs(f32).max()
        err = np.abs(got - want).max()
        gap = max(np.abs(want - f32).max(), BF16_ULP * scale)
        assert err <= GAP * gap, (k, err, gap)
        if not k.endswith(ZERO_GRAD):
            assert err <= GRAD_CEILING * scale, (k, err, scale)


def test_cast_floats_matches_jax():
    tree = {"w": np.ones((2, 3), np.float32), "s": np.float32(2.5),
            "i": np.arange(3, dtype=np.int32), "b": np.ones(2, bool),
            "nest": [np.full((2,), 0.1, np.float32),
                     (np.zeros((), np.float32), 3, None)],
            "py": 1.5}

    def jaxify(t):
        if isinstance(t, dict):
            return {k: jaxify(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(jaxify(v) for v in t)
        return jnp.asarray(t) if isinstance(t, (np.ndarray, np.generic)) \
            else t

    def torchify(t):
        if isinstance(t, dict):
            return {k: torchify(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(torchify(v) for v in t)
        return torch.from_numpy(np.asarray(t)) \
            if isinstance(t, (np.ndarray, np.generic)) else t

    want = jax.tree.leaves(jprec.to_bf16(jaxify(tree)),
                           is_leaf=lambda v: v is None)
    got = tprec.to_bf16(torchify(tree))
    got_leaves = [got["b"], got["i"], got["nest"][0], got["nest"][1][0],
                  got["nest"][1][1], got["nest"][1][2], got["py"], got["s"],
                  got["w"]]
    assert len(want) == len(got_leaves)
    for w, g in zip(want, got_leaves):
        if isinstance(w, (jax.Array, np.ndarray)):
            assert str(g.dtype).replace("torch.", "") == str(w.dtype)
            assert tuple(g.shape) == tuple(w.shape)
            np.testing.assert_array_equal(
                g.float().numpy() if g.is_floating_point() else g.numpy(),
                np.asarray(w, np.float32 if g.is_floating_point()
                           else None))
        else:
            assert g == w
    back = tprec.to_f32(got)
    assert back["w"].dtype == torch.float32 and back["i"].dtype == torch.int32
    assert back["nest"][1][1] == 3 and back["nest"][1][2] is None


class _Probe(torch.nn.Module):
    """Records the dtypes it sees; returns a nested dict of outputs."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.full((3,), 0.1))
        self.seen = {}

    def forward(self, a, b, scale=None, flag=True):
        self.seen = dict(w=self.w.dtype, a=a.dtype, b=b.dtype,
                         scale=scale.dtype, flag=flag)
        return {"y": a * self.w * scale, "n": {"z": b.sum() * self.w},
                "i": torch.arange(3)}


def test_amp_apply_casts_inputs_and_returns_float32():
    m = _Probe()
    p = {"w": m.w.detach().clone().requires_grad_()}
    a, b = torch.full((3,), 1.1), torch.ones(2, 3)
    scale = torch.full((3,), 3.0)
    out = tprec.amp_apply(m, p, a, b, scale=scale, flag=False)
    assert m.seen == dict(w=torch.bfloat16, a=torch.bfloat16,
                          b=torch.bfloat16, scale=torch.float32, flag=False)
    assert out["y"].dtype == out["n"]["z"].dtype == torch.float32
    assert out["i"].dtype == torch.int64
    # 1.1 and 0.1 rounded to bf16 (1.1015625, 0.10009765625), their
    # product rounded to bf16, then times the float32 keyword in float32.
    prod = torch.tensor(1.1015625 * 0.10009765625).bfloat16().float()
    assert torch.equal(out["y"], torch.full((3,), prod.item() * 3.0))
    g, = torch.autograd.grad(out["y"].sum() + out["n"]["z"].sum(), [p["w"]])
    assert g.dtype == torch.float32
    plain = tprec.amp_apply(m, p, a, b, scale=scale, use_amp=False)
    assert m.seen["w"] == m.seen["a"] == torch.float32
    assert torch.equal(plain["y"], a * p["w"] * scale)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_knn_ties_match_top_k(dtype):
    """Lattice points: every point's neighbours tie at equal distances;
    both packages keep the lowest indices among equals."""
    g = np.stack(np.meshgrid(np.arange(4), np.arange(4), np.arange(2),
                             indexing="ij"), -1).reshape(1, -1, 3)
    pos = (g * 0.25 + 0.125).astype(np.float32)
    pos = np.concatenate([pos, pos[:, ::-1] + 0.5], 0)     # batch of 2
    jpos = jnp.asarray(pos).astype(getattr(jnp, dtype))
    diff = jpos[:, :, None, :] - jpos[:, None, :, :]
    dists = jnp.sqrt(jnp.sum(diff * diff, -1) + 1e-12)
    want = np.asarray(jax.lax.top_k(-dists, 7)[1][..., 1:])
    got = knn_indices(torch.from_numpy(pos).to(getattr(torch, dtype)), 6)
    d = np.asarray(dists.astype(jnp.float32))
    assert (np.take_along_axis(d, want, -1)[..., :-1]
            == np.take_along_axis(d, want, -1)[..., 1:]).any()  # ties
    np.testing.assert_array_equal(got.numpy(), want)
