"""Port parity: the CVS model (models/cvs.py) against the JAX package's on
the CPU, at 32^2, base 32 (so attention runs at the 16 and 8 levels: all
six attention blocks), two images, with JAX's parameters carried across
by `weights.cvs_params`.  One jitted JAX init is shared by the file.

* float32: every block, the U-Net, the training- and inference-mode call,
  `predict_x0` and `generate` (1 and 4 steps, with extra_noise) within
  1e-4 of the output's largest value (measured 4e-6 to 1.4e-5; the 4-step
  generation the most), with and without concat_input_view.
* bfloat16 (`use_amp`): the port's compute-dtype layers against the Flax
  modules' `dtype=bfloat16` on the same parameters.  Each package rounds
  differently (torch's SiLU and softmax round once, XLA:CPU after each
  op), so the bound is relative to bfloat16's own noise: the largest
  difference within 2 x the JAX package's own bfloat16-against-float32
  difference, and within 5e-2 of the output's largest value (measured:
  a training-mode x0 2.2e-2 against JAX's own 1.8e-2; one-step
  generation 2.2e-2 against 1.6e-2; the adapter's tokens 7.9e-3 against
  6.2e-3).
* the schedule: every table bit for bit (the cumulative product in
  XLA:CPU's block order; a sequential one is 2 ulp off at t = 500);
* the stride-2 "SAME" convolution pads (0, 1) on an even size, unlike
  nn.Conv2d(padding=1);
* `get_relative_pose` within 1e-6; `sinusoidal_embed` within 5e-5
  (XLA:CPU's float32 sin and cos at arguments near 10^3 rad are up to
  2.8e-5 from the correctly rounded values torch gives).
"""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.traverse_util import flatten_dict

from fresnel_tpu.models import cvs as J

from fresnel_tpu_torch.models import cvs as T
from fresnel_tpu_torch.weights import cvs_params, init_flax_like_
from test_torch_threads import _few_threads  # noqa: F401

B, S, BASE = 2, 32, 32
F32_TOL = 1e-4
BF16_ABS = 5e-2          # of the output's largest value
BF16_GAP = 2.0           # x the JAX package's own bf16 - f32 difference


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    q = np.stack([np.linalg.qr(rng.normal(size=(3, 3)))[0]
                  for _ in range(B)]).astype(np.float32)
    return dict(
        ii=rng.uniform(size=(B, 3, S, S)).astype(np.float32),
        ft=rng.normal(size=(B, 37, 37, 384)).astype(np.float32),
        R=q, t=rng.normal(size=(B, 3)).astype(np.float32),
        noise=rng.normal(size=(B, 3, S, S)).astype(np.float32),
        extra=rng.normal(size=(3, B, 3, S, S)).astype(np.float32),
        ts=np.array([500, 7], np.int32))


def _flat(params):
    return {k: np.asarray(v)
            for k, v in flatten_dict(params["params"], sep="/").items()}


def _port(flat, **cfg):
    m = T.ConsistencyViewSynthesizer(T.CVSConfig(image_size=S,
                                                 base_channels=BASE, **cfg))
    m.load_state_dict(cvs_params(flat))
    return m.eval()


@pytest.fixture(scope="module")
def run():
    x = _inputs()
    m = J.ConsistencyViewSynthesizer(J.CVSConfig(image_size=S,
                                                 base_channels=BASE))
    params = jax.jit(lambda k: m.init(
        k, x["ii"], x["ft"], x["R"], x["t"], target_image=x["ii"],
        timestep=jnp.zeros((B,), jnp.int32),
        noise=jnp.zeros((B, 3, S, S))))(jax.random.PRNGKey(0))
    # The concat_input_view model: the same leaves, the input conv with 3
    # more input channels.
    civ = jax.tree.map(lambda a: a, params)
    k0 = civ["params"]["unet"]["Conv_0"]["kernel"]
    extra = np.random.default_rng(9).normal(
        0, 0.1, k0.shape).astype(np.float32)
    civ["params"]["unet"]["Conv_0"]["kernel"] = jnp.concatenate(
        [k0, jnp.asarray(extra)], axis=2)
    return x, params, civ


def _close(got, want, tol=F32_TOL):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _jax_apply(params, x, civ, dtype, what):
    m = J.ConsistencyViewSynthesizer(J.CVSConfig(
        image_size=S, base_channels=BASE, concat_input_view=civ,
        dtype=dtype))
    ii = x["ii"] if civ else None
    if what == "train":
        fn = lambda p: m.apply(p, x["ii"], x["ft"], x["R"], x["t"],  # noqa
                               target_image=x["ii"], timestep=x["ts"],
                               noise=x["noise"])["x0_pred"]
    elif what == "infer":
        fn = lambda p: m.apply(p, x["ii"], x["ft"], x["R"], x["t"],  # noqa
                               noise=x["noise"])["generated"]
    elif what == "predict_x0":
        fn = lambda p: m.apply(p, x["ii"], x["ft"], x["R"], x["t"],  # noqa
                               x["noise"], x["ts"], method=m.predict_x0)
    elif what == "gen1":
        fn = lambda p: m.apply(p, x["ft"], x["R"], x["t"], x["noise"], 1,  # noqa
                               input_image=ii, method=m.generate)
    else:
        fn = lambda p: m.apply(p, x["ft"], x["R"], x["t"], x["noise"], 4,  # noqa
                               extra_noise=x["extra"], input_image=ii,
                               method=m.generate)
    return np.asarray(jax.jit(fn)(params), np.float32)


def _port_apply(model, x, civ, what):
    ii = _t(x["ii"])
    args = (ii, _t(x["ft"]), _t(x["R"]), _t(x["t"]))
    with torch.no_grad():
        if what == "train":
            return model(*args, target_image=ii,
                         timestep=_t(x["ts"]).long(),
                         noise=_t(x["noise"]))["x0_pred"]
        if what == "infer":
            return model(*args, noise=_t(x["noise"]))["generated"]
        if what == "predict_x0":
            return model.predict_x0(*args, _t(x["noise"]),
                                    _t(x["ts"]).long())
        gen = dict(input_image=ii if civ else None)
        if what == "gen1":
            return model.generate(*args[1:], _t(x["noise"]), 1, **gen)
        return model.generate(*args[1:], _t(x["noise"]), 4,
                              extra_noise=_t(x["extra"]), **gen)


def test_state_dict_keys_are_the_flax_paths(run):
    _, params, _ = run
    flat = _flat(params)
    sd = T.ConsistencyViewSynthesizer(
        T.CVSConfig(image_size=S, base_channels=BASE)).state_dict()
    conv = cvs_params(flat)
    assert set(sd) == set(conv) and len(sd) == len(flat) == 325
    for k, v in conv.items():
        assert tuple(sd[k].shape) == tuple(v.shape), k


def test_full_width_model_size():
    """256^2, base 128: 273 leaves, 64 714 245 parameters (the JAX
    package's count under jax.eval_shape)."""
    with torch.device("meta"):
        m = T.ConsistencyViewSynthesizer(T.CVSConfig())
    ps = list(m.parameters())
    assert len(ps) == 273
    assert sum(p.numel() for p in ps) == 64_714_245


@pytest.mark.parametrize("what,civ", [
    ("train", False), ("infer", False), ("predict_x0", False),
    ("gen1", False), ("gen4", False), ("train", True), ("gen1", True)])
def test_model_f32(run, what, civ):
    x, params, civ_params = run
    p = civ_params if civ else params
    want = _jax_apply(p, x, civ, None, what)
    got = _port_apply(_port(_flat(p), concat_input_view=civ), x, civ, what)
    _close(got, want)


@pytest.mark.parametrize("what", ["train", "gen1"])
def test_model_bf16(run, what):
    x, params, _ = run
    want = _jax_apply(params, x, False, jnp.bfloat16, what)
    want32 = _jax_apply(params, x, False, None, what)
    got = _port_apply(_port(_flat(params), dtype=torch.bfloat16), x, False,
                      what).float().numpy()
    scale = np.abs(want32).max()
    err = np.abs(got - want).max() / scale
    gap = np.abs(want - want32).max() / scale
    assert err <= BF16_ABS and err <= BF16_GAP * gap, (err, gap)


def test_model_requires_its_inputs(run):
    x, params, civ_params = run
    m = _port(_flat(civ_params), concat_input_view=True)
    with pytest.raises(ValueError, match="input view"):
        m.generate(_t(x["ft"]), _t(x["R"]), _t(x["t"]), _t(x["noise"]))
    m = _port(_flat(params))
    with pytest.raises(ValueError, match="timestep"):
        m(_t(x["ii"]), _t(x["ft"]), _t(x["R"]), _t(x["t"]),
          target_image=_t(x["ii"]))


# ---------------------------------------------------------------- blocks

def _block_pair(jmod, tmod, jargs, targs, dtype=None):
    p = jax.jit(lambda k: jmod.init(k, *jargs))(jax.random.PRNGKey(1))
    tmod.load_state_dict(cvs_params(_flat(p)))
    want = np.asarray(jax.jit(lambda p: jmod.apply(p, *jargs))(p),
                      np.float32)
    with torch.no_grad():
        got = tmod(*targs)
    return got, want


def _nhwc(a):
    return np.ascontiguousarray(np.transpose(a, (0, 2, 3, 1)))


@pytest.mark.parametrize("dtype", [None, "bf16"])
@pytest.mark.parametrize("block", ["res_skip", "res", "cross", "fresnel16",
                                   "fresnel8", "attn", "pose", "adapter"])
def test_blocks(block, dtype):
    rng = np.random.default_rng(3)
    jdt = jnp.bfloat16 if dtype else None
    tdt = torch.bfloat16 if dtype else None
    temb = rng.normal(size=(B, 256)).astype(np.float32)
    ctx = rng.normal(size=(B, 24, 384)).astype(np.float32)
    side = 8 if block == "fresnel8" else 16
    cin = 32 if block == "res_skip" else 64
    x = rng.normal(size=(B, cin, side, side)).astype(np.float32)
    if block.startswith("res"):
        pair = (J.ResBlock(64, 256, dtype=jdt), T.ResBlock(cin, 64, 256, tdt),
                (_nhwc(x), temb), (_t(x), _t(temb)))
    elif block == "cross":
        pair = (J.CrossAttention2D(dtype=jdt),
                T.CrossAttention2D(64, 384, dtype=tdt),
                (_nhwc(x), ctx), (_t(x), _t(ctx)))
    elif block.startswith("fresnel"):
        pair = (J.FresnelWaveAttention(dtype=jdt),
                T.FresnelWaveAttention(64, dtype=tdt), (_nhwc(x),), (_t(x),))
    elif block == "attn":
        pair = (J.AttentionBlock(dtype=jdt), T.AttentionBlock(64, 384, tdt),
                (_nhwc(x), ctx), (_t(x), _t(ctx)))
    elif block == "pose":
        R = np.stack([np.linalg.qr(rng.normal(size=(3, 3)))[0]
                      for _ in range(B)]).astype(np.float32)
        t = rng.normal(size=(B, 3)).astype(np.float32)
        pair = (J.PluckerPoseEncoder(dtype=jdt),
                T.PluckerPoseEncoder(dtype=tdt), (R, t), (_t(R), _t(t)))
    else:
        f = rng.normal(size=(B, 37, 37, 384)).astype(np.float32)
        pair = (J.ImageFeatureAdapter(dtype=jdt),
                T.ImageFeatureAdapter(dtype=tdt), (f,), (_t(f),))
    got, want = _block_pair(*pair)
    if got.dim() == 4:                                   # NCHW -> NHWC
        got = got.permute(0, 2, 3, 1)
    _close(got, want, BF16_ABS if dtype else 1e-5)


def test_unet_alone(run):
    x, params, _ = run
    m = J.ConsistencyViewSynthesizer(J.CVSConfig(image_size=S,
                                                 base_channels=BASE))
    rng = np.random.default_rng(5)
    ic = rng.normal(size=(B, 256, 384)).astype(np.float32)
    pc = rng.normal(size=(B, 16, 384)).astype(np.float32)
    tt = np.array([999.0, 3.0], np.float32)
    want = jax.jit(lambda p: m.apply(
        p, x["noise"], tt, ic, pc,
        method=lambda mm, *a: mm.unet(*a)))(params)
    unet = _port(_flat(params)).unet
    with torch.no_grad():
        got = unet(_t(x["noise"]), _t(tt), _t(ic), _t(pc))
    _close(got, want)


# ---------------------------------------------------------------- pieces

def test_schedule_bits():
    m = J.ConsistencyViewSynthesizer(J.CVSConfig())
    want = jax.jit(lambda: m.apply({}, method=m.schedule))()
    got = T.schedule_tables(1000, torch.device("cpu"))
    np.testing.assert_array_equal(got["betas"].numpy(),
                                  np.asarray(J.cosine_beta_schedule(1000)))
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v))
    seq = np.cumprod(1.0 - np.asarray(want["betas"]), dtype=np.float32)
    assert np.abs(seq - np.asarray(want["alphas_cumprod"])).max() > 0


def test_stride2_same_padding():
    """3x3 stride 2 on an even size: XLA's "SAME" pads (0, 1), so the
    first output row and column see no padding; nn.Conv2d(padding=1)
    pads both sides and gives another result."""
    import flax.linen as fnn

    x = np.random.default_rng(4).normal(size=(1, 32, 8, 8)).astype(
        np.float32)
    jconv = fnn.Conv(32, (3, 3), strides=(2, 2), padding="SAME")
    p = jconv.init(jax.random.PRNGKey(0), _nhwc(x))
    want = np.asarray(jconv.apply(p, _nhwc(x))).transpose(0, 3, 1, 2)
    conv = T.Conv(32, 32, 3, stride=2)
    conv.load_state_dict(cvs_params(_flat(p)))
    with torch.no_grad():
        got = conv(_t(x))
        sym = torch.nn.functional.conv2d(_t(x), conv.weight, conv.bias,
                                         stride=2, padding=1)
    assert got.shape == (1, 32, 4, 4)
    _close(got, want, 1e-6)
    assert np.abs(sym.numpy() - want).max() > 1e-2


def test_relative_pose_and_embedding():
    rng = np.random.default_rng(6)
    Rs, Rt = (np.stack([np.linalg.qr(rng.normal(size=(3, 3)))[0]
                        for _ in range(3)]).astype(np.float32)
              for _ in range(2))
    ts_, tt = (rng.normal(size=(3, 3)).astype(np.float32) for _ in range(2))
    want = J.get_relative_pose(Rs, ts_, Rt, tt)
    got = T.get_relative_pose(_t(Rs), _t(ts_), _t(Rt), _t(tt))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    steps = np.array([0.0, 1.0, 500.0, 999.0], np.float32)
    np.testing.assert_allclose(
        T.sinusoidal_embed(_t(steps), 256).numpy(),
        np.asarray(J.sinusoidal_embed(jnp.asarray(steps), 256)), atol=5e-5)


def test_flax_like_init():
    m = T.ConsistencyViewSynthesizer(T.CVSConfig(image_size=S,
                                                 base_channels=BASE))
    init_flax_like_(m, torch.Generator().manual_seed(0))
    sd = m.state_dict()
    assert all(float(v) == pytest.approx(0.1) for k, v in sd.items()
               if k.endswith("wavelength"))
    for k in ("image_adapter.pos_embed", "image_adapter.compress_queries",
              "pose_encoder.pose_queries"):
        assert abs(float(sd[k].std()) - 0.02) < 2e-3, k
    assert torch.all(sd["unet.GroupNorm_0.weight"] == 1.0)
    w = sd["unet.ResBlock_0.Conv_0.weight"]                # fan_in 9 * 32
    assert abs(float(w.std()) - 1 / math.sqrt(9 * 32)) < 1e-2
    assert torch.all(sd["unet.ResBlock_0.Conv_0.bias"] == 0.0)
