"""Port parity: DINOv2, Depth-Anything (DPT) and their resize helpers.

JAX params, initialised from a seed, are carried over with
fresnel_tpu_torch.weights; the same numpy images go through both.  The
tiny config is tests/test_vit.py's (width 64, depth 4, heads 2, image 56,
out 32, taps (1, 2, 3, 4), small neck).  float32 at 1e-4, the bound
vit.py pins against HF torch.  bf16 compute rounds at other places in the
two frameworks; it is held at 3e-2 of the float32 output's largest
magnitude, well inside the 5% that tests/test_vit.py allows bf16 against
float32 within JAX itself.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from fresnel_tpu.models import vit as jv

from fresnel_tpu_torch import weights
from fresnel_tpu_torch.models import vit as tv

KW = dict(width=64, depth=4, heads=2)
DA_KW = dict(out_size=32, image_size=56, out_indices=(1, 2, 3, 4),
             neck_channels=(8, 16, 32, 64), fusion=16, head_hidden=8, **KW)


@pytest.fixture(autouse=True)
def _full_f32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _flat(params):
    return {k: np.asarray(v)
            for k, v in flatten_dict(params["params"], sep="/").items()}


def _images(seed, size=56, batch=1):
    return np.random.default_rng(seed).uniform(
        size=(batch, size, size, 3)).astype(np.float32)


@functools.cache
def _dino_pair(dtype=torch.float32, jdtype=jnp.float32):
    jm = jv.DINOv2(image_size=56, dtype=jdtype, **KW)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 56, 56, 3)))
    tm = tv.DINOv2(image_size=56, dtype=dtype, **KW)
    tm.load_state_dict(weights.dinov2_state_dict(_flat(params)), strict=True)
    return jax.jit(jm.apply, static_argnames="out_indices"), params, tm.eval()


@functools.cache
def _depth_pair(dtype=torch.float32, jdtype=jnp.float32):
    jm = jv.DepthAnything(dtype=jdtype, **DA_KW)
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.zeros((1, 56, 56, 3)))
    # Random init leaves LayerScale at 1e-5 and the blocks near identity;
    # scale them up so the test sees the attention and MLP paths.
    flat = _flat(params)
    for k in flat:
        if k.endswith("gamma"):
            flat[k] = np.full_like(flat[k], 0.5)
    tm = tv.DepthAnything(dtype=dtype, **DA_KW)
    tm.load_state_dict(weights.depth_anything_state_dict(flat), strict=True)
    jparams = {"params": unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})}
    return jax.jit(jm.apply, static_argnames="raw"), jparams, tm.eval()


class TestDINOv2:
    def test_features_f32(self):
        jm, params, tm = _dino_pair()
        x = _images(0, batch=2)
        ref = np.asarray(jm(params, jnp.asarray(x)))
        with torch.no_grad():
            out = tm(torch.from_numpy(x))
        assert out.shape == (2, 4, 4, 64) and out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)

    def test_taps_f32(self):
        jm, params, tm = _dino_pair()
        x = _images(1)
        ref = jm(params, jnp.asarray(x), out_indices=(1, 3, 4))
        with torch.no_grad():
            out = tm(torch.from_numpy(x), out_indices=(1, 3, 4))
        assert len(out) == 3
        for a, b in zip(out, ref):
            assert a.shape == (1, 17, 64)
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       atol=1e-4, rtol=1e-4)

    def test_features_bf16(self):
        jm, params, tm = _dino_pair(torch.bfloat16, jnp.bfloat16)
        x = _images(2)
        ref = np.asarray(jm(params, jnp.asarray(x)))
        with torch.no_grad():
            out = tm(torch.from_numpy(x))
        assert out.dtype == torch.float32
        err = np.abs(out.numpy() - ref).max() / np.abs(ref).max()
        assert err < 3e-2, err


class TestDepthAnything:
    def test_depth_f32(self):
        jm, params, tm = _depth_pair()
        x = _images(3)
        ref = np.asarray(jm(params, jnp.asarray(x)))
        with torch.no_grad():
            out = tm(torch.from_numpy(x))
        assert out.shape == (1, 32, 32)
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)

    def test_raw_head_f32(self):
        jm, params, tm = _depth_pair()
        x = _images(4)
        ref = np.asarray(jm(params, jnp.asarray(x), raw=True))
        with torch.no_grad():
            out = tm(torch.from_numpy(x), raw=True)
        assert out.shape == (1, 56, 56)
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)

    def test_depth_bf16(self):
        jm, params, tm = _depth_pair(torch.bfloat16, jnp.bfloat16)
        x = _images(5)
        ref = np.asarray(jm(params, jnp.asarray(x), raw=True))
        with torch.no_grad():
            out = tm(torch.from_numpy(x), raw=True)
        assert out.dtype == torch.float32
        err = np.abs(out.numpy() - ref).max() / np.abs(ref).max()
        assert err < 3e-2, err


class TestResize:
    @pytest.mark.parametrize("shape,out", [((2, 5, 7, 3), (9, 4)),
                                           ((1, 19, 19, 4), (37, 37)),
                                           ((1, 8, 8, 2), (1, 3))])
    def test_bilinear_align_corners(self, shape, out):
        x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
        ref = np.asarray(jv.resize_bilinear_ac(jnp.asarray(x), *out))
        got = tv.resize_bilinear_ac(torch.from_numpy(x), *out)
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)

    @pytest.mark.parametrize("old,new", [(16, 37), (37, 4), (5, 5)])
    def test_interpolate_pos_embed(self, old, new):
        pos = np.random.default_rng(1).normal(
            size=(1, old * old + 1, 8)).astype(np.float32)
        np.testing.assert_array_equal(tv.interpolate_pos_embed(pos, new),
                                      jv.interpolate_pos_embed(pos, new))

    @pytest.mark.parametrize("src,dst,antialias", [
        (518, 256, True),    # DepthAnything's output resize (vit.py:438)
        (256, 37, False),    # the decoder's depth-to-grid resize
        (512, 518, False),   # bench.py's input upsample
    ])
    def test_jax_linear_resize_counterparts(self, src, dst, antialias):
        """jax.image.resize(..., "linear") antialiases when it downsamples;
        its torch counterpart is bilinear with align_corners=False and the
        matching antialias flag."""
        x = np.random.default_rng(2).uniform(size=(1, src, src)).astype(
            np.float32)
        if src > dst and not antialias:
            ref = jax.image.resize(jnp.asarray(x), (1, dst, dst), "linear",
                                   antialias=False)
        else:
            ref = jax.image.resize(jnp.asarray(x), (1, dst, dst), "linear")
        got = torch.nn.functional.interpolate(
            torch.from_numpy(x)[:, None], size=(dst, dst), mode="bilinear",
            align_corners=False, antialias=antialias)[:, 0]
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


class TestInit:
    def test_flax_like_init(self):
        g = torch.Generator().manual_seed(0)
        m = weights.init_flax_like_(tv.DepthAnything(**DA_KW), g)
        assert torch.all(m.backbone.blocks[0].ls1.gamma == 1e-5)
        assert torch.all(m.backbone.blocks[0].attn.qkv.bias == 0)
        w = m.backbone.blocks[0].mlp_fc1.weight
        assert abs(w.std().item() - 64 ** -0.5) < 0.2 * 64 ** -0.5
        g2 = torch.Generator().manual_seed(0)
        m2 = weights.init_flax_like_(tv.DepthAnything(**DA_KW), g2)
        for a, b in zip(m.state_dict().values(), m2.state_dict().values()):
            assert torch.equal(a, b)
