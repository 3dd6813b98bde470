"""Port parity: DirectPatchDecoder (K = 4) and its head transform.

JAX params carried over with fresnel_tpu_torch.weights; the same numpy
features and depth go through both, at atol = rtol = 1e-5 (float32 on
both sides; the MLP's sums are taken in another order).  With
feature_upsample (2 and 3: the bilinear upsample, the 3x3 `upsample_conv`,
tanh GELU and the `upsample_refine` residual, whose zero init is replaced
by random kernels so the branch counts) the fields and the raw head
outputs are held at the same tolerance.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.traverse_util import flatten_dict

from fresnel_tpu.models import decoders as jd

from fresnel_tpu_torch import weights
from fresnel_tpu_torch.models import decoders as td
from fresnel_tpu_torch.train.config import TrainingConfig
from fresnel_tpu_torch.train.harness import Trainer
from test_torch_threads import _few_threads  # noqa: F401


TOL = dict(atol=1e-5, rtol=1e-5)
KEYS = ("positions", "scales", "rotations", "colors", "opacities")


@pytest.fixture(autouse=True)
def _full_f32():
    torch.backends.cuda.matmul.allow_tf32 = False


def _inputs(seed, grid=6, C=48, depth_hw=40):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(2, grid, grid, C)).astype(np.float32)
    depth = rng.uniform(size=(2, depth_hw, depth_hw)).astype(np.float32)
    return feats, depth


def _pair(C=48, hidden=(64, 32), **kw):
    jm = jd.DirectPatchDecoder(feature_dim=C, gaussians_per_patch=4,
                               hidden_dims=hidden, **kw)
    feats, depth = _inputs(0, C=C)
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(feats),
                     jnp.asarray(depth))
    flat = {k: np.asarray(v)
            for k, v in flatten_dict(params["params"], sep="/").items()}
    flat["depth_offset"] = np.asarray(-1.7, np.float32)   # not the init
    tm = td.DirectPatchDecoder(feature_dim=C, gaussians_per_patch=4,
                               hidden_dims=hidden, **kw)
    tm.load_state_dict(weights.decoder_state_dict(flat), strict=True)
    jparams = {"params": dict(params["params"],
                              depth_offset=jnp.asarray(flat["depth_offset"]))}
    return jm, jparams, tm.eval()


@pytest.mark.parametrize("with_depth", [True, False])
def test_decoder_matches_jax(with_depth):
    jm, params, tm = _pair()
    feats, depth = _inputs(1)
    jdepth = jnp.asarray(depth) if with_depth else None
    tdepth = torch.from_numpy(depth) if with_depth else None
    ref = jm.apply(params, jnp.asarray(feats), jdepth)
    with torch.no_grad():
        out = tm(torch.from_numpy(feats), tdepth)
    assert out["positions"].shape == (2, 6 * 6 * 4, 3)
    for k in KEYS:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   err_msg=k, **TOL)


def test_decoder_biases_and_num_gaussians():
    jm, params, tm = _pair(scale_bias=-2.6, opacity_bias=1.5)
    feats, depth = _inputs(2)
    ref = jm.apply(params, jnp.asarray(feats), jnp.asarray(depth),
                   num_gaussians=2)
    with torch.no_grad():
        out = tm(torch.from_numpy(feats), torch.from_numpy(depth),
                 num_gaussians=2)
    assert out["opacities"].shape == (2, 6 * 6 * 2)
    for k in KEYS:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   err_msg=k, **TOL)


def test_head_transform_matches_jax():
    rng = np.random.default_rng(3)
    raw = rng.normal(size=(1, 5, 5, 4, 16)).astype(np.float32) * 3.0
    raw[0, 0, 0, 0, 3:6] = [30.0, -30.0, 0.0]     # scale clip bounds
    raw[0, 0, 1, 0, 9:12] = raw[0, 0, 1, 0, 6:9]  # parallel 6D axes
    depth = rng.uniform(size=(1, 37, 37)).astype(np.float32)
    off = np.asarray(-2.0, np.float32)
    ref = jd.head_transform(jnp.asarray(raw), jnp.asarray(depth),
                            jnp.asarray(off))
    out = td.head_transform(torch.from_numpy(raw), torch.from_numpy(depth),
                            torch.from_numpy(off))
    for k in KEYS:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   err_msg=k, **TOL)


def test_resize_depth_to_grid_no_antialias():
    depth = np.random.default_rng(4).uniform(size=(1, 256, 256, 1)).astype(
        np.float32)
    ref = jd._resize_depth_to_grid(jnp.asarray(depth), 37, 37)
    out = td._resize_depth_to_grid(torch.from_numpy(depth), 37, 37)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("batch,grid", [(2, 37), (4, 37), (1, 74), (2, 74)])
def test_resize_depth_to_grid_bits(batch, grid):
    """One rounding for every batch size: bit for bit with XLA:CPU except
    for a single image at 37^2, where its dot kernel fuses the column
    step too (the test above bounds that case)."""
    depth = np.random.default_rng(5).uniform(
        size=(batch, 256, 256)).astype(np.float32)
    ref = np.asarray(jd._resize_depth_to_grid(jnp.asarray(depth), grid, grid))
    out = td._resize_depth_to_grid(torch.from_numpy(depth), grid, grid)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("f", [2, 3])
def test_feature_upsample_matches_jax(f):
    C, hidden = 16, (32,)
    feats, depth = _inputs(6, C=C)
    jm = jd.DirectPatchDecoder(feature_dim=C, gaussians_per_patch=2,
                               hidden_dims=hidden, feature_upsample=f,
                               scale_bias=-2.6, opacity_bias=1.5)
    params = jm.init(jax.random.PRNGKey(4), jnp.asarray(feats),
                     jnp.asarray(depth))
    flat = {k: np.asarray(v)
            for k, v in flatten_dict(params["params"], sep="/").items()}
    assert not flat["upsample_refine/kernel"].any()       # zero init
    flat["upsample_refine/kernel"] = np.random.default_rng(7).normal(
        size=(3, 3, C, C)).astype(np.float32) * 0.1
    jparams = {"params": dict(params["params"], upsample_refine=dict(
        params["params"]["upsample_refine"],
        kernel=jnp.asarray(flat["upsample_refine/kernel"])))}
    want = jax.jit(lambda p, x, d: jm.apply(p, x, d, return_raw=True))(
        jparams, jnp.asarray(feats), jnp.asarray(depth))
    tm = td.DirectPatchDecoder(feature_dim=C, gaussians_per_patch=2,
                               hidden_dims=hidden, feature_upsample=f,
                               scale_bias=-2.6, opacity_bias=1.5)
    tm.load_state_dict(weights.decoder_state_dict(flat), strict=True)
    with torch.no_grad():
        out = tm.eval()(torch.from_numpy(feats), torch.from_numpy(depth),
                        return_raw=True)
    g = 6 * f
    assert out["positions"].shape == (2, g * g * 2, 3)
    assert out["raw"].shape == (2, g, g, 2, 16)
    for k in KEYS + ("raw",):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)


def test_feature_upsample_init_is_flax_like():
    tm = td.DirectPatchDecoder(feature_dim=8, gaussians_per_patch=1,
                               hidden_dims=(8,), feature_upsample=2)
    weights.init_flax_like_(tm, torch.Generator().manual_seed(0))
    assert not tm.upsample_refine.weight.any()
    assert not tm.upsample_refine.bias.any()
    w = tm.upsample_conv.weight
    assert w.shape == (8, 8, 3, 3) and 0.05 < w.std().item() < 0.2
    feats = torch.randn(1, 3, 3, 8)
    with torch.no_grad():
        assert tm(feats)["positions"].shape == (1, 36, 3)


@pytest.mark.parametrize("flag", [
    dict(use_fresnel_zones=True), dict(use_edge_aware=True),
    dict(use_phase_output=True), dict(use_pose_encoding=True),
    dict(use_depth_fusion=True),
    dict(feature_upsample=2, use_edge_aware=True),
    dict(feature_upsample=3, use_depth_fusion=True)])
def test_unported_options_raise(flag):
    """Each option builds (held against Flax in
    tests/test_torch_decoder_options.py); with it, the Trainer's
    still-unported `use_amp` raises."""
    td.DirectPatchDecoder(gaussians_per_patch=4, **flag)
    cfg = TrainingConfig(experiment=2, gaussians_per_patch=4, use_amp=True,
                         **flag)
    with pytest.raises(NotImplementedError, match="use_amp"):
        Trainer(cfg, device="cpu")
