"""Port parity: experiment 4's FibonacciPatchDecoder against the JAX
package's (fresnel_tpu/models/fibonacci.py), on the CPU.

* The spiral (models/blocks.py): bit for bit against the JAX function
  jitted, at 377 and 5 476 points (XLA turns idx / n into idx * (1 / n) and
  calls the C library's cosf / sinf; theta reaches 13 140 rad at 5 476).
  Run op by op, JAX divides and its x and y differ from the port's by up
  to 2 ulp, 5.96e-8 (measured; held at 6e-8).
* The sampled depths (the depth-locked z of every spiral point on a 256^2
  `synthetic_corpus` depth): bit for bit against the jitted JAX head for
  a batch of 2, where XLA fuses each row's right tap; for one image XLA
  fuses the left tap, and 17 of 377 and 257 of 5 476 values differ by
  1 ulp (measured; held at 1 ulp, 2.4e-7, in at most 6 % of the points).
* `sample_grid_at` at arbitrary coordinates, border clipping included,
  against JAX op by op: atol 1e-6.
* `fib_head_transform` and the decoder (C 32, hidden 64 / 32, N 377 and
  5 476, params converted by `weights.decoder_state_dict`): every field
  and the raw head outputs within 1e-5 of that field's largest value
  (float32; the MLP sums in another order), except the decoder's
  rotations: Gram-Schmidt on nearly parallel 6D axes magnifies raw's
  ~1e-7 differences to 1.56e-5 at 5 476 random points (measured; held at
  2e-5), while JAX's own conversion of the port's raw gives the port's
  rotations within 1e-6.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.traverse_util import flatten_dict

from fresnel_tpu.core.gaussians import rotation_6d_to_quaternion as jrot
from fresnel_tpu.data import synthetic_corpus as jcorpus
from fresnel_tpu.models import fibonacci as jf
from fresnel_tpu.models.blocks import fibonacci_spiral_positions as jspiral

from fresnel_tpu_torch import weights
from fresnel_tpu_torch.models import fibonacci as tf
from fresnel_tpu_torch.models.blocks import fibonacci_spiral_positions
from fresnel_tpu_torch.train.config import TrainingConfig
from fresnel_tpu_torch.train.harness import Trainer
from test_torch_threads import _few_threads  # noqa: F401

N_POINTS = [377, 5476]
FIELDS = ("positions", "scales", "rotations", "colors", "opacities")
REL_TOL = 1e-5


@pytest.fixture(scope="module")
def depths(tmp_path_factory):
    root = tmp_path_factory.mktemp("fib_corpus")
    jcorpus.generate_corpus(str(root), n_images=2, image_size=256, seed=5)
    return np.stack([np.fromfile(root / f"scene_{i:04d}_depth.bin",
                                 np.float32).reshape(256, 256)
                     for i in range(2)])


def _close(got, want, err_msg="", tol=REL_TOL):
    """Within `tol` of the reference field's largest value."""
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= tol * np.abs(want).max(), (err_msg, err)


@pytest.mark.parametrize("n", N_POINTS)
def test_spiral_matches_jax(n):
    x, y = fibonacci_spiral_positions(n)
    jx, jy = jax.jit(lambda: jspiral(n))()
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    ex, ey = jspiral(n)
    assert max(np.abs(x.numpy() - np.asarray(ex)).max(),
               np.abs(y.numpy() - np.asarray(ey)).max()) <= 6e-8
    assert x.dtype == torch.float32 and x.shape == (n,)


def _jit_z(d, n):
    head = jax.jit(lambda raw, dd: jf.fib_head_transform(
        raw, dd, jnp.asarray(-2.0))["positions"][..., 2])
    return np.asarray(head(jnp.zeros((len(d), n, 1, 16)), jnp.asarray(d)))


def _port_z(d, n):
    return tf.fib_head_transform(torch.zeros(len(d), n, 1, 16),
                                 torch.from_numpy(d), torch.tensor(-2.0)
                                 )["positions"][..., 2].numpy()


@pytest.mark.parametrize("n", N_POINTS)
def test_sampled_depths_bits(depths, n):
    np.testing.assert_array_equal(_port_z(depths, n), _jit_z(depths, n))
    one = depths[:1]
    diff = np.abs(_port_z(one, n) - _jit_z(one, n))
    assert diff.max() <= 2.4e-7 and (diff > 0).sum() <= 0.06 * n


def test_sample_grid_at_matches_jax():
    rng = np.random.default_rng(0)
    grid = rng.normal(size=(2, 9, 11, 3)).astype(np.float32)
    coords = rng.uniform(-1.2, 1.2, size=(50, 2)).astype(np.float32)
    coords[:4] = [[-1, -1], [1, 1], [-1, 1], [1.0, -1.0]]
    want = np.stack([np.asarray(jf.sample_grid_at(jnp.asarray(g),
                                                  jnp.asarray(coords)))
                     for g in grid])
    got = tf.sample_grid_at(torch.from_numpy(grid), torch.from_numpy(coords))
    assert got.shape == (2, 50, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("case", ["depth", "no_depth", "pose"])
def test_fib_head_transform_matches_jax(depths, case):
    rng = np.random.default_rng(1)
    raw = (rng.normal(size=(2, 377, 2, 16)) * 3.0).astype(np.float32)
    raw[0, 0, 0, 3:6] = [30.0, -30.0, 0.0]       # the scale clip bounds
    raw[0, 1, 0, 9:12] = raw[0, 1, 0, 6:9]       # parallel 6D axes
    off = np.asarray(-0.13, np.float32)
    kw = dict(scale_bias=-2.6, opacity_bias=1.5)
    d = None if case == "no_depth" else depths
    pose = {}
    if case == "pose":
        pose = dict(elevation=np.asarray([0.3, -0.2], np.float32),
                    azimuth=np.asarray([1.1, 4.0], np.float32))
    want = jf.fib_head_transform(
        jnp.asarray(raw), None if d is None else jnp.asarray(d),
        jnp.asarray(off), **kw, **{k: jnp.asarray(v) for k, v in pose.items()})
    got = tf.fib_head_transform(
        torch.from_numpy(raw), None if d is None else torch.from_numpy(d),
        torch.from_numpy(off), **kw,
        **{k: torch.from_numpy(v) for k, v in pose.items()})
    for k in FIELDS:
        assert got[k].shape == want[k].shape, k
        _close(got[k].numpy(), want[k], k)


@pytest.mark.parametrize("n", N_POINTS)
def test_decoder_matches_jax(depths, n):
    C, hidden = 32, (64, 32)
    rng = np.random.default_rng(n)
    feats = rng.normal(size=(2, 37, 37, C)).astype(np.float32)
    kw = dict(feature_dim=C, n_points=n, hidden_dims=hidden,
              scale_bias=-2.6, opacity_bias=1.5)
    jm = jf.FibonacciPatchDecoder(**kw)
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(feats[:1]),
                     jnp.asarray(depths[:1]))
    flat = {k: np.asarray(v)
            for k, v in flatten_dict(params["params"], sep="/").items()}
    flat["depth_offset"] = np.asarray(-0.13, np.float32)
    params = {"params": dict(params["params"],
                             depth_offset=jnp.asarray(flat["depth_offset"]))}
    want = jax.jit(lambda p, f, d: jm.apply(p, f, d, num_gaussians=4,
                                            return_raw=True))(
        params, jnp.asarray(feats), jnp.asarray(depths))
    tm = tf.FibonacciPatchDecoder(**kw)
    tm.load_state_dict(weights.decoder_state_dict(flat), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(feats), torch.from_numpy(depths),
                 num_gaussians=4, return_raw=True)
    assert got["positions"].shape == (2, n, 3)
    assert got["raw"].shape == (2, n, 1, 16)
    for k in FIELDS + ("raw",):
        _close(got[k].numpy(), want[k], k,
               2e-5 if k == "rotations" else REL_TOL)
    np.testing.assert_allclose(
        got["rotations"].numpy(),
        np.asarray(jrot(jnp.asarray(got["raw"][..., 6:12].numpy())))
        .reshape(2, n, 4), atol=1e-6, rtol=0)
    # Z is depth-locked: the sampled depths, not the MLP, set it.
    np.testing.assert_array_equal(got["positions"][..., 2].numpy(),
                                  np.asarray(want["positions"][..., 2]))


def test_decoder_init_and_dropout():
    tm = tf.FibonacciPatchDecoder(feature_dim=8, n_points=20,
                                  hidden_dims=(16,))
    weights.init_flax_like_(tm, torch.Generator().manual_seed(0))
    assert tm.depth_offset.item() == -2.0
    assert not tm.mlp.layers[0].bias.any()
    feats = torch.randn(1, 5, 5, 8)
    a = tm(feats, deterministic=False,
           generator=torch.Generator().manual_seed(1), return_raw=True)
    b = tm(feats, return_raw=True)
    assert not torch.equal(a["raw"], b["raw"])
    assert torch.equal(tm(feats)["positions"], b["positions"])


@pytest.mark.parametrize("flag", [dict(use_fresnel_zones=True),
                                  dict(use_phase_output=True),
                                  dict(use_pose_encoding=True)])
def test_unported_options_raise(flag):
    """Each option builds (held against Flax in
    tests/test_torch_decoder_options.py); with it, experiment 4 under
    phase blending (the Fourier renderer) still raises."""
    tf.FibonacciPatchDecoder(**flag)
    cfg = TrainingConfig(experiment=4, use_phase_blending=True, **flag)
    with pytest.raises(NotImplementedError, match="use_phase_blending"):
        Trainer(cfg, device="cpu")
