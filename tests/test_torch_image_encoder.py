"""Port parity: `models.image_encoder.ImageEncoder` against the JAX
package's, on the CPU, float32, from the same (converted) Flax init.

Forward within 1e-4 absolute of JAX's output at attn_pool 1 and 2 on
32^2 images (grid 5, width 8, feature_dim 48; measured 4.5e-6 and
3.8e-6), and at the flagship width on one 256^2 image (grid 37, width 64,
feature_dim 384, attn_pool 1; measured 6.1e-6).  The same encoder with
symmetric padding at the stride-2 convolutions (what `padding=k // 2`
would give) is off by more than 1e-2 (measured 4.3), so the asymmetric
"SAME" padding is what the 1e-4 holds.  The output is LayerNorm-ed, so
the tolerance is absolute on values of order one.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.traverse_util import flatten_dict

from fresnel_tpu.models.image_encoder import ImageEncoder as JEncoder

from fresnel_tpu_torch.models import image_encoder as te
from fresnel_tpu_torch.weights import image_encoder_state_dict
from test_torch_threads import _few_threads  # noqa: F401


TOL = 1e-4


def _pair(feature_dim, grid, width, attn_pool, size, batch, seed):
    img = np.random.default_rng(seed).uniform(
        size=(batch, 3, size, size)).astype(np.float32)
    j = JEncoder(feature_dim=feature_dim, grid=grid, width=width,
                 attn_pool=attn_pool)
    params = j.init(jax.random.PRNGKey(seed), jnp.asarray(img))
    want = np.asarray(j.apply(params, jnp.asarray(img)))
    t = te.ImageEncoder(feature_dim=feature_dim, grid=grid, width=width,
                        attn_pool=attn_pool)
    t.load_state_dict(image_encoder_state_dict(
        flatten_dict(params["params"], sep="/"), attn_pool=attn_pool))
    return t, torch.from_numpy(img), want


@pytest.mark.parametrize("attn_pool", [1, 2])
def test_forward_matches_jax(attn_pool):
    t, img, want = _pair(48, 5, 8, attn_pool, 32, 2, attn_pool)
    with torch.no_grad():
        got = t(img).numpy()
    assert got.shape == want.shape == (2, 5, 5, 48)
    assert np.abs(got - want).max() <= TOL


def test_forward_matches_jax_at_flagship_width():
    t, img, want = _pair(384, 37, 64, 1, 256, 1, 7)
    with torch.no_grad():
        got = t(img).numpy()
    assert got.shape == want.shape == (1, 37, 37, 384)
    assert np.abs(got - want).max() <= TOL


def test_symmetric_padding_would_fail(monkeypatch):
    t, img, want = _pair(48, 5, 8, 1, 32, 2, 1)
    monkeypatch.setattr(te, "same_padding", lambda size, k, s: (k // 2,
                                                                 k // 2))
    with torch.no_grad():
        got = t(img).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() > 1e-2


@pytest.mark.parametrize("size,k,s,want", [(296, 5, 2, (1, 2)),
                                           (148, 3, 2, (0, 1)),
                                           (74, 3, 2, (0, 1)),
                                           (37, 3, 1, (1, 1))])
def test_same_padding(size, k, s, want):
    assert te.same_padding(size, k, s) == want


def test_attention_heads_and_converted_keys():
    assert [te.attention_heads(d) for d in (384, 48, 64, 10, 7)] == \
        [6, 6, 4, 5, 1]
    t, _, _ = _pair(48, 5, 8, 2, 32, 1, 3)
    assert "pool_norm.weight" in dict(t.named_parameters())
