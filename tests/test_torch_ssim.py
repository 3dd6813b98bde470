"""Port parity: SSIM, multi-scale SSIM and the Sobel filter against the
JAX package, on the CPU.

Both sides are float32.  The port filters separably (rows, then columns)
where JAX convolves with the 2-D window, so sums differ in rounding only:
SSIM within 2e-6, MS-SSIM within 1e-6 at two to five levels and as SSIM
at one, their gradients within 1e-4 of the gradient's largest entry,
Sobel maps within 1e-6.  The 2-D window itself is bit-identical.
"""

import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fresnel_tpu.physics.fresnel_zones import sobel_gradients as jsobel

from fresnel_tpu_torch.physics.fresnel_zones import sobel_gradients
from test_torch_threads import _few_threads  # noqa: F401


# The packages' __init__ export the function `ssim` under the module's name.
jssim_mod = importlib.import_module("fresnel_tpu.losses.ssim")
tssim_mod = importlib.import_module("fresnel_tpu_torch.losses.ssim")


def _pair(shape, seed, smooth):
    rng = np.random.default_rng(seed)
    if smooth:
        B, C, H, W = shape
        y, x = np.mgrid[0:H, 0:W] / max(H, W)
        a = 0.5 + 0.4 * np.sin(6 * x[None, None] + rng.uniform(0, 6, (B, C, 1, 1))
                               ) * np.cos(4 * y[None, None])
    else:
        a = rng.uniform(size=shape)
    b = np.clip(a + rng.normal(scale=0.08, size=shape), 0, 1)
    return a.astype(np.float32), b.astype(np.float32)


@pytest.mark.parametrize("size", [11, 12, 15])
def test_window_matches_jax(size):
    j = np.asarray(jssim_mod._gaussian_window(size, 1.5))
    taps = tssim_mod._gaussian_window(size, 1.5)
    np.testing.assert_array_equal(np.outer(taps, taps), j)


@pytest.mark.parametrize("shape,smooth", [
    ((1, 3, 32, 32), False), ((2, 3, 40, 48), True),
    ((1, 3, 8, 9), False),          # window shrinks to 7
    ((1, 1, 6, 6), True),           # window shrinks to 5
])
def test_ssim_and_grad_match_jax(shape, smooth):
    a, b = _pair(shape, seed=sum(shape), smooth=smooth)
    jv, jg = jax.value_and_grad(lambda x: jssim_mod.ssim(x, jnp.asarray(b)))(
        jnp.asarray(a))
    ta = torch.from_numpy(a).requires_grad_()
    tv = tssim_mod.ssim(ta, torch.from_numpy(b))
    tv.backward()
    assert abs(tv.item() - float(jv)) <= 2e-6
    jg = np.asarray(jg)
    err = np.abs(ta.grad.numpy() - jg).max()
    assert err <= 1e-4 * np.abs(jg).max(), err


def test_ssim_per_image_and_loss():
    a, b = _pair((3, 3, 24, 24), seed=1, smooth=True)
    j = np.asarray(jssim_mod.ssim(jnp.asarray(a), jnp.asarray(b),
                                  size_average=False))
    t = tssim_mod.ssim(torch.from_numpy(a), torch.from_numpy(b),
                       size_average=False)
    np.testing.assert_allclose(t.numpy(), j, atol=2e-6)
    # (C, H, W) inputs are batched; ssim_loss is 1 - ssim.
    jl = float(jssim_mod.ssim_loss(jnp.asarray(a[0]), jnp.asarray(b[0])))
    tl = tssim_mod.ssim_loss(torch.from_numpy(a[0]), torch.from_numpy(b[0]))
    assert abs(tl.item() - jl) <= 2e-6
    assert abs(tssim_mod.ssim(torch.from_numpy(a), torch.from_numpy(a)).item()
               - 1.0) <= 1e-6


# (shape, levels): min side 9 shrinks the window to 9 (one level), 16
# keeps one level, 32 two, 64 three, 128 four, 256 all five; 40 x 50
# keeps two by its shorter side, and 65 drops an odd row and column at
# each downsampling.
MS_SHAPES = [((1, 3, 9, 12), 1), ((2, 3, 16, 16), 1), ((2, 3, 32, 32), 2),
             ((2, 3, 64, 64), 3), ((2, 1, 40, 50), 2), ((1, 3, 65, 65), 3),
             ((2, 3, 128, 128), 4), ((1, 3, 256, 256), 5)]


@pytest.mark.parametrize("shape,levels", MS_SHAPES,
                         ids=["x".join(map(str, s)) for s, _ in MS_SHAPES])
def test_ms_ssim_matches_jax(shape, levels):
    """ms_ssim within 1e-6 at every level count `usable` can take (a
    single level is SSIM itself, held at SSIM's 2e-6: on a 9 x 12 image
    the window leaves 4 values a channel, and JAX's own eager and jitted
    runs part by 8.3e-7 there), and its gradient within 1e-4 of the
    gradient's largest entry, as SSIM's."""
    side, usable = min(shape[-2:]), 1
    win = 11 if side >= 11 else side - (side + 1) % 2
    while usable < 5 and side // 2 ** usable >= win:
        usable += 1
    assert usable == levels
    a, b = _pair(shape, seed=sum(shape), smooth=shape[-1] % 2 == 0)
    jv, jg = jax.jit(jax.value_and_grad(
        lambda x: jssim_mod.ms_ssim(x, jnp.asarray(b))))(jnp.asarray(a))
    ta = torch.from_numpy(a).requires_grad_()
    tv = tssim_mod.ms_ssim(ta, torch.from_numpy(b))
    tv.backward()
    tol = 2e-6 if levels == 1 else 1e-6
    assert abs(tv.item() - float(jv)) <= tol, (tv.item(), float(jv))
    jg = np.asarray(jg)
    err = np.abs(ta.grad.numpy() - jg).max()
    assert err <= 1e-4 * np.abs(jg).max(), err
    # (C, H, W) is batched; identical images give 1.
    assert abs(tssim_mod.ms_ssim(torch.from_numpy(a[0]), torch.from_numpy(
        b[0])).item() - float(jssim_mod.ms_ssim(jnp.asarray(a[0]),
                                                jnp.asarray(b[0])))) <= tol
    assert abs(tssim_mod.ms_ssim(torch.from_numpy(a), torch.from_numpy(
        a)).item() - 1.0) <= 1e-6


@pytest.mark.parametrize("shape", [(20, 30), (2, 17, 9), (2, 1, 16, 16)])
def test_sobel_matches_jax(shape):
    x = np.random.default_rng(len(shape)).uniform(size=shape).astype(
        np.float32)
    for j, t in zip(jsobel(jnp.asarray(x)), sobel_gradients(torch.from_numpy(x))):
        assert t.shape == shape
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6)
