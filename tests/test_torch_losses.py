"""Port parity: the training losses on the CPU, float32, on (2, 3, 32, 32)
renders from a seed.

* `FresnelZones`: boundaries, `quantize_depth` (values on a boundary go
  to the lower zone) exact; `boundary_mask` with and without a learnable
  emphasis, soft and hard, within 1e-6.
* `compute_losses`: every key of the loss dict within 1e-5 relative of
  JAX's (measured: 2.4e-6 at most), under configs that switch on the VLM
  weighting, the boundary term with emphasis, the residual term, the
  wave-equation term, HFGS phase retrieval with learnable wavelengths and
  the frequency loss (`dft2` is an FFT here, a DFT matmul in JAX), and the
  gradient in `rendered` of the total and of each term within 1e-5 of its
  largest entry (measured: 4.8e-7 for the total).
* The LPIPS term (random lpips-alex weights in both packages) from 256^2
  renders, which the term shrinks to 128^2 with antialiasing, and from
  64^2, which it upsamples: the term and the total within 1e-6, the
  gradient of the total in `rendered` within 1e-5 of its largest entry.
* `tensegrity_loss` and its gradient within 1e-5 relative;
  `normalized_depth_l1` within 1e-6.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.traverse_util import unflatten_dict

from fresnel_tpu.losses import aggregate as jagg
from fresnel_tpu.losses import lpips as jlpips
from fresnel_tpu.losses import physics as jphys
from fresnel_tpu.models.blocks import tensegrity_loss as jtens
from fresnel_tpu.physics.fresnel_zones import FresnelZones as JZones
from fresnel_tpu.train import config as jconfig

from fresnel_tpu_torch.losses import aggregate as tagg
from fresnel_tpu_torch.losses import lpips as tlpips
from fresnel_tpu_torch.losses import physics as tphys
from fresnel_tpu_torch.models.blocks import tensegrity_loss as ttens
from fresnel_tpu_torch.physics.fresnel_zones import FresnelZones as TZones
from fresnel_tpu_torch.train import config as tconfig
from fresnel_tpu_torch.weights import lpips_state_dict
from test_torch_threads import _few_threads  # noqa: F401


GRAD_TOL = 1e-5


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    rendered = rng.uniform(-0.05, 1.05, (2, 3, 32, 32)).astype(np.float32)
    target = rng.uniform(0, 1, (2, 3, 32, 32)).astype(np.float32)
    rdepth = rng.uniform(0, 3, (2, 32, 32)).astype(np.float32)
    tdepth = rng.uniform(0, 1, (2, 32, 32)).astype(np.float32)
    vlm = rng.uniform(0, 1, (2, 1, 8, 8)).astype(np.float32)
    res = {"pos_delta": rng.normal(size=(2, 10, 3)).astype(np.float32),
           "opacity_delta": rng.normal(size=(2, 10)).astype(np.float32)}
    return rendered, target, rdepth, tdepth, vlm, res


def test_zones_quantize_and_boundaries():
    j, t = JZones(num_zones=8), TZones(num_zones=8)
    np.testing.assert_array_equal(np.asarray(j.zone_boundaries),
                                  t.zone_boundaries().numpy())
    d = np.concatenate([np.linspace(-0.2, 1.2, 57), np.arange(9) / 8.0]
                       ).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(j.quantize_depth(jnp.asarray(d))),
        t.quantize_depth(torch.from_numpy(d)).numpy())
    np.testing.assert_array_equal(
        np.asarray(j.zone_centers_for_depth(jnp.asarray(d))),
        t.zone_centers_for_depth(torch.from_numpy(d)).numpy())


@pytest.mark.parametrize("soft", [True, False])
@pytest.mark.parametrize("emph", [False, True])
def test_boundary_mask_matches(soft, emph):
    d = np.random.default_rng(1).uniform(0, 1, (2, 16, 16)).astype(np.float32)
    e = (np.random.default_rng(2).uniform(0.5, 2.0, 9).astype(np.float32)
         if emph else None)
    j = JZones(soft_boundaries=soft).boundary_mask(
        jnp.asarray(d), emphasis=None if e is None else jnp.asarray(e))
    t = TZones(soft_boundaries=soft).boundary_mask(
        torch.from_numpy(d), emphasis=None if e is None
        else torch.from_numpy(e))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6)


CASES = {
    "default": (dict(), dict(), dict(use_phase_retrieval_loss=False,
                                     use_frequency_loss=False)),
    "vlm_boundary_residual": (dict(use_vlm_guidance=True, vlm_weight=0.5,
                                   learnable_boundary_emphasis=True),
                              dict(), dict(use_phase_retrieval_loss=False,
                                           use_frequency_loss=False)),
    "hfgs_wave": (dict(), dict(wave_equation_weight=1e-9),
                  dict(use_phase_retrieval_loss=True,
                       use_frequency_loss=True, learnable_wavelengths=True)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_compute_losses_matches(case):
    ckw, pkw, hkw = CASES[case]
    rendered, target, rdepth, tdepth, vlm, res = _inputs()
    emph = np.linspace(0.5, 1.5, 9).astype(np.float32)
    wl = np.asarray(jphys.init_learnable_wavelengths()) + 0.1
    use_e = ckw.get("learnable_boundary_emphasis", False)
    use_wl = hkw.get("learnable_wavelengths", False)

    def jloss(r):
        return jagg.compute_losses(
            r, jnp.asarray(target), rendered_depth=jnp.asarray(rdepth),
            target_depth=jnp.asarray(tdepth),
            residuals={k: jnp.asarray(v) for k, v in res.items()},
            config=jconfig.TrainingConfig(image_size=32, **ckw),
            vlm_density=jnp.asarray(vlm),
            physics_config=jconfig.PhysicsConfig(**pkw),
            hfgs_config=jconfig.HFGSConfig(**hkw),
            learnable_wavelengths_raw=jnp.asarray(wl) if use_wl else None,
            fresnel_zones=JZones(num_zones=8),
            boundary_emphasis=jnp.asarray(emph) if use_e else None)

    (jt, jd), jg = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(rendered))
    r = torch.from_numpy(rendered).requires_grad_()
    tt, td = tagg.compute_losses(
        r, torch.from_numpy(target),
        rendered_depth=torch.from_numpy(rdepth),
        target_depth=torch.from_numpy(tdepth),
        residuals={k: torch.from_numpy(v) for k, v in res.items()},
        config=tconfig.TrainingConfig(image_size=32, **ckw),
        vlm_density=torch.from_numpy(vlm),
        physics_config=tconfig.PhysicsConfig(**pkw),
        hfgs_config=tconfig.HFGSConfig(**hkw),
        learnable_wavelengths_raw=torch.from_numpy(wl) if use_wl else None,
        fresnel_zones=TZones(num_zones=8),
        boundary_emphasis=torch.from_numpy(emph) if use_e else None)
    assert set(td) == set(jd)
    for k in jd:
        want = float(jd[k])
        got = float(td[k].detach())
        assert abs(got - want) <= 1e-5 * abs(want), (k, got, want)
    (tg,) = torch.autograd.grad(tt, r, retain_graph=True)
    jg = np.asarray(jg)
    err = np.abs(tg.numpy() - jg).max()
    assert err <= GRAD_TOL * np.abs(jg).max(), err
    # Each term's gradient in `rendered`.
    for k in jd:
        jgk = np.asarray(jax.grad(lambda x: jloss(x)[1][k])(
            jnp.asarray(rendered)))
        tgk = (torch.autograd.grad(td[k], r, retain_graph=True)[0].numpy()
               if td[k].requires_grad else np.zeros_like(jgk))
        assert np.abs(tgk - jgk).max() <= GRAD_TOL * max(
            np.abs(jgk).max(), 1e-30), k


def _lpips_pair(seed=0):
    """The same random lpips-alex weights in both packages: JAX's LPIPS
    apply with its Flax params, and the port's module."""
    rng = np.random.default_rng(seed)
    flat, in_c = {}, 3
    for i, (c, k, _, _) in enumerate(tlpips._ALEX_CFG):
        flat[f"trunk/conv{i}/kernel"] = (rng.standard_normal(
            (k, k, in_c, c)) / np.sqrt(k * k * in_c)).astype(np.float32)
        flat[f"trunk/conv{i}/bias"] = (rng.standard_normal(c) * 0.05
                                       ).astype(np.float32)
        flat[f"lin{i}"] = np.abs(rng.standard_normal(c) * 0.1).astype(
            np.float32)
        in_c = c
    jparams = {"params": unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})}
    port = tlpips.LPIPS()
    port.load_state_dict(lpips_state_dict(flat))
    return jlpips.LPIPS().apply, jparams, port.eval().requires_grad_(False)


@pytest.mark.parametrize("size", [256, 64])
def test_lpips_term_matches(size):
    """The LPIPS term from 256^2 (antialiased down to 128^2) and from 64^2
    (upsampled): the term and the total within 1e-6, the gradient of the
    total in `rendered` within GRAD_TOL of its largest entry."""
    rng = np.random.default_rng(size)
    rendered = rng.uniform(-0.05, 1.05, (2, 3, size, size)).astype(
        np.float32)
    target = rng.uniform(0, 1, (2, 3, size, size)).astype(np.float32)
    apply, jparams, port = _lpips_pair()
    cfg = dict(image_size=size, lpips_weight=0.1)

    @jax.jit
    def jloss(r):
        return jagg.compute_losses(
            r, jnp.asarray(target), config=jconfig.TrainingConfig(**cfg),
            lpips_fn=apply, lpips_params=jparams)

    (jt, jd), jg = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(rendered))
    r = torch.from_numpy(rendered).requires_grad_()
    tt, td = tagg.compute_losses(r, torch.from_numpy(target),
                                 config=tconfig.TrainingConfig(**cfg),
                                 lpips_fn=port)
    assert set(td) == set(jd) == {"rgb", "ssim", "lpips", "total"}
    for k in ("lpips", "total"):
        assert abs(td[k].item() - float(jd[k])) <= 1e-6, (
            k, td[k].item(), float(jd[k]))
    (tg,) = torch.autograd.grad(tt, r)
    jg = np.asarray(jg)
    err = np.abs(tg.numpy() - jg).max()
    assert err <= GRAD_TOL * np.abs(jg).max(), err


def test_tensegrity_and_depth_l1_match():
    rng = np.random.default_rng(3)
    pos = rng.normal(size=(2, 40, 3)).astype(np.float32) * 0.3
    jv, jg = jax.value_and_grad(jtens)(jnp.asarray(pos))
    p = torch.from_numpy(pos).requires_grad_()
    tv = ttens(p)
    (tg,) = torch.autograd.grad(tv, p)
    assert abs(tv.item() - float(jv)) <= 1e-5 * abs(float(jv))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(jg)).max())
    a = rng.uniform(0, 3, (2, 16, 16)).astype(np.float32)
    b = rng.uniform(0, 1, (2, 16, 16)).astype(np.float32)
    assert abs(tphys.normalized_depth_l1(torch.from_numpy(a),
                                         torch.from_numpy(b)).item()
               - float(jphys.normalized_depth_l1(jnp.asarray(a),
                                                 jnp.asarray(b)))) <= 1e-6


def test_dft2_and_wavelength_init_match():
    x = np.random.default_rng(4).normal(size=(2, 3, 16, 12)).astype(
        np.float32)
    np.testing.assert_allclose(tphys.dft2(torch.from_numpy(x)).numpy(),
                               np.asarray(jphys.dft2(jnp.asarray(x))),
                               atol=2e-5)
    np.testing.assert_allclose(tphys.init_learnable_wavelengths().numpy(),
                               np.asarray(jphys.init_learnable_wavelengths()),
                               rtol=1e-6)
