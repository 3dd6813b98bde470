"""Port parity: `DiffractiveLayer` and `MultiscaleDiffractiveLayer`
(fresnel_tpu/physics/diffraction.py) against the JAX package on the CPU.

The Flax modules are initialised from a seed, their flat params converted
by `weights.diffractive_state_dict` and loaded strictly into the port's
modules; the phases are drawn at a scale of 3 so that `mod 2 pi` wraps
some of them.  Forward on (C, H, W) and (B, C, H, W) complex64 fields,
the gradients of a seeded weighted sum of |out|^2 and Re(out) with
respect to the field and every parameter, and `regularization_loss` with
its gradients: all within 1e-5 of each one's largest value (float32 cos /
sin of arguments below 2 pi and the resizes' products, rounded apart).
"""

import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import traverse_util

from fresnel_tpu.physics import diffraction as jd

from fresnel_tpu_torch import weights
from fresnel_tpu_torch.physics import (
    DiffractiveLayer, MultiscaleDiffractiveLayer)
from test_torch_threads import _few_threads  # noqa: F401

TOL = 1e-5


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _field(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64)


def _flax(module, field, seed):
    params = module.init(jax.random.PRNGKey(seed), jnp.asarray(field))
    # Wider phases than the init's 0.1, so that mod 2 pi wraps some.
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: v * 30.0 if "phase" in jax.tree_util.keystr(p) else v,
        params)
    flat = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        params["params"], sep="/").items()}
    return params, flat


def _port(cls, flat, *args, **kw):
    m = cls(*args, **kw)
    m.load_state_dict(weights.diffractive_state_dict(flat), strict=True)
    return m


def _loss_weights(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


def _check(jmodule, params, tmodule, field):
    wa, wr = _loss_weights(9, field.shape)

    def jloss(p, f):
        out = jmodule.apply(p, f)
        return jnp.sum(wa * jnp.abs(out) ** 2) + jnp.sum(wr * out.real)

    jf = jnp.asarray(field)
    jout = np.asarray(jmodule.apply(params, jf))
    gp, gf = jax.grad(jloss, argnums=(0, 1))(params, jf)
    tf = torch.from_numpy(field).requires_grad_()
    tout = tmodule(tf)
    loss = ((torch.from_numpy(wa) * tout.abs() ** 2).sum()
            + (torch.from_numpy(wr) * tout.real).sum())
    names = [n for n, _ in tmodule.named_parameters()]
    grads = torch.autograd.grad(loss, [tf] + list(tmodule.parameters()))
    assert tout.dtype == torch.complex64
    assert _rel(tout.detach().numpy(), jout) <= TOL
    # jax.grad of a real loss in a complex input is the conjugate of
    # torch's convention.
    assert _rel(grads[0].numpy(), np.conj(np.asarray(gf))) <= TOL
    flat_g = traverse_util.flatten_dict(gp["params"], sep=".")
    for name, g in zip(names, grads[1:]):
        assert _rel(g.numpy(), np.asarray(flat_g[name])) <= TOL, name


@pytest.mark.parametrize("batched", [False, True])
def test_diffractive_layer_matches_jax(batched):
    shape = (2, 3, 24, 20) if batched else (3, 24, 20)
    field = _field(0, shape)
    jm = jd.DiffractiveLayer(24, 20)
    params, flat = _flax(jm, field, 1)
    assert set(flat) == {"amplitude_raw", "phase"}
    tm = _port(DiffractiveLayer, flat, 24, 20)
    _check(jm, params, tm, field)


@pytest.mark.parametrize("batched", [False, True])
def test_multiscale_diffractive_layer_matches_jax(batched):
    shape = (2, 3, 32, 24) if batched else (3, 32, 24)
    field = _field(2, shape)
    jm = jd.MultiscaleDiffractiveLayer(32, 24)
    params, flat = _flax(jm, field, 3)
    assert sorted(flat) == sorted(f"scale_{s}/{k}" for s in range(3)
                                  for k in ("amplitude_raw", "phase"))
    tm = _port(MultiscaleDiffractiveLayer, flat, 32, 24)
    assert tm.scale_2.amplitude_raw.shape == (3, 8, 6)
    _check(jm, params, tm, field)
    with pytest.raises(ValueError, match="field is"):
        tm(torch.from_numpy(_field(4, (3, 16, 24))))


def test_regularization_loss_matches_jax():
    field = _field(5, (3, 16, 12))
    jm = jd.DiffractiveLayer(16, 12)
    params, flat = _flax(jm, field, 6)
    tm = _port(DiffractiveLayer, flat, 16, 12)

    def jreg(p):
        return jm.apply(p, method=jd.DiffractiveLayer.regularization_loss)

    want = float(jreg(params))
    gp = traverse_util.flatten_dict(jax.grad(jreg)(params)["params"],
                                    sep=".")
    got = tm.regularization_loss()
    grads = torch.autograd.grad(got, list(tm.parameters()))
    assert abs(got.item() - want) <= TOL * abs(want)
    for (name, _), g in zip(tm.named_parameters(), grads):
        assert _rel(g.numpy(), np.asarray(gp[name])) <= TOL, name


def test_fresh_layers_init_as_jax_does():
    g = torch.Generator().manual_seed(0)
    m = DiffractiveLayer(8, 8, init_amplitude=0.3, init_phase_scale=0.2,
                         generator=g)
    assert torch.all(m.amplitude_raw == 0.3)
    assert 0.1 < m.phase.std().item() < 0.3
    amp, ph = m.transmission()
    assert torch.all((ph >= 0) & (ph < 2 * np.pi))
    ms = MultiscaleDiffractiveLayer(9, 5, num_scales=4, generator=g)
    assert [tuple(getattr(ms, f"scale_{s}").phase.shape)
            for s in range(4)] == [(3, 9, 5), (3, 4, 2), (3, 2, 1),
                                   (3, 1, 1)]


@pytest.mark.parametrize("absent", ["fresnel_tpu_torch.models",
                                    "fresnel_tpu_torch.render"])
def test_physics_imports_alone(absent):
    """The physics package (the diffractive layers, the edge detector)
    imports first in a fresh interpreter, without the layers above it:
    what it shares with them lives in core/ops.py."""
    code = ("import sys, fresnel_tpu_torch.physics; "
            f"sys.exit({absent!r} in sys.modules)")
    assert subprocess.run([sys.executable, "-c", code]).returncode == 0
