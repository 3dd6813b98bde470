"""Port parity: the v2 step with its render loss (`use_render_loss`: L1 +
0.5 x (1 - SSIM) of the predicted and teacher clouds rendered at 128^2,
M 256) against the JAX package's on the CPU, at test_torch_v2_train.py's
small config.  One jitted JAX step is shared by the file (module
fixture), both models with dropout 0: 2 steps from the JAX init.

* Each loss term at both steps within 1e-5 relative (render_ssim 2e-5:
  a mean of 128^2 ratios of small differences); params per leaf within
  1e-6 by mean.
* The renders go through `render_tiled_batched`, twice a step: once for
  the B predicted clouds (with a gradient) and once for the B teacher
  clouds (none); masked Gaussians get opacity 0; on the card each is one
  K1 launch (and the prediction's backward one K2: test_torch_cuda.py).
* With the render loss off the step makes no render call.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import flax.serialization as ser

from fresnel_tpu.data import trellis as JD
from fresnel_tpu.train import train_direct_decoder as J
from fresnel_tpu_torch.train import train_direct_decoder as T
from fresnel_tpu_torch.train.flax_msgpack import flatten
from fresnel_tpu_torch.weights import v2_state
from test_torch_threads import _few_threads  # noqa: F401

CFG = dict(feature_dim=32, hidden_dim=48, num_layers=2, num_heads=4,
           num_gaussians_per_voxel=2, max_coords=64, max_gaussians=128,
           max_match_points=64, batch_size=2, use_render_loss=True)
DATA = dict(max_coords=64, max_gaussians=128, n_gaussians=100,
            feature_dim=32, num_patches=16)
LOSS_RTOL = {"render_ssim": 2e-5}
PARAM_MEAN_TOL = 1e-6
STEPS = 2


def _flat_state(state):
    return {k: np.asarray(v)
            for k, v in flatten(ser.to_state_dict(state)).items()}


@pytest.fixture(scope="module")
def run():
    ds = JD.SyntheticTrellisDataset(n_samples=2 * STEPS, seed=1, **DATA)
    batches = list(ds.batches(2, np.random.default_rng(0)))
    jt = J.V2Trainer(J.V2Config(**CFG))
    jt.model = jt.model.clone(dropout=0.0)
    state = jax.jit(jt.init_state)(batches[0])
    init = _flat_state(state)
    step = jt._build_step()
    losses = []
    rng = jax.random.PRNGKey(1)
    for b in batches:
        rng, srng = jax.random.split(rng)
        state, ld = step(state, jax.tree.map(jnp.asarray, b), srng)
        losses.append({k: float(v) for k, v in ld.items()})
    return dict(batches=batches, init=init, losses=losses,
                final=_flat_state(state))


def _port_run(run, monkeypatch, **over):
    calls = []
    orig = T.render_tiled_batched

    def spy(p, s, r, c, o, *a, **k):
        calls.append(dict(grad=p.requires_grad, n=p.shape[1],
                          zero_op=int((o == 0).sum()), shape=p.shape))
        return orig(p, s, r, c, o, *a, **k)

    monkeypatch.setattr(T, "render_tiled_batched", spy)
    tt = T.V2Trainer(T.V2Config(**dict(CFG, **over)), device="cpu")
    tt.model.dropout = 0.0
    state = v2_state(run["init"])
    losses = []
    for b in run["batches"]:
        state, ld = tt.train_step(state, tt.device_batch(b))
        losses.append({k: float(v) for k, v in ld.items()})
    return losses, state, calls


def test_render_step_matches_jax(run, monkeypatch):
    losses, state, calls = _port_run(run, monkeypatch)
    for jl, tl in zip(run["losses"], losses):
        assert set(jl) == set(tl)
        assert {"render_rgb", "render_ssim"} <= set(tl)
        for k, v in jl.items():
            assert abs(tl[k] - v) <= LOSS_RTOL.get(k, 1e-5) * abs(v), k
    want = v2_state(run["final"])["params"]
    for k, v in want.items():
        assert (state["params"][k] - v).abs().mean().item() \
            <= PARAM_MEAN_TOL, k
    # Two batched renders a step: the predictions (B clouds of max_coords
    # x G, with a gradient) and the teachers (B of max_gaussians, none).
    assert [c["grad"] for c in calls] == [True, False] * STEPS
    assert [c["n"] for c in calls] == [64 * 2, 128] * STEPS
    assert all(c["shape"][0] == 2 for c in calls)
    for b, (pc, tc) in zip(run["batches"], zip(calls[::2], calls[1::2])):
        assert pc["zero_op"] >= 2 * (~b["coord_mask"]).sum()
        assert tc["zero_op"] >= (~b["gaussian_mask"]).sum()


def test_no_render_without_the_flag(run, monkeypatch):
    losses, _, calls = _port_run(run, monkeypatch, use_render_loss=False)
    assert calls == []
    assert "render_rgb" not in losses[0]
