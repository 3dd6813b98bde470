"""Port parity: two experiment-5 `Trainer` steps (NCAGaussianDecoder) with
`use_amp` against the JAX package's, on the CPU, at
test_torch_experiments135.py's config (32^2, 55 spiral points, 2 NCA
steps, batch 2, lr 1e-4, the 384-wide cached features of
SyntheticGaussianDataset), from one init moved off JAX's zero-initialised
update layer, the NCA's update masks JAX's own draws.  One JAX Trainer
for the file: its bf16 step and, for JAX's own bf16-against-float32 gap,
its float32 step.

Under `use_amp` only the features and the depth are rounded to bf16: the
spiral samples them with float32 weights, so from there the JAX module
runs in float32 on bf16-rounded parameters (its kNN distances float32).
Held as in test_torch_amp_train.py: each loss term within 2 x the larger
of JAX's own gap and 1e-4 of the term, the parameters' mean absolute
difference within 2 x JAX's own and each entry within 2 * lr * steps,
and the decoder seen to run on bf16 parameters with JAX's float32
outputs.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fresnel_tpu.data.dataset import SyntheticGaussianDataset as JSynth
from fresnel_tpu.train import config as jconfig
from fresnel_tpu.train.harness import Trainer as JTrainer

from fresnel_tpu_torch.train import config as tconfig
from fresnel_tpu_torch.train.harness import Trainer
from fresnel_tpu_torch.weights import trainer_params
from test_torch_amp_train import GAP, LOSS_FLOOR, _flat, dtype_probe
from test_torch_experiments135 import _jax_nca_masks, _perturb
from test_torch_threads import _few_threads  # noqa: F401

STEPS, LR = 2, 1e-4
CFG = dict(experiment=5, epochs=1, batch_size=2, image_size=32,
           gaussians_per_patch=1, n_spiral_points=55, nca_steps=2,
           lpips_weight=0.0, lr=LR, use_amp=True)
HFGS = dict(use_phase_retrieval_loss=False, use_frequency_loss=False,
            learnable_wavelengths=False)


def _run_jax(batches, state, step, keys):
    state = jax.tree.map(jnp.array, state)
    losses = []
    for batch, key in zip(batches, keys):
        state, ld = step(state, jax.tree.map(jnp.asarray, batch), key)
        losses.append({k: float(v) for k, v in ld.items()})
    return losses, trainer_params(_flat(state["params"]))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("amp_nca")
    ds = JSynth(n_samples=4, image_size=32, n_gaussians=30, seed=5)
    batches = list(ds.batches(2, np.random.default_rng(0)))[:STEPS]
    jt = JTrainer(jconfig.TrainingConfig(output_dir=str(root), **CFG),
                  jconfig.PhysicsConfig(), jconfig.HFGSConfig(**HFGS),
                  jconfig.HFTSConfig())
    jt._make_optimizer(STEPS)
    state = jt.init_state(batches[0])
    state["params"] = _perturb(state["params"], 7, 0.02)
    state["opt_state"] = jt.optimizer.init(state["params"])
    init = _flat(state["params"])
    keys = [jax.random.PRNGKey(i) for i in range(STEPS)]
    amp = _run_jax(batches, state, jt.get_step(1, None), keys)
    jt.config = dataclasses.replace(jt.config, use_amp=False)
    f32 = _run_jax(batches, state, jt._build_step(1, None), keys)
    masks = [torch.from_numpy(_jax_nca_masks(k, (2, 2, 55, 1))) for k in keys]

    t = Trainer(tconfig.TrainingConfig(output_dir=str(root), **CFG),
                tconfig.PhysicsConfig(), tconfig.HFGSConfig(**HFGS),
                tconfig.HFTSConfig(), device="cpu")
    t._make_optimizer(STEPS)
    params = {k: v.clone() for k, v in trainer_params(init).items()}
    tstate = {"params": params, "opt_state": t.optimizer.init(params),
              "step": torch.zeros((), dtype=torch.int32)}
    gen = torch.Generator().manual_seed(0)
    seen, hooks = dtype_probe(t.model)
    losses = []
    for batch, m in zip(batches, masks):
        tstate, ld = t.train_step(tstate, t.device_batch(batch), 1, None,
                                  gen, nca_masks=m)
        losses.append({k: float(v) for k, v in ld.items()})
    for h in hooks:
        h.remove()
    return dict(amp=amp, f32=f32, port=(losses, tstate["params"]),
                seen=seen)


def test_nca_amp_runs_on_bf16_params(run):
    f32 = torch.float32
    assert len(run["seen"]) == STEPS
    for name, params, outs in run["seen"]:
        assert name == "NCAGaussianDecoder"
        assert params == {torch.bfloat16}
        assert outs == dict(positions=f32, scales=f32, rotations=f32,
                            colors=f32, opacities=f32)


def test_nca_amp_losses_match_jax(run):
    (want, _), (f32, _), (got, _) = run["amp"], run["f32"], run["port"]
    assert len(want) == len(got) == STEPS
    for w, f, g in zip(want, f32, got):
        assert set(w) == set(g)
        for k in w:
            assert np.isfinite(g[k])
            gap = max(abs(w[k] - f[k]), LOSS_FLOOR * abs(w[k]))
            assert abs(g[k] - w[k]) <= GAP * gap, (k, g[k], w[k], f[k])


def test_nca_amp_params_match_jax(run):
    (_, want), (_, f32), (_, got) = run["amp"], run["f32"], run["port"]
    assert set(want) == set(got)
    for k, p in got.items():
        assert p.dtype == torch.float32
        assert (p - want[k]).abs().max().item() <= 2 * LR * STEPS, k
    n = sum(p.numel() for p in got.values())
    err = sum((got[k] - want[k]).abs().sum().item() for k in got) / n
    gap = sum((want[k] - f32[k]).abs().sum().item() for k in got) / n
    assert err <= GAP * gap, (err, gap)
