"""Port parity: raw-head distillation in experiment 2's grid head space
against the JAX package's Trainer, on the CPU.

A 4-scene `synthetic_corpus` at 32^2; `fit_teacher.main --experiment 2
--grid 5 --K 4` writes each scene's `{stem}_teacher.npz` (2 steps); the
decoder (feature grid 5 x 48 channels, K 2, scale_bias -2.6, opacity_bias
1.5, dropout 0 on both sides) distils the teachers' first 2 of 4
Gaussians per patch.  One JAX Trainer run for the file: two steps from
one init at distill_weight 0.5, `total` and `distill` within 1e-5
relative at each step, and the depth offset after them within 1e-6.
`distill_loss` itself against the JAX step's formula written out in
numpy, in both teacher layouts (relative 1e-6).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.traverse_util import flatten_dict

from fresnel_tpu.data import dataset as jds
from fresnel_tpu.data import synthetic_corpus as jcorpus
from fresnel_tpu.train import config as jconfig
from fresnel_tpu.train.harness import Trainer as JTrainer

from fresnel_tpu_torch.train import config as tconfig
from fresnel_tpu_torch.train import fit_teacher as tfit
from fresnel_tpu_torch.train.harness import (
    Trainer, build_decoder, distill_loss)
from fresnel_tpu_torch.weights import trainer_params
from test_torch_threads import _few_threads  # noqa: F401

STEPS, K = 2, 2
CFG = dict(experiment=2, epochs=1, batch_size=2, image_size=32,
           feature_size=5, feature_dim=48, gaussians_per_patch=K,
           max_per_tile=64, lr=2e-4, weight_decay=1e-5, scale_bias=-2.6,
           opacity_bias=1.5, depth_offset_init=-0.128, distill_weight=0.5,
           rgb_weight=1.0, ssim_weight=0.5, depth_weight=0.1,
           lpips_weight=0.0, use_augmentation=False, save_interval=100,
           seed=0)
HFGS = dict(use_phase_retrieval_loss=False, use_frequency_loss=False,
            learnable_wavelengths=False)
DS = dict(image_size=32, feature_size=5, feature_dim=48,
          use_augmentation=False)


def _flat(params):
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            for kk, vv in flatten_dict(v, sep="/").items():
                out[f"{k}/{kk}"] = np.array(vv)
        else:
            out[k] = np.array(v)
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("distill2")
    data = root / "data"
    jcorpus.generate_corpus(str(data), n_images=4, image_size=32, seed=6)
    tfit.main(["--data_dir", str(data), "--grid", "5", "--K", "4",
               "--steps", "2", "--res", "32", "--device", "cpu"])
    jdata = jds.ImageDataset(str(data), **DS)
    jt = JTrainer(jconfig.TrainingConfig(output_dir=str(root / "j"), **CFG),
                  jconfig.PhysicsConfig(), jconfig.HFGSConfig(**HFGS),
                  jconfig.HFTSConfig())
    jt.model = jt.model.clone(dropout=0.0)
    jt._make_optimizer(STEPS)
    nprng = np.random.default_rng(0)
    first = next(iter(jdata.batches(2, nprng)))
    assert first["teacher_raw"].shape == (2, 5, 5, 4, 16)
    state = jt.init_state(first)
    init = _flat(state["params"])
    step_fn = jt.get_step(K, None)
    rng = jax.random.PRNGKey(1)
    batches, losses = [], []
    for batch in jdata.batches(2, nprng):
        batches.append(batch)
        rng, sr = jax.random.split(rng)
        state, ld = step_fn(state, jt._device_batch(batch, nprng), sr)
        losses.append({k: float(v) for k, v in ld.items()})
    do = float(state["params"]["model"]["params"]["depth_offset"])
    return dict(root=root, init=init, batches=batches, losses=losses, do=do)


def test_grid_distill_steps_match_jax(run):
    t = Trainer(tconfig.TrainingConfig(output_dir=str(run["root"] / "t"),
                                       **CFG),
                tconfig.PhysicsConfig(), tconfig.HFGSConfig(**HFGS),
                tconfig.HFTSConfig(), device="cpu")
    t.model = build_decoder(t.config, t.physics_config, dropout=0.0)
    t._make_optimizer(STEPS)
    params = {k: v.clone() for k, v in trainer_params(run["init"]).items()}
    state = {"params": params, "opt_state": t.optimizer.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    gen = torch.Generator().manual_seed(1)
    for batch, want in zip(run["batches"], run["losses"]):
        state, ld = t.train_step(state, t.device_batch(batch), K, None, gen)
        assert set(ld) == set(want)
        for k in ("total", "distill"):
            got = float(ld[k])
            assert abs(got - want[k]) <= 1e-5 * abs(want[k]), (k, got,
                                                                want[k])
    assert want["distill"] > 0.01
    assert abs(state["params"]["model.depth_offset"].item()
               - run["do"]) <= 1e-6


@pytest.mark.parametrize("layout", [(5, 5), (377,)])
def test_distill_loss_formula(layout):
    """`distill_loss` against the JAX step's formula written out in numpy:
    the teachers' first K of 4 Gaussians, shifted by the head biases, the
    Huber loss (delta 1) weighted by channel group, plus the squared
    error of the depth offset."""
    rng = np.random.default_rng(len(layout))
    raw = rng.normal(size=(2, *layout, K, 16)).astype(np.float32) * 2
    teacher = rng.normal(size=(2, *layout, 4, 16)).astype(np.float32) * 2
    t_do = np.asarray([-0.1, -0.2], np.float32)
    cfg = tconfig.TrainingConfig(scale_bias=-2.6, opacity_bias=1.5)
    adj = np.zeros(16, np.float32)
    adj[3:6], adj[15] = 2.6, -1.5
    diff = raw - (teacher[..., :K, :] + adj)
    huber = np.where(np.abs(diff) < 1, 0.5 * diff * diff, np.abs(diff) - 0.5)
    gw = np.asarray([1.0] * 3 + [0.5] * 3 + [0.3] * 6 + [0.25] * 3 + [0.5])
    want = (huber * gw).mean() + ((-0.15 - t_do) ** 2).mean()
    got = distill_loss(torch.from_numpy(raw), torch.from_numpy(teacher),
                       torch.from_numpy(t_do), torch.tensor(-0.15), K, cfg)
    assert abs(got.item() - want) <= 1e-6 * want
