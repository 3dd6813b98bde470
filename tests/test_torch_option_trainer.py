"""Port parity: `Trainer` steps with the decoder options the reference's
training launchers set (`cloud/train.sh`, `cloud/train_overnight.sh`:
`--use_fresnel_zones --use_edge_aware`), against the JAX package's, on
the CPU.

One JAX Trainer run (module fixture): 2 steps of experiment 2 with
`use_fresnel_zones` and `use_edge_aware`, dropout 0, on 4 scenes of
`synthetic_corpus` (seed 3, colour jitter; tests/test_torch_trainer.py's
config otherwise), the port from the same converted init: every loss term
within 1e-4 relative (measured 7e-6 at most), each params leaf's mean
absolute difference within 1e-7 (measured 1.1e-8 at most; max within 2 *
lr * steps), except the leaves whose gradient is zero in exact
arithmetic, as in that file.
"""

import re

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
from fresnel_tpu_torch.train.harness import Trainer, build_decoder
from fresnel_tpu_torch.weights import trainer_params
from test_torch_threads import _few_threads  # noqa: F401


# ----------------------------------------------------------------------
# Two Trainer steps with use_fresnel_zones + use_edge_aware
# ----------------------------------------------------------------------

STEPS, K, LR = 2, 2, 2e-4
N_IMAGES, CORPUS_SEED = 4, 3
CFG = dict(experiment=2, epochs=1, batch_size=2, image_size=32,
           feature_size=5, feature_dim=48, encoder_width=8,
           gaussians_per_patch=K, max_per_tile=64, train_encoder=True,
           lr=LR, weight_decay=1e-5, scale_bias=-2.6, opacity_bias=1.5,
           depth_offset_init=-0.128, lpips_weight=0.0, boundary_weight=0.1,
           use_fresnel_zones=True, use_edge_aware=True, save_interval=100,
           seed=0)
HFGS = dict(use_phase_retrieval_loss=False, use_frequency_loss=False,
            learnable_wavelengths=False)
DS = dict(image_size=32, feature_size=5, feature_dim=48,
          use_augmentation=True)


def _flat_state(params):
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            for kk, vv in flatten_dict(v, sep="/").items():
                out[f"{k}/{kk}"] = np.array(vv)
        else:
            out[k] = np.array(v)
    return out


@pytest.fixture(scope="module")
def trainer_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("options_trainer")
    jcorpus.generate_corpus(str(root / "data"), n_images=N_IMAGES,
                            image_size=32, seed=CORPUS_SEED)
    jdata = jds.ImageDataset(str(root / "data"), **DS)
    jt = JTrainer(jconfig.TrainingConfig(output_dir=str(root / "j"), **CFG),
                  jconfig.PhysicsConfig(), jconfig.HFGSConfig(**HFGS),
                  jconfig.HFTSConfig())
    jt.model = jt.model.clone(dropout=0.0)
    jt._make_optimizer(STEPS)
    nprng = np.random.default_rng(0)
    first = next(iter(jdata.batches(2, nprng)))
    state = jt.init_state(first)
    # The surface init the trainer's fit applies (depth_offset_init): at
    # -2 the clouds sit far off and most gradients are near zero, where
    # Adam's first steps are +-lr on rounding noise.
    state["params"]["model"]["params"]["depth_offset"] = jnp.asarray(
        -0.128, jnp.float32)
    init = _flat_state(state["params"])
    step_fn = jt.get_step(K, None)
    rng = jax.random.PRNGKey(1)
    batches, losses = [], []
    for batch in jdata.batches(2, nprng):
        batches.append(batch)
        rng, sr = jax.random.split(rng)
        state, ld = step_fn(state, jt._device_batch(batch, nprng), sr)
        losses.append({k: float(v) for k, v in ld.items()})
    return dict(init=init, batches=batches, losses=losses,
                final=_flat_state(state["params"]), root=root)


@pytest.fixture(scope="module")
def port_run(trainer_run):
    t = Trainer(tconfig.TrainingConfig(
        output_dir=str(trainer_run["root"] / "t"), **CFG),
        tconfig.PhysicsConfig(), tconfig.HFGSConfig(**HFGS),
        tconfig.HFTSConfig(), device="cpu")
    t.model = build_decoder(t.config, t.physics_config, dropout=0.0)
    t._make_optimizer(STEPS)
    params = {k: v.clone() for k, v in
              trainer_params(trainer_run["init"]).items()}
    assert set(params) == {f"model.{k}" for k, _ in
                           t.model.named_parameters()} | {
        f"encoder.{k}" for k, _ in t.encoder.named_parameters()}
    state = {"params": params, "opt_state": t.optimizer.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    gen = torch.Generator().manual_seed(1)
    losses = []
    for batch in trainer_run["batches"]:
        state, ld = t.train_step(state, t.device_batch(batch), K, None, gen)
        losses.append({k: float(v) for k, v in ld.items()})
    return dict(state=state, losses=losses)


def test_trainer_steps_with_zones_and_edges_match_jax(trainer_run, port_run):
    assert len(trainer_run["losses"]) == len(port_run["losses"]) == STEPS
    for want, got in zip(trainer_run["losses"], port_run["losses"]):
        assert set(want) == set(got)
        for k, w in want.items():
            assert abs(got[k] - w) <= 1e-4 * max(abs(w), 1e-6), (k, got[k], w)
    want = trainer_params(trainer_run["final"])
    got = port_run["state"]["params"]
    assert any(k.startswith("model.edge_detector.") for k in want)
    zero_grad = re.compile(r"res\.\d\.conv1\.bias|attn\.k\.bias")
    for k, w in want.items():
        d = (got[k] - w).abs()
        assert d.max().item() <= 2 * LR * STEPS, (k, d.max().item())
        if not zero_grad.search(k):
            assert d.mean().item() <= 1e-7, (k, d.mean().item())
